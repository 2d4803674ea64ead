"""Entity and link tables, the World that holds them, field operations
and the part-selector algebra.

Port of mundy_tpu/state (ref: STK BulkData/MetaData, `LinkData.hpp`).
"""

from mundy_tpu_torch.state.world import (
    EntitySet,
    LinkSet,
    World,
    WorldBuilder,
    links_to_csr,
)
from mundy_tpu_torch.state.select import select
from mundy_tpu_torch.state.fieldops import (
    field_fill,
    field_copy,
    field_scale,
    field_axpy,
    field_axpby,
    field_product,
    field_dot,
    field_nrm2,
    field_asum,
    field_amax,
    field_amin,
    field_randomize,
)

__all__ = [
    "EntitySet",
    "LinkSet",
    "World",
    "WorldBuilder",
    "links_to_csr",
    "select",
    "field_fill",
    "field_copy",
    "field_scale",
    "field_axpy",
    "field_axpby",
    "field_product",
    "field_dot",
    "field_nrm2",
    "field_asum",
    "field_amax",
    "field_amin",
    "field_randomize",
]
