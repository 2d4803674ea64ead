"""Neighbor search: the dense cell list and the row-grid engine.

Port of mundy_tpu/neighbor (ref: `GenNeighborLinkers.hpp:510-741`).
"""

from mundy_tpu_torch.neighbor.cell_list import (
    CellGrid,
    CellList,
    make_cell_grid,
    build_cell_list,
    neighbor_matrix,
    neighbor_matrix_query,
    NeighborMatrix,
    build_pair_list,
    build_pair_list_ordered,
    PairList,
    need_rebuild,
)
from mundy_tpu_torch.neighbor.rows import neighbor_matrix_rows

__all__ = [
    "CellGrid",
    "CellList",
    "make_cell_grid",
    "build_cell_list",
    "neighbor_matrix",
    "neighbor_matrix_query",
    "NeighborMatrix",
    "build_pair_list",
    "build_pair_list_ordered",
    "PairList",
    "need_rebuild",
    "neighbor_matrix_rows",
]
