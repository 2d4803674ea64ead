"""Entity sets and link sets: capacity-bounded structure-of-arrays state.

Port of the EntitySet and LinkSet containers of mundy_tpu/state/world.py
(the reference's STK BulkData entities and `LinkData.hpp` links). An entity
set is a dict of capacity-sized fields, boolean part masks and an active
mask; a link set is an (capacity, arity) index table with its own active
mask and per-link fields, so link creation and destruction are mask flips
and slot writes (`LinkData.hpp:159-183`). The host-side WorldBuilder of
the reference has no caller in the port.
"""

from __future__ import annotations

import torch

from mundy_tpu_torch.core.containers import frozen_dataclass, static_field


@frozen_dataclass
class EntitySet:
    """A rank of entities: fields (cap, ...), parts as masks, occupancy."""

    fields: dict  # name -> (capacity, ...) tensor
    parts: dict  # name -> (capacity,) bool mask
    active: torch.Tensor  # (capacity,) bool
    capacity: int = static_field(default=0)


@frozen_dataclass
class LinkSet:
    """N-ary connectivity (COO): indices[c, k] = entity index in target set
    k; `targets` names the linked entity sets per slot."""

    indices: torch.Tensor  # (capacity, arity) int32
    active: torch.Tensor  # (capacity,) bool
    fields: dict  # per-link fields, name -> (capacity, ...) tensor
    targets: tuple = static_field(default=())

    @property
    def capacity(self) -> int:
        return self.indices.shape[0]

    @property
    def arity(self) -> int:
        return self.indices.shape[1]
