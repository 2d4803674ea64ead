"""World: capacity-bounded structure-of-arrays entity state.

Port of mundy_tpu/state/world.py (the reference's STK BulkData/MetaData and
Mundy's extensions: `MeshBuilder.hpp:50`, `MetaData.hpp:48`,
`BulkData.hpp:63`, `DeclareEntities.hpp:54`, `LinkData.hpp:183`,
`LinkCRSData.hpp`). An entity set is a dict of capacity-sized fields,
boolean part masks and an active mask; a link set is an (capacity, arity)
index table with its own active mask and per-link fields, so link creation
and destruction are mask flips and slot writes (`LinkData.hpp:159-183`). A
World holds named sets and links; the host-side WorldBuilder declares them,
stages their values in numpy and commits one World of tensors on a device.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from mundy_tpu_torch.core.containers import frozen_dataclass, static_field
from mundy_tpu_torch.core.errors import require

_NP_DTYPES = {torch.float32: np.float32, torch.float64: np.float64,
              torch.int32: np.int32, torch.int64: np.int64, torch.bool: np.bool_}


@frozen_dataclass
class EntitySet:
    """A rank of entities: fields (cap, ...), parts as masks, occupancy."""

    fields: dict  # name -> (capacity, ...) tensor
    parts: dict  # name -> (capacity,) bool mask
    active: torch.Tensor  # (capacity,) bool
    capacity: int = static_field(default=0)

    @property
    def num_active(self) -> torch.Tensor:
        return self.active.sum()

    def field(self, name: str) -> torch.Tensor:
        return self.fields[name]

    def set_field(self, name: str, value: torch.Tensor) -> "EntitySet":
        require(name in self.fields, f"unknown field '{name}'")
        return self.replace(fields={**self.fields, name: value})


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


@frozen_dataclass
class World:
    sets: dict  # name -> EntitySet
    links: dict  # name -> LinkSet

    def entity(self, name: str) -> EntitySet:
        return self.sets[name]

    def link(self, name: str) -> LinkSet:
        return self.links[name]

    def update_set(self, name: str, es: EntitySet) -> "World":
        return self.replace(sets={**self.sets, name: es})

    def update_link(self, name: str, ls: LinkSet) -> "World":
        return self.replace(links={**self.links, name: ls})


class WorldBuilder:
    """Host-side declaration -> committed World: declare entity sets with
    fields, parts and capacities, add entities with initial values, then
    `commit()` copies the numpy staging to `device` once (the reference's
    MeshBuilder -> MetaData -> DeclareEntitiesHelper -> commit flow). The
    device is the card unless the caller asks for "cpu"."""

    def __init__(self, dtype=torch.float32, device="cuda"):
        self.dtype = dtype
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("WorldBuilder(device='cuda') needs a CUDA device, and torch "
                               "sees none; pass device='cpu'")
        self._sets: dict[str, dict] = {}
        self._links: dict[str, dict] = {}

    def _np(self, dtype) -> type:
        return _NP_DTYPES[self.dtype if dtype is None else dtype]

    # ---- declaration --------------------------------------------------
    def declare_set(self, name: str, capacity: int) -> "WorldBuilder":
        require(name not in self._sets, f"entity set '{name}' already declared")
        self._sets[name] = {"capacity": int(capacity), "fields": {}, "parts": {},
                            "count": 0, "staged": {}}
        return self

    def declare_field(self, set_name: str, field: str, shape_tail=(), dtype=None,
                      fill=0.0) -> "WorldBuilder":
        s = self._sets[set_name]
        require(field not in s["fields"], f"field '{field}' already declared")
        s["fields"][field] = (tuple(shape_tail), dtype, fill)
        s["staged"][field] = np.full((s["capacity"],) + tuple(shape_tail), fill,
                                     dtype=self._np(dtype))
        return self

    def declare_part(self, set_name: str, part: str) -> "WorldBuilder":
        s = self._sets[set_name]
        require(part not in s["parts"], f"part '{part}' already declared")
        s["parts"][part] = np.zeros(s["capacity"], dtype=bool)
        return self

    def declare_links(self, name: str, targets: tuple, capacity: int,
                      fields: Optional[dict] = None) -> "WorldBuilder":
        """targets: the entity-set names, one per link slot; fields: name ->
        (shape_tail, dtype or None, fill)."""
        require(name not in self._links, f"link set '{name}' already declared")
        for t in targets:
            require(t in self._sets, f"link target set '{t}' not declared")
        ln = {"targets": tuple(targets), "capacity": int(capacity),
              "indices": np.zeros((capacity, len(targets)), np.int32),
              "active": np.zeros(capacity, bool), "count": 0, "fields": {}}
        for fname, (shape_tail, dt, fill) in (fields or {}).items():
            ln["fields"][fname] = np.full((capacity,) + tuple(shape_tail), fill,
                                          dtype=self._np(dt))
        self._links[name] = ln
        return self

    # ---- entities and links -------------------------------------------
    def add_entities(self, set_name: str, n: int, parts=(), **field_values) -> np.ndarray:
        """Append n entities; returns their indices. Field values broadcast."""
        s = self._sets[set_name]
        start, end = s["count"], s["count"] + n
        require(end <= s["capacity"], f"entity set '{set_name}' capacity exceeded")
        for fname, val in field_values.items():
            require(fname in s["fields"], f"unknown field '{fname}' in '{set_name}'")
            s["staged"][fname][start:end] = np.asarray(val)
        for p in parts:
            require(p in s["parts"], f"unknown part '{p}' in '{set_name}'")
            s["parts"][p][start:end] = True
        s["count"] = end
        return np.arange(start, end)

    def add_links(self, link_name: str, indices, **field_values) -> np.ndarray:
        ln = self._links[link_name]
        indices = np.asarray(indices, np.int32).reshape(-1, len(ln["targets"]))
        start, end = ln["count"], ln["count"] + indices.shape[0]
        require(end <= ln["capacity"], f"link set '{link_name}' capacity exceeded")
        ln["indices"][start:end] = indices
        ln["active"][start:end] = True
        for fname, val in field_values.items():
            ln["fields"][fname][start:end] = np.asarray(val)
        ln["count"] = end
        return np.arange(start, end)

    # ---- commit --------------------------------------------------------
    def commit(self) -> World:
        def t(a):
            return torch.as_tensor(a, device=self.device)

        sets = {}
        for name, s in self._sets.items():
            active = np.zeros(s["capacity"], bool)
            active[:s["count"]] = True
            sets[name] = EntitySet(fields={k: t(v) for k, v in s["staged"].items()},
                                   parts={k: t(v) for k, v in s["parts"].items()},
                                   active=t(active), capacity=s["capacity"])
        links = {name: LinkSet(indices=t(ln["indices"]), active=t(ln["active"]),
                               fields={k: t(v) for k, v in ln["fields"].items()},
                               targets=ln["targets"])
                 for name, ln in self._links.items()}
        return World(sets=sets, links=links)


def links_to_csr(links: LinkSet, slot: int, num_entities: int):
    """COO -> CSR mirror for per-entity traversal over link slot `slot`: one
    stable sort and a search (ref: `LinkCRSData.hpp`,
    `NgpCOOToCRSSynchronizer.hpp:70-569`). Returns (offsets (num_entities
    + 1,), link ids sorted by entity, int32); inactive links sort to the
    end, outside every entity's range."""
    src = torch.where(links.active, links.indices[:, slot].to(torch.int64), num_entities)
    order = torch.argsort(src, stable=True)
    offsets = torch.searchsorted(src[order], torch.arange(num_entities + 1,
                                                          device=src.device))
    return offsets, order.to(torch.int32)
