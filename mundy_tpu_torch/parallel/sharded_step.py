"""Sharded spheres steps over the ranks of a Group.

Port of mundy_tpu/parallel/sharded_step.py, one process per rank. Both
engines run the Hertzian spheres step (cell-list broad phase, Hertz
contact forces, Brownian drift, Euler) on each rank's own particles:

- v1, `make_sharded_spheres_step`: rank r holds the r-th of d equal
  contiguous blocks of the (N, 3) positions. Each step all_gathers the
  positions (the halo: the full set plays the reference's neighbor aura),
  builds the cell list on every rank (replicated compute in place of a
  second collective) and steps the rank's block. The noise stream is keyed
  by the rank (fold_in of the step, then of the rank), so it depends on d,
  as in the reference.
- v2, `make_slab_spheres_step`: x-slab decomposition (parallel/slab.py):
  each rank exchanges only its boundary particles with its ring neighbours
  and migrates leavers after the update. The noise is keyed by global id
  (fold_in of the step, then of the gid, one vectorised hash), so a
  trajectory does not depend on which rank owns a particle.

The contact sum is plain PyTorch, as the reference's is plain XLA: no
kernel runs here. Neighbor rows come from cell_list.neighbor_matrix_query
with a per-query radius (an inactive slot's is negative, so it finds
nothing) and self excluded by index into the gathered set.
"""

from __future__ import annotations

import math as _math
from typing import Optional

import numpy as np
import torch

from mundy_tpu_torch.dynamics.brownian import fold_in, normal, normal_per_key
from mundy_tpu_torch.dynamics.integrators import euler_step
from mundy_tpu_torch.geom.periodicity import periodic
from mundy_tpu_torch.neighbor.cell_list import (
    CellList,
    NeighborMatrix,
    build_cell_list,
    make_cell_grid,
    neighbor_matrix_query,
)
from mundy_tpu_torch.parallel.comm import Group
from mundy_tpu_torch.parallel.slab import ShardState, halo_exchange, migrate


def _local_neighbor_rows(local_pos: torch.Tensor, local_ids: torch.Tensor,
                         full_pos: torch.Tensor, clist: CellList, search_radius, metric,
                         max_neighbors: int, chunk: int = 16384) -> NeighborMatrix:
    """Neighbor rows of the local particles against the full set: pairs
    within twice `search_radius` (a scalar, or one radius per query, where a
    query with a negative radius finds nothing), self excluded by
    `local_ids`, each query's index into `full_pos`."""
    q = local_pos.shape[0]
    radius = torch.broadcast_to(torch.as_tensor(search_radius, dtype=full_pos.dtype,
                                                device=full_pos.device), (q,))
    return neighbor_matrix_query(full_pos, clist, local_pos, local_ids, None, metric=metric,
                                 max_neighbors=max_neighbors, chunk=max(1, min(chunk, q)),
                                 query_radius=radius)


def _hertz_mag(delta: torch.Tensor, e_eff: float, radius: float) -> torch.Tensor:
    return (4.0 / 3.0) * e_eff * _math.sqrt(radius / 2.0) * delta ** 1.5


def _pos_or_draw(key_words, pos, n_total: int, box_size: float, dtype, dev) -> torch.Tensor:
    """The given (N, 3) positions, or N drawn uniformly in the box from a
    torch.Generator seeded with the key's second word."""
    if pos is None:
        gen = torch.Generator(device=dev).manual_seed(int(key_words[1]))
        return torch.rand((n_total, 3), generator=gen, dtype=dtype, device=dev) * box_size
    return torch.as_tensor(pos, dtype=dtype, device=dev)


def make_sharded_spheres_step(group: Group, n_total: int, box_size: float, radius: float,
                              youngs: float = 100.0, poisson: float = 0.3,
                              viscosity: float = 1.0, diffusion: float = 0.1,
                              dt: float = 1e-4, skin: float = 0.5, max_neighbors: int = 32,
                              cell_capacity: int = 32, dtype=torch.float32):
    """v1 on this rank of `group` (its device). Returns (step_fn, init_fn):

    step_fn(pos_local, key_words, step) -> (pos_local, max_overlap): one
    full step of this rank's (N / d, 3) block; max_overlap is the pmax over
    ranks of the deepest contact. init_fn(key_words, pos=None) -> this
    rank's block of the given (N, 3) positions, or of N drawn uniformly in
    the box from a torch.Generator seeded with the key's second word."""
    d, me, dev = group.size, group.rank, group.device
    if n_total % d != 0:
        raise ValueError("n_total must divide the number of ranks")
    n_local = n_total // d
    metric = periodic([box_size] * 3, dtype=dtype, device=dev)
    search_radius = radius + 0.5 * skin
    grid = make_cell_grid([0, 0, 0], [box_size] * 3, 2 * search_radius, (True,) * 3, dtype,
                          device=dev)
    inv_drag = 1.0 / (6.0 * _math.pi * viscosity * radius)
    e_eff = youngs / (2.0 * (1.0 - poisson ** 2))
    local_ids = me * n_local + torch.arange(n_local, dtype=torch.int32, device=dev)
    dt_t = torch.tensor(dt, dtype=dtype, device=dev)
    noise = torch.sqrt(torch.tensor(2.0 * diffusion / dt, dtype=dtype, device=dev))

    def step_fn(pos_local: torch.Tensor, key_words, step: int):
        full_pos = torch.cat(group.all_gather(pos_local))  # the halo: every position
        clist = build_cell_list(full_pos, grid, cell_capacity)
        nmat = _local_neighbor_rows(pos_local, local_ids, full_pos, clist, search_radius,
                                    metric, max_neighbors)
        idxc = torch.clamp(nmat.idx, max=n_total - 1).to(torch.int64)
        sep = metric.sep(pos_local[:, None, :], full_pos[idxc])
        dist = torch.sqrt(torch.clamp((sep * sep).sum(-1), min=1e-24))
        nhat = sep / dist[..., None]
        delta = torch.where(nmat.mask, torch.clamp(2 * radius - dist, min=0.0), 0.0)
        force = -(_hertz_mag(delta, e_eff, radius)[..., None] * nhat).sum(1)
        vel = inv_drag * force
        if diffusion > 0:
            kb = fold_in(fold_in(key_words, step), me)
            vel = vel + noise * normal(kb, n_local, dtype, dev)
        new_pos = euler_step(pos_local, vel, dt_t, metric=metric)
        max_overlap = group.pmax(delta.max().reshape(1))[0]
        return new_pos, max_overlap

    def init_fn(key_words, pos: Optional[torch.Tensor] = None) -> torch.Tensor:
        pos = _pos_or_draw(key_words, pos, n_total, box_size, dtype, dev)
        return pos[me * n_local:(me + 1) * n_local].contiguous()

    return step_fn, init_fn


def make_slab_spheres_step(group: Group, n_total: int, box_size: float, radius: float,
                           youngs: float = 100.0, poisson: float = 0.3,
                           viscosity: float = 1.0, diffusion: float = 0.1, dt: float = 1e-4,
                           skin: float = 0.5, max_neighbors: int = 32,
                           cell_capacity: int = 32, slot_slack: float = 1.6,
                           halo_fraction: float = 1.0, dtype=torch.float32):
    """v2 on this rank of `group` (its device). Returns (step_fn, init_fn):

    step_fn(pos, active, gid, flags, key_words, step) -> (pos, active, gid,
    flags, max_overlap) on this rank's `capacity` slots: halo exchange,
    cell-list broad phase over own and halo particles, Hertz, the gid-keyed
    Brownian drift, Euler, migration. `flags` is the sticky overflow
    bitmask, the pmax over ranks of 1 halo, 2 cell list, 4 neighbor rows,
    8 migration. init_fn(key_words, pos=None) -> this rank's (pos, active,
    gid, flags): the particles of its x-slab (the given (N, 3) positions or
    N drawn as v1 draws them), staged through float32 as the reference
    stages them, in gid order."""
    d, me, dev = group.size, group.rank, group.device
    capacity = int(np.ceil(n_total / d * slot_slack))
    # the halo must hold every particle within the halo width of a face;
    # with thin slabs that approaches the whole slab
    halo_capacity = max(64, int(capacity * halo_fraction))
    metric = periodic([box_size] * 3, dtype=dtype, device=dev)
    search_radius = radius + 0.5 * skin
    grid = make_cell_grid([0, 0, 0], [box_size] * 3, 2 * search_radius, (True,) * 3, dtype,
                          device=dev)
    inv_drag = 1.0 / (6.0 * _math.pi * viscosity * radius)
    e_eff = youngs / (2.0 * (1.0 - poisson ** 2))
    slots = torch.arange(capacity, dtype=torch.int32, device=dev)
    dt_t = torch.tensor(dt, dtype=dtype, device=dev)
    noise = torch.sqrt(torch.tensor(2.0 * diffusion / dt, dtype=dtype, device=dev))

    def step_fn(pos, active, gid, flags, key_words, step: int):
        halo_pos, halo_mask, h_ovf = halo_exchange(pos, active, group, box_size,
                                                   2 * search_radius, halo_capacity)
        all_pos = torch.cat([pos, halo_pos])
        all_valid = torch.cat([active, halo_mask])
        clist = build_cell_list(all_pos, grid, cell_capacity, valid=all_valid)
        # an inactive slot queries with a negative radius and collects nothing
        q_radius = torch.where(active, search_radius, -1.0).to(dtype)
        nmat = _local_neighbor_rows(pos, slots, all_pos, clist, q_radius, metric,
                                    max_neighbors)

        idxc = torch.clamp(nmat.idx, max=all_pos.shape[0] - 1).to(torch.int64)
        sep = metric.sep(pos[:, None, :], all_pos[idxc])
        r2 = torch.clamp((sep * sep).sum(-1), min=1e-24)
        rinv = torch.rsqrt(r2)
        delta = torch.where(nmat.mask, torch.clamp(2 * radius - r2 * rinv, min=0.0), 0.0)
        force = -((_hertz_mag(delta, e_eff, radius) * rinv)[..., None] * sep).sum(1)
        vel = inv_drag * force
        if diffusion > 0:
            # per-global-id streams: invariant to migration and to d
            keys = fold_in(fold_in(key_words, step), gid)
            vel = vel + noise * normal_per_key(keys, dtype)
        new_pos = metric.wrap(pos + dt_t * vel)
        new_pos = torch.where(active[:, None], new_pos, pos)

        post = migrate(ShardState(new_pos, active, gid,
                                  torch.zeros((), dtype=torch.bool, device=dev)),
                       group, box_size)
        bits = (h_ovf.to(torch.int32) | (clist.overflow.to(torch.int32) << 1)
                | (nmat.overflow.to(torch.int32) << 2) | (post.overflow.to(torch.int32) << 3))
        bits = group.pmax(bits.reshape(1))[0] | flags
        max_overlap = group.pmax(delta.max().reshape(1))[0]
        return post.pos, post.active, post.gid, bits, max_overlap

    def init_fn(key_words, pos: Optional[torch.Tensor] = None):
        pos = _pos_or_draw(key_words, pos, n_total, box_size, dtype, dev)
        p = pos.detach().cpu().numpy()
        width = box_size / d
        owner = np.minimum((p[:, 0] / width).astype(int), d - 1)
        mine = np.where(owner == me)[0]
        # every rank tests every slab, so all raise together
        if max(np.bincount(owner, minlength=d)) > capacity:
            raise ValueError("slot capacity exceeded at init; raise slot_slack")
        pos_slots = np.zeros((capacity, 3), np.float32)  # the reference's float32 staging
        act_slots = np.zeros((capacity,), bool)
        gid_slots = np.zeros((capacity,), np.int32)
        pos_slots[:len(mine)] = p[mine]
        act_slots[:len(mine)] = True
        gid_slots[:len(mine)] = mine
        return (torch.as_tensor(pos_slots, device=dev).to(dtype),
                torch.as_tensor(act_slots, device=dev),
                torch.as_tensor(gid_slots, device=dev),
                torch.zeros((), dtype=torch.int32, device=dev))

    return step_fn, init_fn
