"""Density-balanced z-slab LCP: the production non-penetration pipeline
(BASELINE config #2's physics, the BBPGD solve) over count-allocated slabs.

Port of mundy_tpu/parallel/balanced_lcp.py over the ranks of a Group (one
process per rank), on balanced_slab's ownership design:

- the ownership map is d + 1 z-boundaries recomputed from the measured
  z-histogram at every skin rebuild (`balanced_bounds`); the box is periodic
  and the slabs wrap in z (ranks 0 and d - 1 are ring neighbours); ghosts
  are the one-hop halo within cutoff + buffer/2 of the slab's z-range by
  minimum-image distance;
- between rebuilds each rank steps locally: a per-own-row (n_cap, K)
  neighbor matrix over the own and ghost buffer, separations and normals
  from the current positions each step, and a distributed BBPGD
  (math/convex.py with the group in PGDConfig: the residual a pmax, the
  inner products a psum). Each BBPGD iteration refreshes the ghost
  velocities by the same ring exchange that refreshes ghost positions;
- pairs are directed (a contact sits on both owners' rows), which doubles
  both inner products of the BB step and leaves the step and the fixed
  point unchanged;
- gamma is warm-started across the steps of a skin period (the pair layout
  is frozen between rebuilds) and reset at a rebuild.

The Brownian drift enters the LCP's constant term, drawn per own body by
`brownian_velocity_keyed` on the run's key words and the global step, so
the noise is the single-device app's whatever the decomposition.
"""

from __future__ import annotations

import math as _math
from typing import Optional

import torch

from mundy_tpu_torch.dynamics.brownian import brownian_velocity_keyed
from mundy_tpu_torch.geom.periodicity import periodic
from mundy_tpu_torch.math.convex import PGDConfig, solve_lcp
from mundy_tpu_torch.neighbor.cell_list import build_cell_list, make_cell_grid, neighbor_matrix
from mundy_tpu_torch.parallel.balanced_slab import (
    OVF_GHOST,
    OVF_HOP,
    OVF_OWN,
    OVF_SEARCH,
    BalancedEngine,
    balanced_bounds,
    capacities,
    gather_by_gid,
    ghost_sources,
    ovf_bit,
    pack_first,
    refresh_ghosts,
    ring_exchange,
    uniform_bounds,
)
from mundy_tpu_torch.parallel.comm import Group


def make_balanced_lcp_step(group: Group, n_total: int, box_size: float, radius: float = 0.5,
                           dt: float = 1e-3, viscosity: float = 1.0,
                           diffusion_coeff: float = 0.0, constraint_buffer: float = 0.2,
                           max_allowable_overlap: float = 1e-5,
                           max_col_iterations: int = 1000, own_slack: float = 1.5,
                           ghost_slack: float = 3.0, max_neighbors: int = 24,
                           cell_capacity: int = 24, balance: str = "balanced",
                           dtype=torch.float32) -> BalancedEngine:
    """The LCP spheres engine on this rank of `group` (its device).
    init(key_words, pos=None, step0=0) -> this rank's state (pos: the full
    (N, 3) positions, every rank the same; None draws them uniformly in the
    box from a torch.Generator seeded with the key's second word);
    step_block(state, n) runs n steps; gather(state) -> (N, 3) positions on
    every rank. The state carries `lcp_iters` (the last solve's iterations)
    and `iters` (each step's, in order)."""
    if balance not in ("balanced", "uniform"):
        raise ValueError(f"unknown balance {balance!r}")
    d, r, dev = group.size, group.rank, group.device
    n_cap, g_cap = capacities(n_total, d, own_slack, ghost_slack)
    L = float(box_size)
    cutoff = 2.0 * radius + constraint_buffer
    margin = cutoff + 0.5 * constraint_buffer
    m_tot = n_cap + g_cap
    K = max_neighbors
    inv_drag = 1.0 / (6.0 * _math.pi * viscosity * radius)
    two_r = 2.0 * radius
    dt_t = torch.tensor(dt, dtype=dtype, device=dev)
    grid = make_cell_grid([0, 0, 0], [L, L, L], cutoff, (True,) * 3, dtype=dtype, device=dev)
    metric = periodic([L, L, L], dtype=dtype, device=dev)
    cfg = PGDConfig(max_iters=max_col_iterations, tol=max_allowable_overlap,
                    bb_rule="alternating", residual="projected_gradient", group=group)

    def _zdist(z, lo, hi):
        """Minimum-image distance from z to the slab range [lo, hi) (0 inside)."""
        below = torch.minimum(torch.abs(lo - z), torch.abs(lo - z + L))
        above = torch.minimum(torch.abs(z - hi), torch.abs(z - hi + L))
        inside = (z >= lo) & (z < hi)
        return torch.where(inside, 0.0, torch.minimum(below, above))

    def _repack(pos_all):
        """Ownership and the ghost halo of this rank from the full positions:
        (own_idx, own_valid, ghost_idx, ghost_valid, ovf bits)."""
        zs = pos_all[:, 2]
        if balance == "balanced":
            bounds = balanced_bounds(zs, torch.ones_like(zs, dtype=torch.bool), d, 0.0, L)
        else:
            bounds = uniform_bounds(d, 0.0, L, dtype, dev)
        b_lo, b_hi = bounds[r], bounds[r + 1]
        own = (zs >= b_lo) & (zs < b_hi)
        own_idx, n_own = pack_first(own, n_cap, n_total)
        gh = ~own & (_zdist(zs, b_lo, b_hi) < margin)
        ghost_idx, n_gh = pack_first(gh, g_cap, n_total)
        ghost_valid = ghost_idx < n_total
        # the one-hop contract: every ghost is owned by a ring neighbour
        p, nx = (r - 1) % d, (r + 1) % d
        gz = zs[torch.clamp(ghost_idx, max=n_total - 1)]
        in_prev = (gz >= bounds[p]) & (gz < bounds[p + 1])
        in_next = (gz >= bounds[nx]) & (gz < bounds[nx + 1])
        bits = (ovf_bit(n_own > n_cap, OVF_OWN) | ovf_bit(n_gh > g_cap, OVF_GHOST)
                | ovf_bit(~(~ghost_valid | in_prev | in_next).all(), OVF_HOP))
        return own_idx, own_idx < n_total, ghost_idx, ghost_valid, bits

    def _min_image(sep):
        return sep - L * torch.round(sep * (1.0 / L))

    def _layout(pos_all, state):
        """The repacked buffers and a fresh pair layout (init and rebuild)."""
        own_idx, own_valid, ghost_idx, ghost_valid, bits = _repack(pos_all)
        safe = torch.clamp(own_idx, max=n_total - 1)
        new_pos = torch.where(own_valid[:, None], pos_all[safe], 0.0)
        idx_prev, idx_next = ring_exchange(group, own_idx)
        gf_prev, gslot, found = ghost_sources(idx_prev, idx_next, ghost_idx, n_total, n_cap)
        # a ghost missing from its owner's buffer: that buffer overflowed (a
        # ghost two hops away also fails the z test of _repack)
        bits = bits | ovf_bit(~(~ghost_valid | found).all(), OVF_OWN)
        gpos = torch.where(ghost_valid[:, None],
                           pos_all[torch.clamp(ghost_idx, max=n_total - 1)], 0.0)
        pos_m = torch.cat([new_pos, gpos])
        valid_m = torch.cat([own_valid, ghost_valid])
        clist = build_cell_list(pos_m, grid, cell_capacity, valid=valid_m)
        nmat = neighbor_matrix(pos_m, clist, 0.5 * cutoff, metric=metric, max_neighbors=K,
                               chunk=min(4096, m_tot))
        idxm = nmat.idx[:n_cap].to(torch.int64)
        maskm = nmat.mask[:n_cap] & own_valid[:, None] & valid_m[torch.clamp(idxm, max=m_tot - 1)]
        bits = state["ovf_bits"] | bits | ovf_bit(clist.overflow | nmat.overflow, OVF_SEARCH)
        return {**state, "pos": new_pos, "valid": own_valid, "gid": own_idx, "gpos": gpos,
                "gf_prev": gf_prev, "gslot": gslot, "gvalid": ghost_valid, "ref_pos": new_pos,
                "nmat_idx": idxm, "nmat_mask": maskm,
                "gamma": torch.zeros((n_cap * K,), dtype=dtype, device=dev),
                "ovf_bits": bits, "overflow": bits > 0}

    def inner_step(state):
        pos_o, valid_o, gid_o = state["pos"], state["valid"], state["gid"]
        gf_prev, gslot, maskm = state["gf_prev"], state["gslot"], state["nmat_mask"]
        gpos = refresh_ghosts(group, pos_o, gf_prev, gslot)
        pos_m = torch.cat([pos_o, gpos])
        idx = torch.clamp(state["nmat_idx"], max=m_tot - 1)
        # separations and normals from the current positions
        sep = _min_image(pos_m[idx] - pos_o[:, None, :])
        dist = torch.sqrt(torch.clamp((sep * sep).sum(-1), min=1e-24))
        normals = sep / dist[..., None]
        q = dist - two_r
        u_b = None
        if diffusion_coeff > 0:
            u_b = brownian_velocity_keyed(state["key"], state["step"],
                                          torch.where(valid_o, gid_o, 0), diffusion_coeff,
                                          dt, dtype=dtype)
            u_b = torch.where(valid_o[:, None], u_b, 0.0)
            ub_m = torch.cat([u_b, refresh_ghosts(group, u_b, gf_prev, gslot)])
            dub = u_b[:, None, :] - ub_m[idx]
            q = q - dt_t * (normals * dub).sum(-1)

        def forces_of(g):
            gn = torch.where(maskm, g.reshape(n_cap, K), 0.0)
            return (-gn[..., None] * normals).sum(1)

        def apply_A(g):
            u = torch.where(valid_o[:, None], inv_drag * forces_of(g), 0.0)
            u_m = torch.cat([u, refresh_ghosts(group, u, gf_prev, gslot)])
            du = u[:, None, :] - u_m[idx]
            sdot = -(normals * du).sum(-1)
            return (dt_t * sdot).reshape(-1)

        res = solve_lcp(apply_A, q.reshape(-1), x0=state["gamma"], config=cfg,
                        mask=maskm.reshape(-1))
        vel = inv_drag * forces_of(res.x)
        if u_b is not None:
            vel = vel + u_b
        new_pos = pos_o + dt_t * vel
        new_pos = new_pos - L * torch.floor(new_pos * (1.0 / L))
        new_pos = torch.where(valid_o[:, None], new_pos, pos_o)
        return {**state, "pos": new_pos, "gpos": gpos, "gamma": res.x,
                "lcp_iters": res.num_iters, "iters": state["iters"] + [res.num_iters],
                "step": state["step"] + 1}

    def moved(state) -> bool:
        disp = _min_image(state["pos"] - state["ref_pos"])
        d2 = torch.where(state["valid"], (disp * disp).sum(-1), 0.0)
        return bool(group.pmax(d2.max().reshape(1))[0] > (0.5 * constraint_buffer) ** 2)

    def rebuild(state):
        pos_all = gather_by_gid(group, state["pos"], state["gid"], n_total)
        state = _layout(pos_all, state)
        return {**state, "rebuilds": state["rebuilds"] + 1}

    def init(key_words, pos: Optional[torch.Tensor] = None, step0: int = 0) -> dict:
        """This rank's state: the full positions (every rank the same), the
        run's two key words and the global step, so the noise continues
        the single-device stream."""
        if pos is None:
            gen = torch.Generator(device=dev).manual_seed(int(key_words[1]))
            pos = torch.rand((n_total, 3), generator=gen, dtype=dtype, device=dev) * L
        pos_all = torch.as_tensor(pos, dtype=dtype, device=dev)
        state = {"key": tuple(int(k) for k in key_words), "step": int(step0),
                 "lcp_iters": 0, "iters": [], "rebuilds": 0,
                 "ovf_bits": torch.zeros((), dtype=torch.int32, device=dev)}
        return _layout(pos_all, state)

    def step_block(state, n_steps: int) -> dict:
        """n_steps steps, each preceded by a rebalance and rebuild when the
        (global) skin trigger fired; `iters` lists this block's solves."""
        state = {**state, "iters": []}
        for _ in range(n_steps):
            if moved(state):
                state = rebuild(state)
            state = inner_step(state)
        return state

    def gather(state) -> torch.Tensor:
        """(N, 3) positions in global-id order, every rank the same."""
        gid = torch.where(state["valid"], state["gid"], n_total)
        return gather_by_gid(group, state["pos"], gid, n_total)

    return BalancedEngine(init, step_block, gather, n_cap, g_cap)
