"""Sharded granular DEM: frictional Hertzian contact over density-balanced
z-slabs with migrating per-contact tangential history.

Port of mundy_tpu/parallel/granular_shard.py over the ranks of a Group (one
process per rank), on balanced_slab's ownership design:

- the ownership map is d + 1 z-boundaries over the tall settling box
  [0, 2L], recomputed from the measured z-histogram at every rebuild
  (`balanced_bounds`), so a settled bed keeps ~N/d bodies per rank;
- free box (walls, no periodicity): ghosts are the bodies within
  cutoff + skin/2 of the slab's z-range, with no wrap; the one-hop ring
  contract is checked and flagged as an overflow;
- each step refreshes the ghost positions and velocities (one ring exchange
  of the stacked (n_cap, 6) own buffer: the dashpots need the ghost
  velocities) and evaluates the forces row-wise on this rank's own
  (n_cap, K) neighbor rows. Each contact sits on both owners' rows with
  mirrored normals, so its two history copies evolve as exact negatives and
  action-reaction holds with no force exchange between ranks;
- the tangential history lives in own-row slots (n_cap, K, 3) and migrates:
  at every rebuild the old rows are gathered into gid-keyed key and value
  tables (key = neighbour gid + 1) and each new row takes the entry of the
  same (gid_i, gid_j) pair, the distributed form of GranularSim's
  `remap_gamma`. A row's neighbour gids are unique, so each new slot
  matches at most one old slot, and a gather of that slot gives what the
  reference's 0/1 einsum gives.

The block loop is GranularSim's cadence: a rebuild at the start of every
block and after every step whose (global) skin trigger fired.
"""

from __future__ import annotations

import math as _math

import torch

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
from mundy_tpu_torch.parallel.slab_rows import run_block

_EPS = 1e-12


def make_granular_slab_step(group: Group, n_total: int, box_size: float, radius: float = 0.5,
                            density: float = 1.0, gravity: float = 10.0,
                            friction_coeff: float = 0.5, normal_spring: float = 5e4,
                            normal_damping: float = 20.0, tang_spring: float = 2e4,
                            tang_damping: float = 10.0, wall_spring: float = 5e4,
                            dt: float = 1e-4, skin: float = 0.3, own_slack: float = 1.5,
                            ghost_slack: float = 3.0, max_neighbors: int = 16,
                            cell_capacity: int = 16, balance: str = "balanced",
                            dtype=torch.float32) -> BalancedEngine:
    """The granular engine on this rank of `group` (its device).
    init(pos, vel=None) takes the full (N, 3) arrays (every rank the same);
    step_block(state, n) runs n steps; gather(state) -> ((N, 3) positions,
    (N, 3) velocities) on every rank. The state counts `step` and
    `rebuild_count`."""
    if balance not in ("balanced", "uniform"):
        raise ValueError(f"unknown balance {balance!r}")
    d, r, dev = group.size, group.rank, group.device
    n_cap, g_cap = capacities(n_total, d, own_slack, ghost_slack)
    L = float(box_size)
    H = 2.0 * L  # the tall settling box: z in [0, H]
    search_radius = radius + 0.5 * skin
    cutoff = 2.0 * search_radius
    margin = cutoff + 0.5 * skin
    m_tot = n_cap + g_cap
    K = max_neighbors
    mass = (4.0 / 3.0) * _math.pi * density * radius ** 3
    m_eff = 0.5 * mass  # equal radii: m_i m_j / (m_i + m_j)
    r_eff = 0.5 * radius
    two_r = 2.0 * radius
    grid = make_cell_grid([0, 0, 0], [L, L, H], cutoff, (False,) * 3, dtype=dtype, device=dev)

    def _zdist(z, lo, hi):
        """Distance from z to the slab range [lo, hi), no wrap (free box)."""
        inside = (z >= lo) & (z < hi)
        return torch.where(inside, 0.0, torch.minimum(torch.abs(lo - z), torch.abs(z - hi)))

    def _repack(pos_all):
        zs = pos_all[:, 2]
        if balance == "balanced":
            bounds = balanced_bounds(zs, torch.ones_like(zs, dtype=torch.bool), d, 0.0, H)
        else:
            bounds = uniform_bounds(d, 0.0, H, dtype, dev)
        b_lo, b_hi = bounds[r], bounds[r + 1]
        # the top slab owns z == H exactly (the clip keeps strays in range)
        zc = torch.clamp(zs, 0.0, H - 1e-6)
        own = (zc >= b_lo) & (zc < b_hi)
        own_idx, n_own = pack_first(own, n_cap, n_total)
        gh = ~own & (_zdist(zc, b_lo, b_hi) < margin)
        ghost_idx, n_gh = pack_first(gh, g_cap, n_total)
        ghost_valid = ghost_idx < n_total
        # the one-hop contract: every ghost lives in a ring neighbour's slab
        p, nx = (r - 1) % d, (r + 1) % d
        gz = torch.clamp(zs[torch.clamp(ghost_idx, max=n_total - 1)], 0.0, H - 1e-6)
        in_prev = (gz >= bounds[p]) & (gz < bounds[p + 1])
        in_next = (gz >= bounds[nx]) & (gz < bounds[nx + 1])
        bits = (ovf_bit(n_own > n_cap, OVF_OWN) | ovf_bit(n_gh > g_cap, OVF_GHOST)
                | ovf_bit(~(~ghost_valid | in_prev | in_next).all(), OVF_HOP))
        return own_idx, own_idx < n_total, ghost_idx, ghost_valid, bits

    def _wall_gravity(pos_o, valid_o):
        """Hertzian-spring walls and gravity, GranularSim's six wall terms in
        its order."""
        def spring(over):
            return wall_spring * torch.clamp(over, min=0.0) ** 1.5

        f = torch.zeros_like(pos_o)
        f[:, 2] += spring(radius - pos_o[:, 2])
        f[:, 2] += -spring(pos_o[:, 2] - (H - radius))
        for ax in (0, 1):
            f[:, ax] += spring(radius - pos_o[:, ax])
            f[:, ax] += -spring(pos_o[:, ax] - (L - radius))
        f[:, 2] += -mass * gravity
        return torch.where(valid_o[:, None], f, 0.0)

    def _search(pos_o, own_valid, gid_o, gpos, ghost_idx, ghost_valid):
        """The own rows of the neighbor matrix over the own and ghost
        buffer, and each slot's neighbour gid (n_total where empty)."""
        pos_m = torch.cat([pos_o, gpos])
        valid_m = torch.cat([own_valid, ghost_valid])
        clist = build_cell_list(pos_m, grid, cell_capacity, valid=valid_m)
        nmat = neighbor_matrix(pos_m, clist, search_radius, max_neighbors=K,
                               chunk=min(4096, m_tot))
        idxm = nmat.idx[:n_cap].to(torch.int64)
        safe = torch.clamp(idxm, max=m_tot - 1)
        maskm = nmat.mask[:n_cap] & own_valid[:, None] & valid_m[safe]
        gid_m = torch.cat([torch.where(own_valid, gid_o, n_total),
                           torch.where(ghost_valid, torch.clamp(ghost_idx, max=n_total),
                                       n_total)])
        ngid = torch.where(maskm, gid_m[safe], n_total)
        return idxm, maskm, ngid, clist.overflow | nmat.overflow

    def _remap_history(gid_o, own_valid, old_ngid, old_tang, new_gid, new_valid, new_ngid):
        """The (n_cap, K, 3) tangential history carried across a rebuild by
        (gid_i, gid_j) pair identity through gid-keyed key and value tables
        gathered from every rank."""
        row = torch.where(own_valid, gid_o, n_total)
        keys = torch.where(old_ngid < n_total, old_ngid + 1, 0)
        key_tab = gather_by_gid(group, keys, row, n_total + 1)
        val_tab = gather_by_gid(group, old_tang, row, n_total + 1)
        gi = torch.where(new_valid, new_gid, n_total)
        old_k, old_v = key_tab[gi], val_tab[gi]  # (n_cap, K), (n_cap, K, 3)
        want = torch.where(new_ngid < n_total, new_ngid + 1, -1)
        hit = old_k[:, None, :] == want[:, :, None]  # (n_cap, K new, K old)
        slot = torch.argmax(hit.to(torch.int32), dim=2)
        got = torch.gather(old_v, 1, slot[..., None].expand(-1, -1, 3))
        return torch.where(hit.any(dim=2)[..., None], got, 0.0)

    def _layout(pos_all, vel_all, state):
        """Repacked buffers and fresh neighbor rows (init and rebuild); the
        history is left to the caller."""
        own_idx, own_valid, ghost_idx, ghost_valid, bits = _repack(pos_all)
        safe = torch.clamp(own_idx, max=n_total - 1)
        new_pos = torch.where(own_valid[:, None], pos_all[safe], 0.0)
        new_vel = torch.where(own_valid[:, None], vel_all[safe], 0.0)
        idx_prev, idx_next = ring_exchange(group, own_idx)
        gf_prev, gslot, found = ghost_sources(idx_prev, idx_next, ghost_idx, n_total, n_cap)
        # a ghost missing from its owner's buffer: that buffer overflowed (a
        # ghost two hops away also fails the z test of _repack)
        bits = bits | ovf_bit(~(~ghost_valid | found).all(), OVF_OWN)
        gpos = torch.where(ghost_valid[:, None],
                           pos_all[torch.clamp(ghost_idx, max=n_total - 1)], 0.0)
        idxm, maskm, ngid, sovf = _search(new_pos, own_valid, own_idx, gpos, ghost_idx,
                                          ghost_valid)
        bits = state["ovf_bits"] | bits | ovf_bit(sovf, OVF_SEARCH)
        return {**state, "pos": new_pos, "vel": new_vel, "valid": own_valid, "gid": own_idx,
                "gpos": gpos, "gf_prev": gf_prev, "gslot": gslot, "gvalid": ghost_valid,
                "ref_pos": new_pos, "nmat_idx": idxm, "nmat_mask": maskm, "ngid": ngid,
                "ovf_bits": bits, "overflow": bits > 0}

    def inner_step(state):
        pos_o, vel_o, valid_o = state["pos"], state["vel"], state["valid"]
        g = refresh_ghosts(group, torch.cat([pos_o, vel_o], dim=1), state["gf_prev"],
                           state["gslot"])
        gpos, gvel = g[:, :3], g[:, 3:]
        pos_m = torch.cat([pos_o, gpos])
        vel_m = torch.cat([vel_o, gvel])
        idx = torch.clamp(state["nmat_idx"], max=m_tot - 1)
        maskm = state["nmat_mask"]
        # frictional Hertz, row-wise (forces/friction.py's formulas): nhat
        # points from own to neighbour, the force lands on the own body only,
        # and the mirrored row on the neighbour's owner supplies -f
        sepv = pos_m[idx] - pos_o[:, None, :]
        r2 = torch.clamp((sepv * sepv).sum(-1), min=_EPS)
        rinv = torch.rsqrt(r2)
        dist = r2 * rinv
        nhat = sepv * rinv[..., None]
        signed_sep = dist - two_r
        in_contact = maskm & (signed_sep < 0.0)
        rel = vel_m[idx] - vel_o[:, None, :]
        rel_n = (rel * nhat).sum(-1)[..., None] * nhat
        rel_t = rel - rel_n
        xi = state["tang"] + rel_t * dt
        xi = xi - (xi * nhat).sum(-1)[..., None] * nhat
        xi = torch.where(in_contact[..., None], xi, 0.0)
        hertz_poly = torch.sqrt(torch.clamp(-r_eff * signed_sep, min=0.0))
        f_n = hertz_poly[..., None] * (normal_spring * signed_sep[..., None] * nhat
                                       + (m_eff * normal_damping) * rel_n)
        f_t = hertz_poly[..., None] * (tang_spring * xi + (m_eff * tang_damping) * rel_t)
        fn_mag = torch.sqrt((f_n * f_n).sum(-1))
        ft_mag = torch.sqrt((f_t * f_t).sum(-1))
        cap = friction_coeff * fn_mag
        over = ft_mag > cap
        scale = cap / torch.clamp(ft_mag, min=_EPS)
        damp_term = (m_eff * tang_damping) * rel_t / max(tang_spring, _EPS)
        xi_rescaled = scale[..., None] * (xi + damp_term) - damp_term
        xi = torch.where(over[..., None], xi_rescaled, xi)
        f_t = torch.where(over[..., None], f_t * scale[..., None], f_t)
        f_pair = torch.where(in_contact[..., None], f_n + f_t, 0.0)
        force = f_pair.sum(1) + _wall_gravity(pos_o, valid_o)
        vel_new = vel_o + (dt / mass) * force
        pos_new = pos_o + dt * vel_new
        vel_new = torch.where(valid_o[:, None], vel_new, 0.0)
        pos_new = torch.where(valid_o[:, None], pos_new, pos_o)
        return {**state, "pos": pos_new, "vel": vel_new, "gpos": gpos, "tang": xi,
                "step": state["step"] + 1}

    def moved(state) -> bool:
        disp = state["pos"] - state["ref_pos"]
        d2 = torch.where(state["valid"], (disp * disp).sum(-1), 0.0)
        return bool(group.pmax(d2.max().reshape(1))[0] > (0.5 * skin) ** 2)

    def rebuild(state):
        both = gather_by_gid(group, torch.cat([state["pos"], state["vel"]], dim=1),
                             state["gid"], n_total)
        new = _layout(both[:, :3], both[:, 3:], state)
        tang = _remap_history(state["gid"], state["valid"], state["ngid"], state["tang"],
                              new["gid"], new["valid"], new["ngid"])
        return {**new, "tang": tang, "rebuild_count": state["rebuild_count"] + 1}

    def init(pos, vel=None) -> dict:
        pos_all = torch.as_tensor(pos, dtype=dtype, device=dev)
        vel_all = (torch.zeros_like(pos_all) if vel is None
                   else torch.as_tensor(vel, dtype=dtype, device=dev))
        state = {"tang": torch.zeros((n_cap, K, 3), dtype=dtype, device=dev), "step": 0,
                 "rebuild_count": 0,
                 "ovf_bits": torch.zeros((), dtype=torch.int32, device=dev)}
        return _layout(pos_all, vel_all, state)

    def step_block(state, n_steps: int) -> dict:
        return run_block(state, n_steps, rebuild, inner_step, moved)

    def gather(state) -> tuple:
        """((N, 3) positions, (N, 3) velocities) in global-id order, every
        rank the same."""
        gid = torch.where(state["valid"], state["gid"], n_total)
        both = gather_by_gid(group, torch.cat([state["pos"], state["vel"]], dim=1), gid,
                             n_total)
        return both[:, :3].contiguous(), both[:, 3:].contiguous()

    return BalancedEngine(init, step_block, gather, n_cap, g_cap)
