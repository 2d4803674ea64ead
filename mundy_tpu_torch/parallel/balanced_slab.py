"""Runtime load rebalancing: density-balanced z-slab decomposition.

Port of mundy_tpu/parallel/balanced_slab.py over the ranks of a Group (one
process per rank). Each rank owns a fixed-capacity compact buffer of bodies
(n_cap = ceil(own_slack N / d / 8) 8 slots) and a ghost buffer (g_cap, from
ghost_slack); the ownership map, d + 1 z-boundaries, is data, recomputed
from the measured z-histogram at every skin rebuild (`balanced_bounds`), so
every slab holds ~N/d bodies whatever the density:

- between rebuilds each rank steps its own bodies against its own and ghost
  bodies (those within cutoff + skin of its z-range, owned by its ring
  neighbours); ghost positions refresh every step by a ppermute of each
  neighbour's own buffer and a gather of precomputed slots (at d = 2 both
  neighbours are the same rank, and one ppermute serves both directions);
- a rebuild gathers every position (an all_gather of the own buffers and a
  scatter by global id, exact where the reference psums one nonzero per
  row), recomputes the boundaries and repacks the own and ghost buffers in
  global-id order, so trajectories do not depend on the decomposition.

Capacity contract, as the reference's: `overflow` goes sticky when a slab
holds more than n_cap bodies, when the ghost halo exceeds g_cap, or when a
ghost is not owned by a ring neighbour (a slab thinner than the ghost
margin). The port also keeps which of them fired in `ovf_bits` (OVF_SEARCH,
OVF_OWN, OVF_GHOST, OVF_HOP), so a caller can grow the capacity at fault
(driver/sharded.py).

`make_balanced_settling_step` is the reference's self-contained
demonstrator: overdamped Hertzian spheres settling under gravity in a free
box, the cell list and neighbor matrix built every step over the own and
ghost buffer. `reference_settling_step` is the same physics on one device.
The helpers below (`balanced_bounds`, `pack_first`, `ghost_sources`,
`refresh_ghosts`, `gather_by_gid`) serve the LCP and granular engines too.
"""

from __future__ import annotations

import math as _math
from typing import Callable, NamedTuple

import torch

from mundy_tpu_torch.forces.contact import effective_youngs, hertzian_pair_force
from mundy_tpu_torch.neighbor.cell_list import build_cell_list, make_cell_grid, neighbor_matrix
from mundy_tpu_torch.parallel.comm import Group, ring_perms

# which capacity an overflow came from (bits of a state's "ovf_bits")
OVF_SEARCH = 1  # a cell or a neighbor row (cell_capacity, max_neighbors)
OVF_OWN = 2  # a slab held more than n_cap bodies (own_slack)
OVF_GHOST = 4  # the ghost halo exceeded g_cap (ghost_slack)
OVF_HOP = 8  # a ghost two ring hops away: a slab thinner than the margin


class BalancedEngine(NamedTuple):
    """A density-balanced z-slab engine on one rank: init(...) -> this
    rank's state dict; step_block(state, n_steps) -> state; gather(state)
    -> the full arrays on every rank (a collective); the capacities."""

    init: Callable
    step_block: Callable
    gather: Callable
    n_cap: int
    g_cap: int


def capacities(n_total: int, d: int, own_slack: float, ghost_slack: float) -> tuple:
    """(n_cap, g_cap): the own and ghost buffer sizes, multiples of 8."""
    if d < 2:
        raise ValueError(f"the balanced z-slab engines need at least 2 ranks, got {d}")
    return (int(_math.ceil(own_slack * n_total / d / 8)) * 8,
            int(_math.ceil(ghost_slack * n_total / d / 8)) * 8)


def balanced_bounds(z: torch.Tensor, valid: torch.Tensor, d: int, lo: float, hi: float,
                    nbins: int = 256) -> torch.Tensor:
    """(d + 1,) z-boundaries splitting the valid bodies into d ~equal-count
    contiguous slabs: histogram, inclusive cumsum and linear interpolation
    inside the quantile bin. Bit-equal to the reference's on equal inputs
    (every rank passes the same z, so every rank gets the same bounds)."""
    dtype, dev = z.dtype, z.device
    width = (hi - lo) / nbins
    b = torch.clamp(((z - lo) / width).to(torch.int32), 0, nbins - 1).to(torch.int64)
    # invalid bodies go to bin nbins, which is cut off
    hist = torch.bincount(torch.where(valid, b, nbins), minlength=nbins + 1)[:nbins]
    cum = torch.cumsum(hist, dim=0)  # inclusive; cum[-1] = N
    n = cum[nbins - 1]
    targets = (torch.arange(1, d, dtype=dtype, device=dev) / d) * n.to(dtype)
    # the first bin whose inclusive cumsum reaches the target
    reached = cum[None, :] >= torch.ceil(targets)[:, None].to(torch.int64)
    idx = torch.argmax(reached.to(torch.int32), dim=1)
    cum_lo = torch.where(idx > 0, cum[torch.clamp(idx - 1, min=0)], 0)
    in_bin = torch.clamp(cum[idx] - cum_lo, min=1)
    frac = (targets - cum_lo.to(dtype)) / in_bin.to(dtype)
    cuts = lo + (idx.to(dtype) + torch.clamp(frac, 0.0, 1.0)) * width
    ends = torch.tensor([lo, hi], dtype=dtype, device=dev)
    return torch.cat([ends[:1], cuts, ends[1:]])


def uniform_bounds(d: int, lo: float, hi: float, dtype=torch.float32, device=None) -> torch.Tensor:
    """(d + 1,) equal-width boundaries, as jnp.linspace computes them
    (lo (1 - s) + hi s with s = i / d, the last one hi)."""
    s = torch.arange(d, dtype=dtype, device=device) / d
    ends = torch.tensor([lo, hi], dtype=dtype, device=device)
    return torch.cat([ends[0] * (1 - s) + ends[1] * s, ends[1:]])


def pack_first(mask: torch.Tensor, cap: int, n_total: int) -> tuple:
    """(idx, count): the global ids of the first `cap` True rows of mask in
    order, padded with n_total, and the number of True rows (a count above
    cap is an overflow)."""
    cum = torch.cumsum(mask.to(torch.int32), dim=0)
    slot = torch.where(mask, torch.clamp(cum - 1, max=cap), cap).to(torch.int64)
    out = torch.full((cap + 1,), n_total, dtype=torch.int64, device=mask.device)
    out[slot] = torch.arange(n_total, dtype=torch.int64, device=mask.device)
    return out[:cap], cum[n_total - 1]


def ghost_sources(idx_prev: torch.Tensor, idx_next: torch.Tensor, ghost_idx: torch.Tensor,
                  n_total: int, n_cap: int) -> tuple:
    """Each ghost's (comes from the previous rank?, slot in that rank's own
    buffer, found in either): ghosts are one ring hop away by contract."""
    dev = ghost_idx.device
    slots = torch.arange(n_cap, dtype=torch.int64, device=dev)
    inv_prev = torch.full((n_total + 1,), n_cap, dtype=torch.int64, device=dev)
    inv_prev[torch.clamp(idx_prev, max=n_total)] = slots
    inv_next = torch.full((n_total + 1,), n_cap, dtype=torch.int64, device=dev)
    inv_next[torch.clamp(idx_next, max=n_total)] = slots
    gi = torch.clamp(ghost_idx, max=n_total)
    s_prev, s_next = inv_prev[gi], inv_next[gi]
    from_prev = s_prev < n_cap
    slot = torch.where(from_prev, s_prev, s_next)
    return from_prev, torch.clamp(slot, max=n_cap - 1), from_prev | (s_next < n_cap)


def ring_exchange(group: Group, x: torch.Tensor) -> tuple:
    """(from the previous rank, from the next rank) of every rank's x. At
    d = 2 both are the other rank: one ppermute serves both."""
    up, dn = ring_perms(group.size)
    from_prev = group.ppermute(x, up)
    return from_prev, (from_prev if group.size == 2 else group.ppermute(x, dn))


def refresh_ghosts(group: Group, val_own: torch.Tensor, gf_prev: torch.Tensor,
                   gslot: torch.Tensor) -> torch.Tensor:
    """The ghost slots' values of an (n_cap, ...) own-slot array: the ring
    exchange and the precomputed source-slot gather."""
    from_prev, from_next = ring_exchange(group, val_own)
    sel = gf_prev.reshape((-1,) + (1,) * (val_own.ndim - 1))
    return torch.where(sel, from_prev[gslot], from_next[gslot])


def gather_by_gid(group: Group, values: torch.Tensor, gid: torch.Tensor,
                  n_total: int) -> torch.Tensor:
    """(n_total, ...) of every rank's (n_cap, ...) slot values, placed by
    global id (gid n_total marks an empty slot): an all_gather of the own
    buffers and one scatter, the same on every rank."""
    vals = torch.cat(group.all_gather(values.contiguous()))
    gids = torch.cat(group.all_gather(gid.contiguous())).to(torch.int64)
    flat = values.new_zeros((n_total + 1,) + tuple(values.shape[1:]))
    flat[torch.clamp(gids, max=n_total)] = vals
    return flat[:n_total]


def ovf_bits_of(group: Group, state: dict) -> int:
    """The OR over ranks of the overflow bits (a collective)."""
    b = torch.stack([(state["ovf_bits"] >> k) & 1 for k in range(4)]).to(torch.int32)
    b = group.pmax(b)
    return int(sum(int(b[k]) << k for k in range(4)))


def ovf_bit(flag: torch.Tensor, bit: int) -> torch.Tensor:
    """`bit` where the 0-d bool `flag` is set, else 0 (int32)."""
    return flag.to(torch.int32) * bit


def make_balanced_settling_step(group: Group, n_total: int, box: tuple, radius: float = 0.5,
                                youngs: float = 1000.0, poisson: float = 0.3,
                                viscosity: float = 1.0, gravity: float = 5.0,
                                wall_spring: float = 1000.0, dt: float = 1e-4,
                                skin: float = 0.3, own_slack: float = 1.5,
                                ghost_slack: float = 3.0, max_neighbors: int = 24,
                                cell_capacity: int = 24, balance: str = "balanced",
                                dtype=torch.float32) -> BalancedEngine:
    """Overdamped Hertzian spheres settling under gravity in the free box
    (Lx, Ly, Lz) (floor at z = 0), over density-balanced z-slabs of this
    rank's group. init(pos) takes the full (N, 3) positions (every rank the
    same); step_block(state, n) runs n steps, a rebalance and rebuild before
    any step whose skin trigger fired; gather(state) -> ((N, 3) positions,
    (N,) count of owners of each body)."""
    if balance not in ("balanced", "uniform"):
        raise ValueError(f"unknown balance {balance!r}")
    d, r, dev = group.size, group.rank, group.device
    n_cap, g_cap = capacities(n_total, d, own_slack, ghost_slack)
    lx, ly, lz = (float(b) for b in box)
    cutoff = 2.0 * radius + skin
    m_tot = n_cap + g_cap
    drag = 6.0 * _math.pi * viscosity * radius
    e_eff = torch.tensor(effective_youngs(youngs, youngs, poisson, poisson), dtype=dtype,
                         device=dev)
    r_eff = torch.tensor(0.5 * radius, dtype=dtype, device=dev)
    dt_t = torch.tensor(dt, dtype=dtype, device=dev)
    grid = make_cell_grid([0, 0, 0], [lx, ly, lz], cutoff, (False,) * 3, dtype=dtype, device=dev)

    def _forces(pos_m, valid_m):
        """Forces on all m_tot local slots from own and ghost neighbours
        (only the first n_cap own rows are used)."""
        p = pos_m
        clist = build_cell_list(p, grid, cell_capacity, valid=valid_m)
        nmat = neighbor_matrix(p, clist, cutoff / 2, max_neighbors=max_neighbors,
                               chunk=min(4096, m_tot))
        idx = torch.clamp(nmat.idx, max=m_tot - 1).to(torch.int64)
        sep = p[idx] - p[:, None, :]
        dist = torch.sqrt(torch.clamp((sep * sep).sum(-1), min=1e-12))
        fmag = hertzian_pair_force(dist - 2.0 * radius, r_eff, e_eff)
        fvec = -fmag[..., None] * sep / dist[..., None]
        fvec = torch.where((nmat.mask & valid_m[idx])[..., None], fvec, 0.0)
        f = fvec.sum(1)

        def spring(over):
            return wall_spring * torch.clamp(over, min=0.0) ** 1.5

        # walls: floor and ceiling, the four sides (Hertzian springs); gravity
        f[:, 2] += spring(radius - p[:, 2]) - spring(p[:, 2] - (lz - radius))
        f[:, 0] += spring(radius - p[:, 0]) - spring(p[:, 0] - (lx - radius))
        f[:, 1] += spring(radius - p[:, 1]) - spring(p[:, 1] - (ly - radius))
        f[:, 2] += -gravity
        ovf = clist.overflow | nmat.overflow
        return torch.where(valid_m[:, None], f, 0.0), ovf

    def _repack(pos_all):
        """Own and ghost buffers of this rank from the full positions:
        (own_idx, own_valid, ghost_idx, ghost_valid, bounds, ovf bits)."""
        zs = pos_all[:, 2]
        if balance == "balanced":
            bounds = balanced_bounds(zs, torch.ones_like(zs, dtype=torch.bool), d, 0.0, lz)
        else:
            bounds = uniform_bounds(d, 0.0, lz, dtype, dev)
        b_lo, b_hi = bounds[r], bounds[r + 1]
        # the edge ranks absorb out-of-range stragglers (the soft walls let z
        # dip below 0 or above lz), so every body has exactly one owner
        above = torch.ones_like(zs, dtype=torch.bool) if r == 0 else zs >= b_lo
        below = torch.ones_like(zs, dtype=torch.bool) if r == d - 1 else zs < b_hi
        own = above & below
        own_idx, n_own = pack_first(own, n_cap, n_total)
        margin = cutoff + skin
        gh = ~own & (zs >= b_lo - margin) & (zs < b_hi + margin)
        ghost_idx, n_gh = pack_first(gh, g_cap, n_total)
        ghost_valid = ghost_idx < n_total
        # every ghost must be owned by a ring neighbour (one hop)
        gz = zs[torch.clamp(ghost_idx, max=n_total - 1)]
        reach_lo = bounds[max(r - 1, 0)] if r > 0 else torch.zeros((), dtype=dtype, device=dev)
        reach_hi = (bounds[min(r + 2, d)] if r < d - 1
                    else torch.tensor(lz, dtype=dtype, device=dev))
        # (A & B) | (C & D), as Python's precedence reads the reference's
        hop_ok = ~ghost_valid | (((gz >= reach_lo) & (gz < reach_hi))
                                 | ((r == d - 1) & (gz >= reach_lo)))
        bits = (ovf_bit(n_own > n_cap, OVF_OWN) | ovf_bit(n_gh > g_cap, OVF_GHOST)
                | ovf_bit(~hop_ok.all(), OVF_HOP))
        return own_idx, own_idx < n_total, ghost_idx, ghost_valid, bounds, bits

    def _layout(pos_all, state):
        """The repacked state from the full positions (init and rebuild)."""
        own_idx, own_valid, ghost_idx, ghost_valid, bounds, bits = _repack(pos_all)
        safe = torch.clamp(own_idx, max=n_total - 1)
        new_pos = torch.where(own_valid[:, None], pos_all[safe], 0.0)
        idx_prev, idx_next = ring_exchange(group, own_idx)
        gf_prev, gslot, found = ghost_sources(idx_prev, idx_next, ghost_idx, n_total, n_cap)
        # a ghost missing from its owner's buffer: that buffer overflowed (a
        # ghost two hops away also fails the z test of _repack)
        bits = bits | ovf_bit(~(~ghost_valid | found).all(), OVF_OWN)
        gpos = torch.where(ghost_valid[:, None],
                           pos_all[torch.clamp(ghost_idx, max=n_total - 1)], 0.0)
        bits = state["ovf_bits"] | bits
        return {**state, "pos": new_pos, "valid": own_valid, "gid": own_idx,
                "ghost_pos": gpos, "ghost_from_prev": gf_prev, "ghost_slot": gslot,
                "ghost_valid": ghost_valid, "ref_pos": new_pos, "bounds": bounds,
                "ovf_bits": bits, "overflow": bits > 0}

    def inner_step(state):
        pos_o, valid_o = state["pos"], state["valid"]
        gpos = refresh_ghosts(group, pos_o, state["ghost_from_prev"], state["ghost_slot"])
        pos_m = torch.cat([pos_o, gpos])
        valid_m = torch.cat([valid_o, state["ghost_valid"]])
        f, fovf = _forces(pos_m, valid_m)
        vel = f[:n_cap] / drag
        pos_o = torch.where(valid_o[:, None], pos_o + dt_t * vel, pos_o)
        bits = state["ovf_bits"] | ovf_bit(fovf, OVF_SEARCH)
        return {**state, "pos": pos_o, "ghost_pos": gpos, "ovf_bits": bits,
                "overflow": bits > 0}

    def moved(state) -> bool:
        disp = torch.where(state["valid"][:, None], state["pos"] - state["ref_pos"], 0.0)
        local = (disp * disp).sum(-1).max()
        return bool(group.pmax(local.reshape(1))[0] > (0.5 * skin) ** 2)

    def rebuild(state):
        pos_all = gather_by_gid(group, state["pos"], state["gid"], n_total)
        state = _layout(pos_all, state)
        return {**state, "rebuilds": state["rebuilds"] + 1}

    def init(pos) -> dict:
        pos_all = torch.as_tensor(pos, dtype=dtype, device=dev)
        zero = torch.zeros((), dtype=torch.int32, device=dev)
        return _layout(pos_all, {"ovf_bits": zero, "rebuilds": 0})

    def step_block(state, n_steps: int) -> dict:
        """The reference's control flow: before each step, a rebuild when the
        (global) skin trigger fired."""
        for _ in range(n_steps):
            if moved(state):
                state = rebuild(state)
            state = inner_step(state)
        return state

    def gather(state) -> tuple:
        """((N, 3) positions, (N,) number of owners of each body), every
        rank the same."""
        gid = torch.where(state["valid"], state["gid"], n_total)
        pos = gather_by_gid(group, state["pos"], gid, n_total)
        gids = torch.cat(group.all_gather(gid))
        seen = torch.bincount(gids, minlength=n_total + 1)[:n_total]
        return pos, seen

    return BalancedEngine(init, step_block, gather, n_cap, g_cap)


def reference_settling_step(n_total: int, box: tuple, radius: float = 0.5,
                            youngs: float = 1000.0, poisson: float = 0.3,
                            viscosity: float = 1.0, gravity: float = 5.0,
                            wall_spring: float = 1000.0, dt: float = 1e-4, skin: float = 0.3,
                            max_neighbors: int = 24, cell_capacity: int = 24,
                            dtype=torch.float32, device="cuda") -> Callable:
    """The same physics on one device, no slabs: step(pos) -> (pos,
    overflow), the yardstick of the balanced-slab trajectories."""
    lx, ly, lz = (float(b) for b in box)
    dev = torch.device(device)
    cutoff = 2.0 * radius + skin
    drag = 6.0 * _math.pi * viscosity * radius
    e_eff = torch.tensor(effective_youngs(youngs, youngs, poisson, poisson), dtype=dtype,
                         device=dev)
    r_eff = torch.tensor(0.5 * radius, dtype=dtype, device=dev)
    dt_t = torch.tensor(dt, dtype=dtype, device=dev)
    grid = make_cell_grid([0, 0, 0], [lx, ly, lz], cutoff, (False,) * 3, dtype=dtype, device=dev)

    def step(pos):
        clist = build_cell_list(pos, grid, cell_capacity)
        nmat = neighbor_matrix(pos, clist, cutoff / 2, max_neighbors=max_neighbors,
                               chunk=min(4096, n_total))
        idx = torch.clamp(nmat.idx, max=n_total - 1).to(torch.int64)
        sep = pos[idx] - pos[:, None, :]
        dist = torch.sqrt(torch.clamp((sep * sep).sum(-1), min=1e-12))
        fmag = hertzian_pair_force(dist - 2.0 * radius, r_eff, e_eff)
        fvec = -fmag[..., None] * sep / dist[..., None]
        f = torch.where(nmat.mask[..., None], fvec, 0.0).sum(1)

        def spring(over):
            return wall_spring * torch.clamp(over, min=0.0) ** 1.5

        f[:, 2] += spring(radius - pos[:, 2]) - spring(pos[:, 2] - (lz - radius))
        f[:, 0] += spring(radius - pos[:, 0]) - spring(pos[:, 0] - (lx - radius))
        f[:, 1] += spring(radius - pos[:, 1]) - spring(pos[:, 1] - (ly - radius))
        f[:, 2] += -gravity
        return pos + dt_t * f / drag, clist.overflow | nmat.overflow

    return step
