"""Non-penetration collision resolution via matrix-free BBPGD LCP.

Port of mundy_tpu/constraints/collision.py: the ordered pair layout
(every contact stored as (i, j) and (j, i), i-sorted) with per-step
active-set compaction, strided (the LCP spheres line's, force assembly
through kernel K3, ops/segments.segment_sum_strided) or windowed
(`active_pair_subset`, assembly through K3 on the gathered windows,
ops/segments.segment_sum_sorted_blocked); the unordered layout (unique i <
j pairs) with its two-sided assembly, two scatter-adds with or without a
rebuild-time `pair_j_permutation`; and the
three scalar-mobility Delassus applies with the dual-slot j-side: the
banded one the app runs, the block-local one through kernel K3t
(ops/segments.strided_t) and the assembled per-block one. Every assembly
sums each body's terms in one fixed order: the sorted and unordered ones
through `index_put_(accumulate=True)`, which on the card sorts the targets
and sums each target's terms in index order, so two runs are bit-equal
(an `index_add_` would add repeated targets with atomics, in no fixed
order).

LCP statement (per the reference): find gamma >= 0 with
    sep_new = sep0 + dt * D^T M D gamma >= 0,  gamma . sep_new = 0.

ref: `scrap/lcp_spheres/StkNgpLCP.cpp` (constraint generation `:468-510`,
sum_collision_force `:578`, compute_rate_of_change_of_sep `:635`, BBPGD
`:705-875`).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from mundy_tpu_torch.geom.periodicity import Metric
from mundy_tpu_torch.math.convex import PGDConfig, SolveResult, solve_lcp
from mundy_tpu_torch.neighbor.cell_list import PairList
from mundy_tpu_torch.neighbor.rows import orthorhombic_lengths
from mundy_tpu_torch.ops.segments import (
    SegmentWindows,
    StridedWindows,
    segment_sum_sorted_blocked,
    segment_sum_strided,
    strided_t,
)


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[idx] with indices clamped into range, as a JAX gather clamps them:
    pad slots carry id N and read row N-1 (their normals are zero)."""
    return x[torch.clamp(idx, 0, x.shape[0] - 1).to(torch.int64)]


class CollisionSetup(NamedTuple):
    """Per-pair constraint data (capacity-padded, mask in `pairs.mask`).

    Two assembly layouts:
    - ordered: `pairs` from build_pair_list_ordered (every contact in both
      directions, i sorted) and `windows` the block structure of the list
      (StridedWindows or SegmentWindows); D gamma is one blocked segmented
      reduction, each ordered pair pushing only its own i;
    - unordered: unique i < j pairs, a two-sided assembly (two
      scatter-adds; `j_perm` is carried as the reference's)."""

    pairs: PairList
    normals: torch.Tensor  # (C, 3) unit, from body i toward body j
    sep0: torch.Tensor  # (C,) signed separation at assembly time
    j_perm: Optional[torch.Tensor] = None  # (C,) pairs sorted by j, pads last
    windows: Optional[object] = None  # the ordered layout's block structure


def body_pair_starts(nmat) -> torch.Tensor:
    """(N+1,) int32 exclusive-cumulative per-body pair counts of an (N, K)
    neighbor matrix: where each body's run starts in the ordered pair list
    build_pair_list_ordered compacts from it."""
    counts = nmat.mask.sum(dim=1, dtype=torch.int32)
    return torch.cat([torch.zeros(1, dtype=torch.int32, device=counts.device),
                      torch.cumsum(counts, dim=0, dtype=torch.int32)])


def remap_gamma(old_pairs: PairList, old_gamma: torch.Tensor, new_pairs: PairList,
                probes: int, old_starts: Optional[torch.Tensor] = None,
                old_nmat=None) -> torch.Tensor:
    """Carry warm-start multipliers across a pair-list rebuild by pair
    identity (i, j), not by slot. Unmatched (fresh) pairs start at 0.

    With `old_nmat` and `old_starts` the old slot of (i, j) is
    old_starts[i] + the number of valid old entries before j's lane in the
    old neighbor row (one row gather). Without `old_nmat` each new pair
    probes `probes` slots from the start of its old i-run (located by
    `old_starts`, else by a search). Values may carry trailing dims."""
    c_old = old_pairs.i.shape[0]
    tail = (1,) * (old_gamma.ndim - 1)
    if old_nmat is not None and old_starts is not None:
        n = old_starts.shape[0] - 1
        safe_i = torch.clamp(new_pairs.i, max=n - 1).to(torch.int64)
        rows = old_nmat.idx[safe_i]  # (C_new, K)
        rmask = old_nmat.mask[safe_i]
        match = (rmask & (rows == new_pairs.j[:, None])
                 & (new_pairs.mask & (new_pairs.i < n))[:, None])
        prefix = torch.cumsum(rmask.to(torch.int32), dim=1) - rmask.to(torch.int32)
        # last matching lane wins (the probing loop's overwrite order)
        t = torch.where(match, prefix, -1).max(dim=1).values
        slot = old_starts[safe_i] + torch.clamp(t, min=0)
        hit = (t >= 0) & (slot < c_old)  # pairs the old list truncated carry none
        vals = old_gamma[torch.clamp(slot, max=c_old - 1).to(torch.int64)]
        return torch.where(hit.reshape(hit.shape + tail), vals, torch.zeros_like(vals))
    if old_starts is not None:
        n = old_starts.shape[0] - 1
        safe_i = torch.clamp(new_pairs.i, max=n - 1).to(torch.int64)
        start = torch.where(new_pairs.i < n, old_starts[safe_i], c_old)
    else:
        n_mark = torch.maximum(old_pairs.i.max(), new_pairs.i.max()) + 1
        # padded slots must sort to the end whatever the pad convention
        old_i = torch.where(old_pairs.mask, old_pairs.i, n_mark).contiguous()
        start = torch.searchsorted(old_i, new_pairs.i.contiguous())
    out = torch.zeros(new_pairs.i.shape + old_gamma.shape[1:], dtype=old_gamma.dtype,
                      device=old_gamma.device)
    for t in range(probes):
        idx = torch.clamp(start + t, max=c_old - 1).to(torch.int64)
        hit = ((old_pairs.i[idx] == new_pairs.i) & (old_pairs.j[idx] == new_pairs.j)
               & old_pairs.mask[idx] & new_pairs.mask)
        out = torch.where(hit.reshape(hit.shape + tail), old_gamma[idx], out)
    return out


def active_pair_subset(setup: CollisionSetup, margin, capacity: int, n_bodies: int,
                       seg_starts: Optional[torch.Tensor] = None, block_bodies: int = 0,
                       window: int = 0):
    """Per-step compaction of the near-contact pairs (sep0 < margin) of a
    full skin-buffered list into the first `capacity` slots, in list order
    (i sorted stays i sorted): active slot c takes its full-list index at
    position cum[c] - 1 of the active cumsum. Beyond the margin
    complementarity pins gamma = 0.

    Returns (setup_act, sel, n_act, overflow): `sel` (capacity,) int32 maps
    an active slot to its full-list slot, C (the full capacity) past n_act;
    overflow = n_act > capacity. With `seg_starts` (the full list's
    per-block window starts, segment_windows at rebuild), `block_bodies`
    and `window`, the active list's SegmentWindows follow from the cumsum
    (block b's active window starts at the actives before its full start)
    and ride on the returned setup."""
    pairs = setup.pairs
    c_full = pairs.i.shape[0]
    dev = pairs.i.device
    act = pairs.mask & (setup.sep0 < margin)
    cum = torch.cumsum(act.to(torch.int32), dim=0, dtype=torch.int32)
    n_act = cum[c_full - 1]
    # inactive slots and actives beyond capacity land on the dump slot
    # `capacity`; the active positions cum - 1 are unique
    slots = torch.where(act, torch.clamp(cum - 1, max=capacity), capacity).to(torch.int64)
    sel = torch.full((capacity + 1,), c_full, dtype=torch.int32, device=dev)
    sel[slots] = torch.arange(c_full, dtype=torch.int32, device=dev)
    sel = sel[:capacity]
    valid = sel < c_full
    sel_c = torch.clamp(sel, max=c_full - 1).to(torch.int64)
    ai = torch.where(valid, pairs.i[sel_c], n_bodies)
    aj = torch.where(valid, pairs.j[sel_c], n_bodies)
    an = torch.where(valid[:, None], setup.normals[sel_c], 0.0)
    as0 = torch.where(valid, setup.sep0[sel_c], 1.0)
    apairs = PairList(i=ai, j=aj, mask=valid, num_pairs=n_act, overflow=n_act > capacity)
    windows = None
    if seg_starts is not None:
        n_act_c = torch.clamp(n_act, max=capacity)
        fs = seg_starts.to(torch.int64)
        astarts = torch.where(fs > 0, torch.minimum(cum[torch.clamp(fs - 1, min=0)], n_act_c),
                              0).to(torch.int32)
        counts = torch.diff(torch.cat([astarts, n_act_c.reshape(1).to(torch.int32)]))
        windows = SegmentWindows(starts=astarts, block_bodies=block_bodies, window=window,
                                 overflow=(counts > window).any())
    return (CollisionSetup(pairs=apairs, normals=an, sep0=as0, windows=windows),
            torch.where(valid, sel, c_full), n_act, n_act > capacity)


class StridedActive(NamedTuple):
    """active_pair_subset_strided result."""

    setup: CollisionSetup
    sel: torch.Tensor  # (nb*W,) active slot -> full-list slot (pad = C)
    n_act: torch.Tensor  # () total active pairs (uncapped)
    block_max: torch.Tensor  # () largest uncapped per-block count
    overflow: torch.Tensor  # () bool, any block count > W
    cum: torch.Tensor  # (C,) int32 inclusive active cumsum (next step's warm map)
    dual: Optional[torch.Tensor] = None  # (A,) active slot of the (j, i) duplicate
    gamma0: Optional[torch.Tensor] = None  # (A,) warm-start multipliers


def active_pair_subset_strided(setup: CollisionSetup, margin, n_bodies: int,
                               block_bodies: int, window: int,
                               full_starts: torch.Tensor,
                               dual_full: Optional[torch.Tensor] = None,
                               prev: Optional[tuple] = None,
                               gamma_full: Optional[torch.Tensor] = None) -> StridedActive:
    """Per-step compaction of the near-contact pairs (sep0 < margin) into the
    strided layout: active pairs of body block b land at slots
    [b*W, b*W + c_b). Beyond the margin complementarity pins gamma = 0.

    `full_starts` (nb,): the full list's per-block window starts.
    `dual_full` ((C,) from pair_dual_slots): also emit `dual`, the active
    slot of each active pair's (j, i) duplicate (self where it overflowed).
    `prev` ((prev_cum, prev_gamma, prev_window)): also emit `gamma0`, last
    step's multiplier of every persisting active pair; entering pairs take
    `gamma_full` (the rebuild-time snapshot) when given, else 0."""
    pairs = setup.pairs
    c_full = pairs.i.shape[0]
    B, W = block_bodies, window
    nb = full_starts.shape[0]
    dev = pairs.i.device
    fs = full_starts.to(torch.int64)
    act = pairs.mask & (setup.sep0 < margin)
    cum = torch.cumsum(act.to(torch.int32), dim=0, dtype=torch.int32)  # inclusive
    n_act = cum[c_full - 1]
    base = torch.where(fs > 0, cum[torch.clamp(fs - 1, min=0)], 0)  # actives before block
    ends = torch.cat([fs[1:], torch.tensor([c_full], device=dev)])
    counts = torch.where(ends > 0, cum[torch.clamp(ends - 1, min=0)], 0) - base
    block_max = counts.max()
    overflow = block_max > W
    bid = torch.clamp(pairs.i.to(torch.int64) // B, max=nb - 1)
    rank = cum - 1 - base[bid]
    ok = act & (rank < W)
    slot = torch.where(ok, bid * W + rank, nb * W)
    sel = torch.full((nb * W + 1,), c_full, dtype=torch.int32, device=dev)
    sel[slot] = torch.arange(c_full, dtype=torch.int32, device=dev)  # nb*W is the dump
    sel = sel[:nb * W]
    valid = sel < c_full
    sel_c = torch.clamp(sel, max=c_full - 1).to(torch.int64)

    ai = torch.where(valid, pairs.i[sel_c], n_bodies)
    aj = torch.where(valid, pairs.j[sel_c], n_bodies)
    an = torch.where(valid[:, None], setup.normals[sel_c], 0.0)
    as0 = torch.where(valid, setup.sep0[sel_c], 1.0)
    apairs = PairList(i=ai, j=aj, mask=valid, num_pairs=n_act, overflow=overflow)
    windows = StridedWindows(block_bodies=B, window=W, nb=nb, overflow=overflow)
    setup_act = CollisionSetup(pairs=apairs, normals=an, sep0=as0, windows=windows)

    dual = None
    if dual_full is not None:
        d = torch.clamp(dual_full[sel_c], max=c_full - 1).to(torch.int64)
        bid_j = torch.clamp(torch.clamp(aj, max=n_bodies - 1).to(torch.int64) // B,
                            max=nb - 1)
        rank_j = cum[d] - 1 - base[bid_j]
        self_slot = torch.arange(nb * W, device=dev)
        dual = torch.where(valid & (rank_j >= 0) & (rank_j < W),
                           bid_j * W + rank_j, self_slot).to(torch.int32)

    gamma0 = None
    if prev is not None:
        prev_cum, prev_gamma, w_old = prev
        a_old = prev_gamma.shape[0]
        base_old = torch.where(fs > 0, prev_cum[torch.clamp(fs - 1, min=0)], 0)
        pc = prev_cum[sel_c]
        prev_excl = torch.where(sel_c > 0, prev_cum[torch.clamp(sel_c - 1, min=0)], 0)
        was_act = pc > prev_excl
        bid_a = torch.arange(nb, device=dev).repeat_interleave(W)
        rank_old = pc - 1 - base_old.repeat_interleave(W)
        slot_old = torch.clamp(bid_a * w_old + rank_old, max=a_old - 1)
        hit = valid & was_act & (rank_old >= 0) & (rank_old < w_old)
        g_entry = gamma_full[sel_c] if gamma_full is not None else 0.0
        gamma0 = torch.where(hit, prev_gamma[torch.clamp(slot_old, min=0)],
                             torch.where(valid, g_entry, 0.0))

    return StridedActive(setup=setup_act, sel=sel, n_act=n_act, block_max=block_max,
                         overflow=overflow, cum=cum, dual=dual, gamma0=gamma0)


def pair_dual_slots(pairs: PairList, starts: torch.Tensor, nmat,
                    near: Optional[torch.Tensor] = None) -> tuple:
    """Full-list slot of each pair's (j, i) duplicate -> ((C,) int32, missing).

    (j, i) sits at starts[j] + the rank of i within j's neighbor row. A pair
    with no duplicate points at itself; `missing` flags that, restricted to
    the pairs in `near` (the caller's gate: only contact-capable asymmetry
    matters, see the reference's docstring)."""
    n = starts.shape[0] - 1
    c_full = pairs.i.shape[0]
    safe_j = torch.clamp(pairs.j, max=n - 1).to(torch.int64)
    rows = nmat.idx[safe_j]  # (C, K)
    rmask = nmat.mask[safe_j]
    live = pairs.mask & (pairs.j < n)
    match = rmask & (rows == pairs.i[:, None]) & live[:, None]
    prefix = torch.cumsum(rmask.to(torch.int32), dim=1) - rmask.to(torch.int32)
    t = torch.where(match, prefix, -1).max(dim=1).values
    slot = starts[safe_j] + torch.clamp(t, min=0)
    hit = (t >= 0) & (slot < c_full)
    dual = torch.where(hit, slot, torch.arange(c_full, dtype=torch.int32,
                                               device=slot.device))
    relevant = live if near is None else (live & near)
    return dual.to(torch.int32), (relevant & ~hit).any()


def pair_j_permutation(pairs: PairList, n_bodies: int) -> torch.Tensor:
    """Rebuild-time permutation sorting pairs by j (padded slots last, ties
    in slot order)."""
    key = torch.where(pairs.mask, pairs.j, n_bodies)
    return torch.argsort(key, stable=True).to(torch.int32)


def collision_setup_spheres(pos: torch.Tensor, radius, pairs: PairList,
                            metric: Optional[Metric] = None,
                            j_perm: Optional[torch.Tensor] = None,
                            windows: Optional[object] = None) -> CollisionSetup:
    """Signed separation + contact normal per pair (orthorhombic boxes take a
    per-component minimum image). ref:
    compute_signed_separation_distance_and_contact_normal
    (`StkNgpLCP.cpp:468-510`)."""
    box = None if metric is None else orthorhombic_lengths(metric)
    pi = _take(pos, pairs.i)
    pj = _take(pos, pairs.j)
    if metric is None or box is not None:
        sep = pj - pi
        if box is not None:
            lens, flags = box
            shift = torch.tensor([l if f else 0.0 for l, f in zip(lens, flags)],
                                 dtype=pos.dtype, device=pos.device)
            safe = torch.where(shift > 0, shift, 1.0)
            sep = sep - shift * torch.round(sep / safe)
        d2 = torch.clamp((sep * sep).sum(-1), min=1e-24)
        rinv = torch.rsqrt(d2) if d2.dtype == torch.float32 else 1.0 / torch.sqrt(d2)
        d = d2 * rinv
        normals = sep * rinv[..., None]
    else:
        sep = metric.sep(pi, pj)
        d = torch.sqrt(torch.clamp((sep * sep).sum(-1), min=1e-24))
        normals = sep / d[..., None]
    radius = torch.as_tensor(radius, dtype=pos.dtype, device=pos.device)
    if radius.ndim == 0:
        sep0 = d - 2.0 * radius
    else:
        sep0 = d - _take(radius, pairs.i) - _take(radius, pairs.j)
    return CollisionSetup(pairs=pairs, normals=normals, sep0=sep0, j_perm=j_perm,
                          windows=windows)


def _scatter_sum(n_bodies: int, ids: torch.Tensor, vals: torch.Tensor, keep: torch.Tensor,
                 buf: Optional[torch.Tensor] = None) -> torch.Tensor:
    """vals summed per id in index order into `buf` ((n_bodies + C, D),
    zeros if None), returned whole: bodies first, then one dump row per
    slot. A slot with keep False or an id outside [0, n_bodies) (JAX drops
    those) adds into its own dump row: the card's sorted accumulation walks
    each target's run serially, so pad slots piled on one row would make a
    run as long as the padding."""
    ok = keep & (ids >= 0) & (ids < n_bodies)
    dump = n_bodies + torch.arange(ids.shape[0], device=ids.device)
    if buf is None:
        buf = vals.new_zeros((n_bodies + ids.shape[0], vals.shape[1]))
    buf.index_put_((torch.where(ok, ids.to(torch.int64), dump),), vals, accumulate=True)
    return buf


def collision_forces(setup: CollisionSetup, gamma: torch.Tensor, n_bodies: int) -> torch.Tensor:
    """F = D gamma: -gamma n to body i, +gamma n to body j.

    Ordered layout (`windows` set): pair (i, j) pushes -gamma n on i only,
    its (j, i) duplicate delivers +gamma n to j; one blocked segmented
    reduction through kernel K3 (strided or windowed). Unordered layout:
    -gamma n is scattered to i and then +gamma n to j, with or without
    `j_perm`: the reference sorts the j side by it for two sorted segment
    sums, and `index_put_(accumulate=True)` sorts its targets itself
    (stably, ties in slot order), so the gather through `j_perm` would
    change no body's order of terms. Padded ids (>= n_bodies) are dropped.
    ref: sum_collision_force (`StkNgpLCP.cpp:578-610`)."""
    g = torch.where(setup.pairs.mask, gamma, 0.0)
    gn = g[:, None] * setup.normals
    pairs = setup.pairs
    if setup.windows is not None:
        if isinstance(setup.windows, StridedWindows):
            return segment_sum_strided(-gn, pairs.i, n_bodies, setup.windows)
        return segment_sum_sorted_blocked(-gn, pairs.i, n_bodies, setup.windows)
    f = _scatter_sum(n_bodies, pairs.i, -gn, pairs.mask)
    return _scatter_sum(n_bodies, pairs.j, gn, pairs.mask, buf=f)[:n_bodies]


def _sep_rate(setup: CollisionSetup, vel: torch.Tensor) -> torch.Tensor:
    """sdot = D^T U = -n . (U_i - U_j) (`StkNgpLCP.cpp:635-668`)."""
    dv = _take(vel, setup.pairs.i) - _take(vel, setup.pairs.j)
    return -(setup.normals * dv).sum(-1)


def _scalar_mobilities(setup: CollisionSetup, dt, mobility_i, mobility_j):
    """(c_i, c_j, dt): per-pair or scalar drag mobilities (default 1, fold a
    constant into dt) and dt as a tensor in the setup's dtype."""
    ci = 1.0 if mobility_i is None else mobility_i
    cj = 1.0 if mobility_j is None else mobility_j
    return ci, cj, torch.as_tensor(dt, dtype=setup.sep0.dtype, device=setup.sep0.device)


def make_local_drag_apply(setup: CollisionSetup, dual: torch.Tensor, dt,
                          mobility_i=None, mobility_j=None):
    """Block-local Delassus apply for scalar (local-drag) mobility.

    In the ordered layout F_i is block-local (pair (i, j) pushes only on i;
    its (j, i) duplicate handles j), and the j-side of sdot is the dual
    pair's i-side:
        sdot_p = -n_p.(U_i - U_j) = c_i t_p + c_j t_{dual(p)},
        t_q = -n_q . F_{i(q)}.
    Kernel K3t computes t (assembly and extraction in one pass, no global
    (A, 3) gather); one (A,) gather crosses blocks. `mobility_i` and
    `mobility_j`: per-pair drag mobilities c_{i(p)}, c_{j(p)} ((A,) tensors
    for polydisperse radii) or scalars. ref: sum_collision_force +
    compute_the_mobility_problem + compute_rate_of_change_of_sep
    (`StkNgpLCP.cpp:578-668`) for the dry local-drag mobility."""
    n_slots = setup.pairs.i.shape[0]
    ci, cj, dt = _scalar_mobilities(setup, dt, mobility_i, mobility_j)
    dual_c = torch.clamp(dual, max=n_slots - 1).to(torch.int64)

    def apply_A(gamma):
        g = torch.where(setup.pairs.mask, gamma, 0.0)
        t = strided_t(g, setup.normals, setup.pairs.i, setup.windows)
        return dt * (ci * t + cj * t[dual_c])

    return apply_A


def assemble_block_delassus(setup: CollisionSetup) -> torch.Tensor:
    """(nb, W, W) i-side Delassus diagonal blocks on the strided layout:
    M[b, p, q] = (i_p == i_q) * (n_p . n_q) over block-local slots p, q.
    Invalid slots (mask off or id outside the block) zero their row and
    column; the diagonal carries |n_p|^2 = 1, pair p's own contribution to
    F_{i(p)}, as in K3t. The active set is fixed across a solve, so M is
    assembled once per step."""
    windows = setup.windows
    B, W, nb = windows.block_bodies, windows.window, windows.nb
    blk = torch.arange(nb, dtype=torch.int32, device=setup.pairs.i.device)[:, None] * B
    loc = setup.pairs.i.reshape(nb, W) - blk
    valid = setup.pairs.mask.reshape(nb, W) & (loc >= 0) & (loc < B)
    locv = torch.where(valid, loc, -1)
    eq = ((locv[:, :, None] == locv[:, None, :])
          & valid[:, :, None] & valid[:, None, :])
    nrm = setup.normals.reshape(nb, W, 3)
    dots = (nrm[:, :, None, 0] * nrm[:, None, :, 0]
            + nrm[:, :, None, 1] * nrm[:, None, :, 1]
            + nrm[:, :, None, 2] * nrm[:, None, :, 2])
    return torch.where(eq, dots, 0.0)


def make_block_delassus_apply(setup: CollisionSetup, dual: torch.Tensor, dt,
                              mobility_i=None, mobility_j=None):
    """Delassus apply through the assembled per-block matrices (scalar
    mobility): u = blockdiag(M) gamma is the i-side half-apply (u_p = t_p
    of strided_t), the j-side the dual slot's value:
        (A gamma)_p = dt * (c_i u_p + c_j u_{dual(p)}).
    One batched matrix-vector product per iteration, in full precision: a
    float32 product on the card refuses TF32, whose ~2^-11 operator noise
    would sit at the BBPGD residual floor."""
    windows = setup.windows
    W, nb = windows.window, windows.nb
    n_slots = nb * W
    M = assemble_block_delassus(setup)
    if M.is_cuda and M.dtype == torch.float32 and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("the block Delassus product needs full float32: "
                           "torch.backends.cuda.matmul.allow_tf32 is on")
    ci, cj, dt = _scalar_mobilities(setup, dt, mobility_i, mobility_j)
    dual_c = torch.clamp(dual, max=n_slots - 1).to(torch.int64)

    def apply_A(gamma):
        g = torch.where(setup.pairs.mask, gamma, 0.0)
        u = torch.bmm(M, g.reshape(nb, W, 1)).reshape(n_slots)
        return dt * (ci * u + cj * u[dual_c])

    return apply_A


def assemble_band_delassus(setup: CollisionSetup, k_band: int) -> torch.Tensor:
    """(k_band-1, A) i-side Delassus band: band[d-1, p] = M[p, p+d] =
    (i_p == i_{p+d}) * (n_p . n_{p+d}). The active list is i-sorted, so each
    body's pairs are contiguous and M is nonzero only within |p - q| <
    k_band. Rolled-in slots are pads (zero normals) or another block's."""
    ids = setup.pairs.i
    nx, ny, nz = setup.normals.unbind(-1)
    rows = []
    for d in range(1, k_band):
        same = ids == torch.roll(ids, -d)
        dots = (nx * torch.roll(nx, -d) + ny * torch.roll(ny, -d)
                + nz * torch.roll(nz, -d))
        rows.append(torch.where(same, dots, 0.0))
    if not rows:
        return setup.normals.new_zeros((0, ids.shape[0]))
    return torch.stack(rows)


def make_band_delassus_apply(setup: CollisionSetup, dual: torch.Tensor, dt,
                             k_band: int, mobility_i=None, mobility_j=None):
    """Delassus apply via the banded i-side matrix (scalar mobility):
    u = M g as 2 (k_band-1) shifted multiply-adds (the diagonal is |n|^2 =
    1), the j-side the dual-slot gather:
        (A gamma)_p = dt * (c_i u_p + c_j u_{dual(p)})."""
    n_slots = setup.pairs.i.shape[0]
    band = assemble_band_delassus(setup, k_band)
    ci, cj, dt = _scalar_mobilities(setup, dt, mobility_i, mobility_j)
    dual_c = torch.clamp(dual, max=n_slots - 1).to(torch.int64)

    def apply_A(gamma):
        g = torch.where(setup.pairs.mask, gamma, 0.0)
        u = g
        for d in range(1, k_band):
            bd = band[d - 1]
            u = u + bd * torch.roll(g, -d) + torch.roll(bd * g, d)
        return dt * (ci * u + cj * u[dual_c])

    return apply_A


def resolve_collisions(setup: CollisionSetup,
                       mobility_apply: Callable[[torch.Tensor], torch.Tensor],
                       n_bodies: int, dt, max_allowable_overlap: float = 1e-5,
                       max_iterations: int = 10_000,
                       gamma0: Optional[torch.Tensor] = None,
                       u_ext: Optional[torch.Tensor] = None,
                       alpha0: Optional[torch.Tensor] = None,
                       apply_override: Optional[Callable] = None,
                       replicas=None
                       ) -> tuple[torch.Tensor, torch.Tensor, SolveResult]:
    """Solve for contact impulses gamma; returns (gamma, velocities, result).

    `u_ext` (n_bodies, 3): known velocities (Brownian drift) entering the
    constant term q = sep0 + dt D^T u_ext; the returned velocity is the
    constraint response M D gamma only. `apply_override` replaces the
    D^T M D chain with a fused Delassus apply; the final velocity still goes
    through `mobility_apply` once (`StkNgpLCP.cpp:705-875`). `replicas`:
    the ranks of a replicated solve (math/convex.PGDConfig.replicas)."""
    dt = torch.as_tensor(dt, dtype=setup.sep0.dtype, device=setup.sep0.device)
    if apply_override is not None:
        apply_A = apply_override
    else:
        def apply_A(gamma):
            u = mobility_apply(collision_forces(setup, gamma, n_bodies))
            return dt * _sep_rate(setup, u)
    q = setup.sep0
    if u_ext is not None:
        q = q + dt * _sep_rate(setup, u_ext)
    cfg = PGDConfig(max_iters=max_iterations, tol=max_allowable_overlap,
                    bb_rule="alternating", residual="projected_gradient", replicas=replicas)
    res = solve_lcp(apply_A, q, x0=gamma0, config=cfg, mask=setup.pairs.mask,
                    alpha0=alpha0)
    vel = mobility_apply(collision_forces(setup, res.x, n_bodies))
    return res.x, vel, res
