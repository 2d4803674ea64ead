"""Sharded LCP spheres on volume-allocated dense rows (superseded).

Port of mundy_tpu/parallel/slab_lcp.py over the ranks of a Group (one
process per rank). The production sharded LCP engine is
parallel/balanced_lcp.py, which `--devices` routes lcp_spheres onto; this
engine is the reference's bit-parity check of the dense-row pair
extraction, kept as it is there.

Bodies live in the z-slab row layout of parallel/slab_rows.py: rank r holds
the (ny, nzl, R) rows of planes r nzl .. (r + 1) nzl - 1, and one boundary
z-plane comes from each ring neighbour by `ppermute` (positions with the
global z-wrap shift on the box's edge ranks, velocities without).
- At a rebuild each rank extracts its own ordered pair list: every contact
  of an owned body i is one (i_slot, j_ext_slot) row, duplicated in both
  directions across the pair (and across ranks for a pair that straddles a
  slab face), so force assembly is one sorted segmented sum
  (ops/segments.segment_sum_sorted_blocked, kernel K3 on the card). The
  candidate distances are taken over the 9-row stencil in chunks of y rows,
  so no temporary holds the whole (ny, nzl, R, 9R) plane; rows compact
  independently, so the chunks give the unchunked candidate order.
- BBPGD is math/convex.py with `PGDConfig(group=...)`: the inner products
  are psums and the residual a pmax, so every rank takes the same step and
  leaves on the same iteration. Each iteration assembles F = D gamma for the
  owned bodies, applies the local drag, exchanges one boundary plane of
  velocities each way and evaluates the separation rate against own and
  halo velocities.
- The Brownian drift (gid-keyed) enters the LCP's constant term, so the
  solve enforces non-penetration of the end-of-step positions.

Every block starts with a rebuild, and a skin trigger (the pmax of the
largest squared displacement) rebuilds within it: "local" through
slab_local.slab_local_resort (the default where legal), "global" through a
psum of the flat (N, 3) positions and build_rows on every rank. Gamma
warm-starts from step to step and restarts at zero at each rebuild. As in
the reference, a block counts its steps from 0 for the noise.
"""

from __future__ import annotations

import math as _math
from typing import Optional

import numpy as np
import torch

from mundy_tpu_torch.dynamics.brownian import brownian_velocity_keyed
from mundy_tpu_torch.math.convex import PGDConfig, solve_lcp
from mundy_tpu_torch.neighbor.cell_list import _compact_rows
from mundy_tpu_torch.neighbor.rows import _roll_image_shift, build_rows, make_row_grid
from mundy_tpu_torch.ops.segments import SegmentWindows, segment_sum_sorted_blocked
from mundy_tpu_torch.parallel.comm import Group
from mundy_tpu_torch.parallel.sharded_step import _pos_or_draw
from mundy_tpu_torch.parallel.slab_local import slab_local_resort
from mundy_tpu_torch.parallel.slab_rows import (
    flat_by_gid,
    halo_planes,
    resolve_rebuild_mode,
    run_block,
    slab_grid,
)

# candidate distance entries per y-chunk of a rebuild's pair extraction
CHUNK_ENTRIES = 1 << 25


def _ext_slot_planes(ny: int, nzl: int, R: int) -> np.ndarray:
    """(ny, nzl, 9R) int32: the flat index into the halo-extended
    (ny, nzl + 2, R) block of each candidate lane of each own slot."""
    y = np.arange(ny)[:, None, None]
    z = np.arange(nzl)[None, :, None]
    r = np.arange(R)[None, None, :]
    planes = []
    for dy in (-1, 0, 1):
        for dz in (-1, 0, 1):
            yy = (y + dy) % ny
            zz = z + 1 + dz  # ext z index
            planes.append(np.broadcast_to(yy * (nzl + 2) * R + zz * R + r, (ny, nzl, R)))
    return np.concatenate(planes, axis=-1).astype(np.int32)


def make_slab_lcp_spheres_step(group: Group, n_total: int, box_size: float,
                               radius: float = 0.5, viscosity: float = 1.0,
                               diffusion: float = 0.0, dt: float = 1e-3,
                               constraint_buffer: float = 0.2,
                               max_allowable_overlap: float = 1e-5,
                               max_col_iterations: int = 10_000,
                               max_pairs_per_body: int = 12,
                               pair_capacity_per_body: int = 4,
                               capacity_slack: float = 1.9, seg_block: int = 512,
                               dtype=torch.float32, rebuild_mode: str = "auto"):
    """The engine on this rank of `group` (its device). Returns (init_fn,
    step_block_fn, grid):

    init_fn(key_words, pos=None) -> this rank's state dict, from the given
    (N, 3) positions (every rank the same) or N drawn uniformly in the box
    from a torch.Generator seeded with the key's second word; key_words are
    the noise stream's two key words. step_block_fn(state, n_steps) ->
    state after n_steps steps. The state carries this rank's rows (pos,
    valid, gid, ref_pos), gamma, `lcp_iters` (the last solve's iterations)
    and `iters` (this block's, per step), `rebuilds`, the rebuild `mode`
    and `overflow`, reduced over the ranks at the end of a block; after a
    step, the pair list of the last rebuild (ii, jj, pmask and the K3
    `windows` of ii)."""
    d, me, dev = group.size, group.rank, group.device
    L = float(box_size)
    cutoff = 2.0 * radius + constraint_buffer
    grid = make_row_grid([0, 0, 0], [L] * 3, cutoff, n_total, capacity_slack=capacity_slack,
                         dtype=dtype, device=dev)
    nz = (grid.nz // d) * d
    if nz < d or grid.ny < 5 or nz < 5:
        raise ValueError("box too small for the slab row engine "
                         f"(ny={grid.ny}, nz={nz}, d={d})")
    grid = slab_grid(grid, d, L)
    nzl, R, ny = nz // d, grid.row_capacity, grid.ny
    n_slots = ny * nzl * R  # own slots per rank
    K = max_pairs_per_body
    # ordered pair capacity per rank (each contact appears once per side)
    C = pair_capacity_per_body * max(n_total // d, 1)
    C = ((C + 1023) // 1024) * 1024
    seg_window = ((seg_block * max(K // 2, 2) + 511) // 512) * 512
    nb = -(-n_slots // seg_block)
    inv_drag = 1.0 / (6.0 * _math.pi * viscosity * radius)
    two_r, cut2 = 2.0 * radius, cutoff * cutoff
    rebuild_mode = resolve_rebuild_mode(rebuild_mode, d, nzl, nz)
    z0 = me * nzl
    dt_t = torch.tensor(dt, dtype=dtype, device=dev)
    ext_slots = torch.as_tensor(_ext_slot_planes(ny, nzl, R), device=dev)
    own_ext = (torch.arange(ny, device=dev)[:, None, None] * (nzl + 2) * R
               + (torch.arange(nzl, device=dev)[None, :, None] + 1) * R
               + torch.arange(R, device=dev)[None, None, :]).to(torch.int32)
    y_shift = {dy: _roll_image_shift(ny, dy, L, dtype, dev)[:, None, None] for dy in (-1, 1)}
    y_chunk = max(1, CHUNK_ENTRIES // (nzl * R * 9 * R))
    gids = torch.arange(n_total, dtype=torch.int32, device=dev)
    cfg = PGDConfig(max_iters=max_col_iterations, tol=max_allowable_overlap,
                    bb_rule="alternating", residual="projected_gradient", group=group)
    no_ovf = torch.zeros((), dtype=torch.bool, device=dev)

    def halo_ext(p, shift: bool):
        """(ny, nzl, R, ...) -> (ny, nzl + 2, R, ...): one boundary plane
        from each ring neighbour, z-wrap shifted where `shift`."""
        lo, hi = halo_planes(group, p, L, shift)
        return torch.cat([lo, p, hi], dim=1)

    def _min_image(sep):
        """3-axis minimum image (the z-halo already carries the wrap, so
        its term is the identity; x spans the box and y wraps across the
        rolled rows)."""
        return sep - L * torch.round(sep * (1.0 / L))

    def _candidate_planes(pos_ext):
        """(cx, cy, cz), each (ny, nzl, 9R): the 9-stencil candidates of
        every own row (y by rolls with the image shift, z by ext slices)."""
        cs = ([], [], [])
        for dy in (-1, 0, 1):
            for dz in (-1, 0, 1):
                c = pos_ext[:, 1 + dz:1 + dz + nzl]
                if dy != 0:
                    c = torch.roll(c, -dy, dims=0)
                for a in range(3):
                    cs[a].append(c[..., a] + y_shift[dy] if (a == 1 and dy != 0) else c[..., a])
        return tuple(torch.cat(ca, dim=-1) for ca in cs)

    def _first_k(pos, valid, planes):
        """(idx_k (n_slots, K) ext slots, count (n_slots,)): each own slot's
        first K hits in candidate order, over chunks of y rows."""
        cx, cy, cz = planes
        idx_parts, count_parts = [], []
        for y0 in range(0, ny, y_chunk):
            s = slice(y0, y0 + y_chunk)
            o = pos[s]
            dx = cx[s][..., None, :] - o[..., 0, None]
            dx = dx - L * torch.round(dx * (1.0 / L))
            dy = cy[s][..., None, :] - o[..., 1, None]
            dz = cz[s][..., None, :] - o[..., 2, None]
            r2 = dx * dx + dy * dy + dz * dz  # (yc, nzl, R, 9R)
            is_self = ext_slots[s][..., None, :] == own_ext[s][..., None]
            hit = (r2 < cut2) & valid[s][..., None] & ~is_self
            n_c = hit.shape[0] * nzl * R
            cand = ext_slots[s][..., None, :].expand(hit.shape).reshape(n_c, 9 * R)
            idx_k, _, count = _compact_rows(cand, hit.reshape(n_c, 9 * R), K, -1)
            idx_parts.append(idx_k)
            count_parts.append(count)
        return torch.cat(idx_parts), torch.cat(count_parts)

    def build_pairs(pos, valid):
        """This rank's ordered pair list from its rows: (ii (C,) own slot,
        ascending; jj (C,) halo-extended slot; pair mask; the seg_block
        windows of ii (SegmentWindows); overflow)."""
        idx_k, count = _first_k(pos, valid, _candidate_planes(halo_ext(pos, True)))
        k_overflow = (count > K).any()
        cnt = torch.clamp(count, max=K).to(torch.int64)
        base = torch.cat([cnt.new_zeros(1), torch.cumsum(cnt, 0)])
        num = int(base[n_slots])
        # jnp.repeat(..., total_repeat_length=C): cut past C, pad to C (the
        # pads are masked below)
        m = min(num, C)
        ii = torch.full((C,), n_slots, dtype=torch.int64, device=dev)
        ii[:m] = torch.repeat_interleave(torch.arange(n_slots, device=dev), cnt,
                                         output_size=num)[:m]
        pos_in = torch.arange(C, device=dev)
        pvalid = pos_in < num
        ii_safe = torch.clamp(ii, max=n_slots - 1)
        lane = torch.where(pvalid, pos_in - base[ii_safe], 0)
        jj = torch.where(pvalid, idx_k[ii_safe, lane].to(torch.int64), 0).clamp(min=0)
        edges = torch.clamp(torch.arange(0, nb * seg_block + 1, seg_block, device=dev),
                            max=n_slots)
        bounds = torch.searchsorted(ii, edges)
        overflow = (k_overflow | (num > C)
                    | ((bounds[1:] - bounds[:-1]) > seg_window).any())
        windows = SegmentWindows(starts=bounds[:-1].to(torch.int32), block_bodies=seg_block,
                                 window=seg_window, overflow=no_ovf)
        return ii.to(torch.int32), jj, pvalid, windows, overflow

    def inner_step(state):
        pos, valid = state["pos"], state["valid"]
        ii, jj, pmask = state["ii"], state["jj"], state["pmask"]
        i_safe = torch.clamp(ii, max=n_slots - 1).to(torch.int64)
        pos_l = pos.reshape(-1, 3)
        # separations and normals of the (skin-buffered) pairs, current positions
        sep = _min_image(halo_ext(pos, True).reshape(-1, 3)[jj] - pos_l[i_safe])
        dist = torch.sqrt(torch.clamp((sep * sep).sum(-1), min=1e-24))
        normals = sep / dist[:, None]
        q = dist - two_r
        def forces_of(g):
            gn = torch.where(pmask, g, 0.0)[:, None] * normals
            return segment_sum_sorted_blocked(-gn, ii, n_slots, state["windows"])

        def rate(u):
            """The separation rates -n . (u_i - u_j) of (n_slots, 3) u."""
            u_ext = halo_ext(u.reshape(ny, nzl, R, 3), False).reshape(-1, 3)
            return -(normals * (u[i_safe] - u_ext[jj])).sum(-1)

        def apply_A(g):
            return dt_t * rate(inv_drag * forces_of(g))

        u_b = None
        if diffusion > 0:
            bz = brownian_velocity_keyed(state["key"], state["step"], state["gid"], diffusion,
                                         dt, dtype=dtype).reshape(-1, 3)
            u_b = torch.where(valid.reshape(-1)[:, None], bz, 0.0)
            q = q + dt_t * rate(u_b)
        res = solve_lcp(apply_A, q, x0=state["gamma"], config=cfg, mask=pmask)
        vel = inv_drag * forces_of(res.x)
        if u_b is not None:
            vel = vel + u_b
        new_pos = pos_l + dt_t * vel
        new_pos = new_pos - L * torch.floor(new_pos * (1.0 / L))
        new_pos = torch.where(valid.reshape(-1)[:, None], new_pos, pos_l).reshape(pos.shape)
        return {**state, "pos": new_pos, "gamma": res.x, "lcp_iters": res.num_iters,
                "iters": state["iters"] + [res.num_iters], "step": state["step"] + 1}

    def moved(state) -> bool:
        disp = _min_image(state["pos"] - state["ref_pos"])
        d2 = torch.where(state["valid"], (disp * disp).sum(-1), 0.0)
        return bool(group.pmax(d2.max().reshape(1))[0] > (0.5 * constraint_buffer) ** 2)

    def rebuild(state):
        pos, valid, gid = state["pos"], state["valid"], state["gid"]
        if rebuild_mode == "local":
            pos, valid, gid, _, rovf = slab_local_resort(group, pos, valid, gid, grid, nzl)
        else:
            rows = build_rows(flat_by_gid(group, pos, valid, gid, n_total), gids, grid)
            pos, valid, gid = (t[:, z0:z0 + nzl].contiguous()
                               for t in (rows.pos, rows.valid, rows.gid))
            rovf = rows.overflow
        ii, jj, pmask, windows, povf = build_pairs(pos, valid)
        return {**state, "pos": pos, "valid": valid, "gid": gid, "ref_pos": pos,
                "gamma": torch.zeros((C,), dtype=dtype, device=dev), "ii": ii, "jj": jj,
                "pmask": pmask, "windows": windows,
                "overflow": state["overflow"] | rovf | povf, "rebuilds": state["rebuilds"] + 1}

    def init_fn(key_words, pos: Optional[torch.Tensor] = None) -> dict:
        rows = build_rows(_pos_or_draw(key_words, pos, n_total, L, dtype, dev), gids, grid)
        p, v, g = (t[:, z0:z0 + nzl].contiguous() for t in (rows.pos, rows.valid, rows.gid))
        return {"pos": p, "valid": v, "gid": g, "ref_pos": p,
                "gamma": torch.zeros((C,), dtype=dtype, device=dev), "lcp_iters": 0,
                "iters": [], "overflow": rows.overflow, "key": tuple(int(k) for k in key_words),
                "step": 0, "rebuilds": 0, "mode": rebuild_mode}

    def step_block_fn(state: dict, n_steps: int) -> dict:
        # the reference counts a block's steps from 0 (its noise step)
        state = run_block({**state, "step": 0, "iters": []}, n_steps, rebuild, inner_step,
                          moved)
        ovf = group.pmax(state["overflow"].reshape(1).to(torch.int32))[0] > 0
        return {**state, "overflow": ovf}

    return init_fn, step_block_fn, grid
