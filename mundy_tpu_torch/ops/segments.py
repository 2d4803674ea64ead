"""Blocked segmented reductions for sorted ids: the force assembly of the
LCP collision path.

Port of mundy_tpu/ops/segments.py. Bodies are partitioned into blocks of
B; each block's pairs occupy one window of at most W slots. The
rebuild-time SegmentWindows find each block's window in the sorted pair
list (its start and whether it overflows W); the per-step StridedWindows
put block b's pairs at the static slots [b*W, b*W + count_b), which is the
layout kernels K3 and K3t (ops/kernels/seg_onehot.py) reduce.
`segment_sum_sorted_blocked` reduces the windowed layout through K3 too:
it gathers each block's window into the strided shape first.

The reference's bf16 hi/mid/lo split existed to carry the f32 mantissa
through the TPU's MXU; here every sum is taken directly in the working
dtype.

ref: the force-assembly primitive of the LCP collision path
(`scrap/lcp_spheres/StkNgpLCP.cpp:578` sum_collision_force).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from mundy_tpu_torch.ops.kernels.seg_onehot import (strided_onehot_segment_sum,
                                                    strided_onehot_t)


class SegmentWindows(NamedTuple):
    """Rebuild-time block structure for sorted-id segmented reductions.

    starts: (nb,) int32, first row of each B-body block's window.
    overflow: any block holds > W rows (the host regrows W and rebuilds)."""

    starts: torch.Tensor
    block_bodies: int  # B
    window: int  # W
    overflow: torch.Tensor


def segment_windows(ids: torch.Tensor, n_segments: int, block_bodies: int,
                    window: int, body_starts: Optional[torch.Tensor] = None
                    ) -> SegmentWindows:
    """Block windows for sorted `ids` (padded tail >= n_segments).

    `body_starts` ((n_segments+1,) exclusive-cumulative per-body counts, e.g.
    body_pair_starts on the neighbor matrix the list came from) replaces the
    search with one (nb+1,)-row gather."""
    B, W = block_bodies, window
    nb = -(-n_segments // B)
    dev = ids.device
    # pads carry id == n_segments: clip the edges so the trailing pad run
    # never counts into the last block's occupancy
    edges = torch.clamp(torch.arange(0, nb * B + 1, B, device=dev), max=n_segments)
    if body_starts is not None:
        bounds = torch.clamp(body_starts[edges], max=ids.shape[0]).to(torch.int32)
    else:
        bounds = torch.searchsorted(ids, edges.to(ids.dtype)).to(torch.int32)
    counts = bounds[1:] - bounds[:-1]
    return SegmentWindows(starts=bounds[:-1], block_bodies=B, window=W,
                          overflow=(counts > W).any())


class StridedWindows(NamedTuple):
    """Static-offset block structure: pairs of segment block b occupy slots
    [b*W, b*W + count_b) (constraints/collision.active_pair_subset_strided)."""

    block_bodies: int  # B
    window: int  # W
    nb: int
    overflow: torch.Tensor  # any block's active count exceeded W


def segment_sum_strided(values: torch.Tensor, ids: torch.Tensor, n_segments: int,
                        windows: StridedWindows) -> torch.Tensor:
    """Strided-layout segmented reduction -> (n_segments, D).

    values (nb*W, D); ids (nb*W,) int32 segment ids, block b's slots holding
    ids in [b*B, (b+1)*B) (pads carry ids outside, which are dropped).
    Runs kernel K3 on (nb, D, W) value planes. Each segment is summed over
    its slots in slot order, whatever the order of the ids; where a block's
    ids are nondecreasing (active_pair_subset_strided's layout, pads of id
    N last) K3 sums each segment's run of slots directly."""
    B, W, nb = windows.block_bodies, windows.window, windows.nb
    D = values.shape[1]
    blk = torch.arange(nb, dtype=torch.int32, device=ids.device)[:, None] * B
    loc = (ids.reshape(nb, W) - blk).contiguous()
    v = values.reshape(nb, W, D).transpose(1, 2).contiguous()
    out = strided_onehot_segment_sum(v, loc, B)
    return out.transpose(1, 2).reshape(nb * B, D)[:n_segments]


def strided_t(gamma: torch.Tensor, normals: torch.Tensor, ids: torch.Tensor,
              windows: StridedWindows) -> torch.Tensor:
    """Fused i-side Delassus half-apply on the strided layout -> (nb*W,).

    t_p = -n_p . F_{i(p)} with F the strided assembly of -gamma n: gamma
    (nb*W,) multipliers, zero on padded slots; normals (nb*W, 3); ids
    (nb*W,) int32 body ids, block b's slots holding ids in [b*B, (b+1)*B).
    Runs kernel K3t on (nb, W) and (nb, 3, W) planes; a slot whose id lies
    outside its block gets t = 0."""
    B, W, nb = windows.block_bodies, windows.window, windows.nb
    blk = torch.arange(nb, dtype=torch.int32, device=ids.device)[:, None] * B
    loc = (ids.reshape(nb, W) - blk).contiguous()
    n = normals.reshape(nb, W, 3).transpose(1, 2).contiguous()
    return strided_onehot_t(gamma.reshape(nb, W).contiguous(), n, loc, B).reshape(nb * W)


def sorted_blocked_planes(values: torch.Tensor, ids: torch.Tensor, n_segments: int,
                          windows: SegmentWindows) -> tuple:
    """K3's inputs of segment_sum_sorted_blocked: (planes, loc), the (nb, 3,
    W) value planes of each three columns of `values` (zero-padded to a
    multiple of 3) and the (nb, W) block-local ids, pads and rows past
    n_segments at the dropped id B."""
    B, W = windows.block_bodies, windows.window
    nb = windows.starts.shape[0]
    C, D = values.shape
    dev = values.device
    vpad = torch.cat([values, values.new_zeros((W, D))])
    ipad = torch.cat([ids.to(torch.int64),
                      torch.full((W,), nb * B + B, dtype=torch.int64, device=dev)])
    # a window starts at most C rows in (the reference's dynamic slice clamps so)
    rows = torch.clamp(windows.starts.to(torch.int64), 0, C)[:, None] + torch.arange(W, device=dev)
    # pads (ids >= n_segments) take the dropped id B: a last block that
    # reaches past n_segments would otherwise sum them into a cut segment
    idw = ipad[rows]
    loc = torch.where(idw < n_segments, idw - torch.arange(nb, device=dev)[:, None] * B,
                      B).to(torch.int32).contiguous()
    vw = vpad[rows]  # (nb, W, D)
    d3 = -(-D // 3) * 3
    if d3 != D:
        vw = torch.cat([vw, vw.new_zeros((nb, W, d3 - D))], dim=2)
    return [vw[:, :, c:c + 3].transpose(1, 2).contiguous() for c in range(0, d3, 3)], loc


def segment_sum_sorted_blocked(values: torch.Tensor, ids: torch.Tensor, n_segments: int,
                               windows: SegmentWindows) -> torch.Tensor:
    """sum over the rows with ids == s of values -> (n_segments, D).

    values (C, D), zero on padded rows; ids (C,) sorted ascending, pads
    carrying >= n_segments. Block b sums the W rows from windows.starts[b]
    whose ids fall in [b B, (b+1) B); rows beyond a block's window are
    dropped, as in the reference (callers check `windows.overflow` at
    rebuild). The windows are gathered into K3's strided (nb, 3, W) planes,
    three value columns at a time (sorted_blocked_planes), so every segment
    is summed in row order in full precision and two runs on the card are
    bit-equal (the reference's bf16 three-term split for the TPU's matrix
    unit is not carried over)."""
    B = windows.block_bodies
    planes, loc = sorted_blocked_planes(values, ids, n_segments, windows)
    nb, D = loc.shape[0], values.shape[1]
    out = torch.cat([strided_onehot_segment_sum(p, loc, B) for p in planes], dim=1)[:, :D]
    return out.transpose(1, 2).reshape(nb * B, D)[:n_segments]
