"""Slab-local row rebuild shared by the z-slab engines.

Port of mundy_tpu/parallel/slab_local.py. The skin trigger bounds each
displacement below one z-cell between rebuilds, so when a slab re-sorts its
rows, migrants can only come from its two boundary z-planes. Each rank packs
its out-of-slab particles into fixed-capacity buffers (one boundary plane's
worth each way), exchanges them with its ring neighbours by `ppermute`, and
re-sorts only its own (ny, nzl, R) block: O(ny R) bytes moved and an
O(N/d log N/d) sort per rank, against the O(N) psum and replicated sort of
the global resort. A row is the full x-column of one (y, z) cell, so its
members always live in one slab, and the local resort gives the global
resort's rows: the same gid, valid and slot order (two stable sorts, x then
row). Per-particle payload channels (the rods' quaternions) migrate with
their particles through `extras`.
"""

from __future__ import annotations

import torch

from mundy_tpu_torch.neighbor.rows import RowGrid, _row_coords
from mundy_tpu_torch.parallel.comm import Group, ring_perms


def local_resort_ok(d: int, nzl: int) -> bool:
    """The local resort needs >= 2 planes per slab (the left-migrant plane
    z0 - 1 and the right-migrant plane z0 + nzl must be distinct cells) and
    a real ring (d >= 2)."""
    return d >= 2 and nzl >= 2


def _pack(mask, pay, g, default, M):
    """The rows of `pay`/`g` where `mask`, packed in order into M slots (the
    rest `default`, gid 0, invalid); and whether more than M wanted in."""
    idx = torch.cumsum(mask.to(torch.int64), 0) - 1
    idx = torch.where(mask, idx, M).clamp(max=M)  # past M: the dump slot
    bp = default.expand(M + 1, -1).clone()
    bp[idx] = pay
    bg = torch.zeros(M + 1, dtype=torch.int32, device=pay.device)
    bg[idx] = g
    bv = torch.zeros(M + 1, dtype=torch.bool, device=pay.device)
    bv[idx] = mask
    return bp[:M], bg[:M], bv[:M], mask.sum() > M


def slab_local_resort(group: Group, pos, valid, gid, grid: RowGrid, nzl: int,
                      extras=(), extra_fill=None, ovf=None):
    """Re-sort this rank's (ny, nzl, R) slab block locally.

    pos: (ny, nzl, R, 3); valid: (ny, nzl, R) bool; gid: (ny, nzl, R) int32.
    extras: (ny, nzl, R, C) float tensors that migrate with their particles;
    `extra_fill` optionally gives each a (C,) fill for invalid slots (the
    identity quaternion: a zero one would NaN a normalization). Returns
    (pos, valid, gid, extras, ovf), ovf OR'd with a migrant buffer's
    overflow, a row's capacity overflow, and any particle that moved more
    than one plane since the trigger (which would otherwise vanish)."""
    d, me = group.size, group.rank
    ny, _nzl, R = valid.shape
    nz = grid.nz
    dtype, dev = pos.dtype, pos.device
    if ovf is None:
        ovf = torch.zeros((), dtype=torch.bool, device=dev)
    up, dn = ring_perms(d)
    n_rows_loc = ny * nzl
    n_loc = n_rows_loc * R
    M = ny * R  # migrant capacity: one full boundary plane each way
    sentinel_y = (grid.origin[1] - 1e6 * (grid.cell_yz[0] * ny + 1.0)).to(dtype)

    # payload = [pos | extras], one (n_loc, 3 + sum C) matrix, so packing,
    # ppermute and the final scatter each run once
    cols = [pos.reshape(n_loc, 3)]
    widths = []
    for e in extras:
        c = e.numel() // n_loc
        widths.append(c)
        cols.append(e.reshape(n_loc, c).to(dtype))
    pay = torch.cat(cols, dim=1) if len(cols) > 1 else cols[0]
    W = pay.shape[1]
    v = valid.reshape(-1)
    g = gid.reshape(-1)

    # the row of an empty slot: the sentinel y and each extra's fill
    default = torch.zeros((1, W), dtype=dtype, device=dev)
    default[0, 1] = sentinel_y
    if extra_fill is not None:
        off = 3
        for c, fill in zip(widths, extra_fill):
            if fill is not None:
                default[0, off:off + c] = torch.as_tensor(fill, dtype=dtype,
                                                          device=dev).reshape(c)
            off += c

    z0 = me * nzl
    _, iz = _row_coords(grid, pay[:, :3])
    delta = torch.remainder(iz - z0, nz)
    go_l = v & (delta == nz - 1)
    go_r = v & (delta == nzl)
    lost = v & (delta > nzl) & (delta < nz - 1)
    ovf = ovf | lost.any()

    # left-bound migrants travel to me - 1, right-bound ones to me + 1
    lp, lg, lv, ovf_l = _pack(go_l, pay, g, default, M)
    rp, rg, rv, ovf_r = _pack(go_r, pay, g, default, M)
    lp, lg, lv = _exchange(group, lp, lg, lv, dn)
    rp, rg, rv = _exchange(group, rp, rg, rv, up)

    cp = torch.cat([pay, lp, rp])
    cg = torch.cat([g, lg, rg])
    cv = torch.cat([v & (delta < nzl), lv, rv])
    ciy, ciz = _row_coords(grid, cp[:, :3])
    cdelta = torch.remainder(ciz - z0, nz)
    stray = cv & (cdelta >= nzl)  # moved more than one plane: flag it
    cv = cv & (cdelta < nzl)
    row = torch.where(cv, ciy * nzl + cdelta, n_rows_loc)

    m = row.shape[0]
    order_x = torch.argsort(cp[:, 0], stable=True)
    order = order_x[torch.argsort(row[order_x], stable=True)]
    row_s = row[order]
    first = torch.ones(m, dtype=torch.bool, device=dev)
    first[1:] = row_s[1:] != row_s[:-1]
    ar = torch.arange(m, device=dev)
    rank = ar - torch.cummax(torch.where(first, ar, 0), dim=0).values
    counts = torch.zeros(n_rows_loc + 1, dtype=torch.int32, device=dev)
    counts.index_add_(0, row, cv.to(torch.int32))
    ovf = ovf | ovf_l | ovf_r | (counts[:n_rows_loc] > R).any() | stray.any()

    keep = (rank < R) & (row_s < n_rows_loc)
    slot = torch.where(keep, row_s * R + torch.clamp(rank, max=R - 1), n_loc)
    fp = default.expand(n_loc + 1, -1).clone()
    fp[slot] = cp[order]
    fg = torch.zeros(n_loc + 1, dtype=torch.int32, device=dev)
    fg[slot] = cg[order]
    fv = torch.zeros(n_loc + 1, dtype=torch.bool, device=dev)
    fv[slot] = cv[order]

    new_pos = fp[:n_loc, :3].reshape(ny, nzl, R, 3)
    new_extras = []
    off = 3
    for e, c in zip(extras, widths):
        new_extras.append(fp[:n_loc, off:off + c].reshape(ny, nzl, R, c).to(e.dtype))
        off += c
    return (new_pos, fv[:n_loc].reshape(ny, nzl, R), fg[:n_loc].reshape(ny, nzl, R),
            tuple(new_extras), ovf)


def _exchange(group: Group, p, g, v, perm):
    """ppermute a packed migrant buffer: its payload with the valid flag as
    one more column, then its int32 gids, so no id is rounded."""
    msg = torch.cat([p, v.to(p.dtype)[:, None]], dim=1)
    msg = group.ppermute(msg, perm)
    g = group.ppermute(g, perm)
    return msg[:, :-1], g, msg[:, -1] > 0.5
