"""The least time a kernel could take on the card: its operations and bytes,
counted from what the data needs, over the published peaks.

Frozen here so that the yardstick does not move with the program: the
counts and constants are those of the repository's smoke script
(`chip_smoke.py`: `bound`, `stencil_work`, `contact_pairs`,
`cut_pairs_in_x`, `k2_bound`, the K1 operation counts, K3's bytes), with
the element size and the peak of the stated precision as parameters (their
values there are float32's). Every function takes plain tensors.
"""

from __future__ import annotations

import torch

# published H100 SXM peaks (NVIDIA data sheet, dense, at 700 W): FP32 and
# FP64 outside the tensor cores, and HBM3 bandwidth
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 34e12}
PEAK_BYTES = 3.35e12
# FP32 operations of K1, each unordered pair once with both sides' sums: a
# pair within the early stop's cut in x takes the x minimum image (5), two
# differences on the pre-shifted rows and r2 (7); one in contact the clamp,
# rsqrt and d (3), delta (2), w = coef delta sqrt(delta) / d (4) and both
# sums as 6 FMAs (12)
K1_PAIR_OPS = 12.0
K1_CONTACT_OPS = 21.0
# K1's early stop: r2 <= (2 r)^2 (1 + 2^-10), exact in both dtypes
K1_REACH_MARGIN = 1.0 + 2.0 ** -10


def bound(flops: float, nbytes: float, dtype=torch.float32) -> tuple:
    """(bound_ms, bound_by): the larger of the operation and byte times."""
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def stencil_work(valid) -> tuple:
    """(K1 pairs, K2 candidate distances) of this (ny, nz, R) row layout's
    occupancy: K1's half stencil takes each occupied pair once, occ (occ -
    1) / 2 in the own row plus occ x occ' with the rows (y, z+1), (y+1,
    z-1), (y+1, z), (y+1, z+1); K2 tests each occupied slot against every
    occupied slot of its 9 rows, itself included."""
    occ = valid.sum(-1).to(torch.float64)

    def at(dy, dz):
        return torch.roll(occ, (-dy, -dz), dims=(0, 1))

    half = at(0, 1) + at(1, -1) + at(1, 0) + at(1, 1)
    nine = sum(at(dy, dz) for dy in (-1, 0, 1) for dz in (-1, 0, 1))
    k1_pairs = (occ * half).sum() + (occ * (occ - 1) / 2).sum()
    return float(k1_pairs), float((occ * nine).sum())


def contact_pairs(pos, valid, box, radii) -> float:
    """Unordered pairs in contact on this row layout: over the 9-row
    stencil, the minimum image on every axis, d = r2 rsqrt(r2) < ro + rc,
    both slots valid; radii: the (ny, nz, R) radius plane. In y-slabs of
    ~5e7 pair entries."""
    L = torch.tensor(box, dtype=pos.dtype, device=pos.device)
    ny, nz, R = valid.shape
    not_self = ~torch.eye(R, dtype=torch.bool, device=pos.device)
    step = max(1, int(5e7 // (nz * R * R)))
    hits = 0
    for dy in (-1, 0, 1):
        for dz in (-1, 0, 1):
            cp, cv, cr = (torch.roll(t, (-dy, -dz), dims=(0, 1)) for t in (pos, valid, radii))
            for y0 in range(0, ny, step):
                s = slice(y0, y0 + step)
                d = cp[s][..., None, :, :] - pos[s][..., :, None, :]
                d = d - L * torch.round(d / L)
                r2 = torch.clamp((d * d).sum(-1), min=1e-24)
                hit = ((r2 * torch.rsqrt(r2) < radii[s][..., :, None] + cr[s][..., None, :])
                       & valid[s][..., :, None] & cv[s][..., None, :])
                if (dy, dz) == (0, 0):
                    hit = hit & not_self
                hits += int(hit.sum())
    return hits / 2


def cut_pairs_in_x(pos, valid, box, radii, reach) -> float:
    """Unordered pairs of valid slots whose x separation alone a kernel's
    cut keeps, reach(dx^2, own radius, candidate radius), over the 9-row
    stencil with the x minimum image. In y-slabs of ~5e7 pair entries."""
    ny, nz, R = valid.shape
    lx = float(box[0])
    not_self = ~torch.eye(R, dtype=torch.bool, device=pos.device)
    step = max(1, int(5e7 // (nz * R * R)))
    hits = 0
    for dy in (-1, 0, 1):
        for dz in (-1, 0, 1):
            cx, cv, cr = (torch.roll(t, (-dy, -dz), dims=(0, 1))
                          for t in (pos[..., 0], valid, radii))
            for y0 in range(0, ny, step):
                s = slice(y0, y0 + step)
                dx = cx[s][..., None, :] - pos[s][..., :, None, 0]
                dx = dx - lx * torch.round(dx / lx)
                hit = (reach(dx * dx, radii[s][..., :, None], cr[s][..., None, :])
                       & valid[s][..., :, None] & cv[s][..., None, :])
                if (dy, dz) == (0, 0):
                    hit = hit & not_self
                hits += int(hit.sum())
    return hits / 2


def k1_reach(radius: float):
    """K1's early stop as a reach function of cut_pairs_in_x."""
    def reach(dx2, ro, rc):
        two_r = torch.tensor(2.0 * radius, dtype=dx2.dtype, device=dx2.device)
        return dx2 <= two_r * two_r * K1_REACH_MARGIN
    return reach


def k1_bound(pos, valid, box, radius: float) -> tuple:
    """K1's bound on this row layout: (bound_ms, bound_by, flops, bytes).
    Occupied pairs within the early stop's cut in x at K1_PAIR_OPS, those
    in contact at K1_CONTACT_OPS more; valid read on every slot, the
    occupied slots' positions once, the forces of every slot written once."""
    isz = pos.element_size()
    radii = valid.to(pos.dtype) * radius
    in_x = cut_pairs_in_x(pos, valid, box, radii, k1_reach(radius))
    contacts = contact_pairs(pos, valid, box, radii)
    flops = in_x * K1_PAIR_OPS + contacts * K1_CONTACT_OPS
    nbytes = valid.numel() * (1 + 3 * isz) + int(valid.sum()) * 3 * isz
    return bound(flops, nbytes, pos.dtype) + (flops, nbytes)


def k2_bound(pos, valid, box, cutoff: float, K: int) -> tuple:
    """K2's bound on this row layout, (bound_ms, bound_by, ordered pairs
    within the cut in x): 13 operations per ordered pair of occupied slots
    within the cut in x (x image 5, dy and dz 2, r2 5, the cut test); bytes:
    the valid byte of every slot, the position and gid of each occupied
    slot read once, K ids and a count per slot written once."""
    isz = pos.element_size()
    n_slots = valid.numel()
    n_occ = int(valid.sum())
    cut2 = torch.tensor(cutoff * cutoff, dtype=pos.dtype, device=pos.device)
    plane = torch.zeros(valid.shape, dtype=pos.dtype, device=pos.device)
    pairs = 2 * cut_pairs_in_x(pos, valid, box, plane, lambda dx2, ro, rc: dx2 < cut2)
    out_bytes = n_slots * (K + 1) * 4
    b = bound(pairs * 13.0, n_slots + n_occ * (3 * isz + 4) + out_bytes, pos.dtype)
    return b + (pairs,)


def k3_bound(nb: int, W: int, B: int, n_active: int, isz: int = 4,
             dtype=torch.float32) -> tuple:
    """K3's bound at (nb blocks, window W, block B): 3 adds per active pair;
    the (nb, 3, W) values and (nb, W) int32 ids read once, the (nb, 3, B)
    sums written once."""
    return bound(3.0 * n_active, nb * 3 * W * isz + nb * W * 4 + nb * 3 * B * isz, dtype)


def row_layout(pos, box: float, cutoff: float, slack: float, align: int = 8) -> tuple:
    """(pos (ny, nz, R, 3), valid (ny, nz, R)) of the row grid that the rows
    broad phase sizes for `cutoff` and `slack` (rows of edge >= cutoff in y
    and z, ny and nz rounded down to `align`, R from the mean occupancy
    times the slack plus 8, rounded up to 8); bodies past a row's R are
    dropped, as the program drops them."""
    n = pos.shape[0]
    ny = max(int(box // cutoff), 1)
    if align > 1:
        ny = max((ny // align) * align, min(ny, align))
    nz = ny
    cap = int(-(-(n / (ny * nz) * slack + 8) // 1))
    cap = ((cap + 7) // 8) * 8
    cell = box / ny
    iy = torch.clamp(torch.floor(pos[:, 1] / cell).long(), 0, ny - 1)
    iz = torch.clamp(torch.floor(pos[:, 2] / cell).long(), 0, nz - 1)
    row = iy * nz + iz
    order = torch.argsort(row, stable=True)
    rs = row[order]
    counts = torch.bincount(rs, minlength=ny * nz)
    rank = torch.arange(n, device=pos.device) - (torch.cumsum(counts, 0) - counts)[rs]
    keep = rank < cap
    slot = rs[keep] * cap + rank[keep]
    out = torch.zeros((ny * nz * cap, 3), dtype=pos.dtype, device=pos.device)
    valid = torch.zeros(ny * nz * cap, dtype=torch.bool, device=pos.device)
    out[slot] = pos[order[keep]]
    valid[slot] = True
    return out.reshape(ny, nz, cap, 3), valid.reshape(ny, nz, cap)
