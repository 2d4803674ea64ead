"""Dense row-grid engine: gather-free neighbor interactions.

Port of the spheres path of mundy_tpu/neighbor/rows.py: the central-force
engine of config #1 (the half stencil of kernel K1 and the full stencil of
kernel K6's plain version) and the neighbor-matrix broad phase of config #2
(`neighbor_matrix_rows`, through kernel K2). Particles live in a
dense (ny, nz, R) row layout: a row is the full x extent of one (y, z) cell
column, padded to R slots and sorted by x. The neighbor candidates of a row
are the rows (y+dy, z+dz), reached by `torch.roll` with the periodic image
shift pre-applied, so a pair needs a minimum image along x only. Invalid
slots carry a sentinel position far outside the box and separate themselves
from every pair, so central-force kernels take no validity mask.

The layout is the reference's slot for slot: two stable sorts (x, then
row), the same sentinel and the same capacity rule. The only departure is
the out-of-capacity scatter: JAX drops the update for the overflow slot
index, torch indexing raises on it, so the scatters write into one extra
dump slot that is cut off afterwards (no host sync on the device path).
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from mundy_tpu_torch.core.containers import frozen_dataclass, static_field
from mundy_tpu_torch.geom.distance import segment_closest_planes
from mundy_tpu_torch.geom.periodicity import Metric


@frozen_dataclass
class RowGrid:
    """Static geometry of the (y, z) row decomposition."""

    origin: torch.Tensor  # (3,)
    cell_yz: torch.Tensor  # (2,) row cell edge along y, z
    ny: int = static_field(default=1)
    nz: int = static_field(default=1)
    row_capacity: int = static_field(default=32)


@frozen_dataclass
class RowState:
    """Dense row-layout particle state."""

    grid: RowGrid
    pos: torch.Tensor  # (ny, nz, R, 3)
    gid: torch.Tensor  # (ny, nz, R) int32 global ids (noise streams / unsort)
    valid: torch.Tensor  # (ny, nz, R) bool
    ref_pos: torch.Tensor  # (ny, nz, R, 3) positions at last rebuild
    overflow: torch.Tensor  # () bool


def make_row_grid(domain_low, domain_high, cutoff: float, n_particles: int,
                  capacity_slack: float = 2.0, dtype=torch.float32,
                  align: int = 1, device=None) -> RowGrid:
    """Rows sized so the y/z cell edge >= cutoff; capacity from the mean
    occupancy with slack (overflow flag + host regrow on violation).

    `align`: round ny/nz DOWN to a multiple of this (cells grow slightly past
    the cutoff, which stays correct). The CUDA kernel does not need it; the
    row engine keeps align=8 so its slot layouts match the reference's."""
    low = np.asarray(domain_low, np.float64)
    high = np.asarray(domain_high, np.float64)
    ext = high - low
    ny = max(int(ext[1] // cutoff), 1)
    nz = max(int(ext[2] // cutoff), 1)
    if align > 1:
        ny = max((ny // align) * align, min(ny, align))
        nz = max((nz // align) * align, min(nz, align))
    mean_occ = n_particles / (ny * nz)
    cap = int(np.ceil(mean_occ * capacity_slack + 8))
    cap = ((cap + 7) // 8) * 8
    return RowGrid(
        origin=torch.as_tensor(low, dtype=dtype, device=device),
        cell_yz=torch.as_tensor([ext[1] / ny, ext[2] / nz], dtype=dtype,
                                device=device),
        ny=ny, nz=nz, row_capacity=cap,
    )


def _row_coords(grid: RowGrid, pos: torch.Tensor):
    iy = torch.floor((pos[..., 1] - grid.origin[1]) / grid.cell_yz[0]).to(torch.int64)
    iz = torch.floor((pos[..., 2] - grid.origin[2]) / grid.cell_yz[1]).to(torch.int64)
    return iy.clamp(0, grid.ny - 1), iz.clamp(0, grid.nz - 1)


def build_rows(pos: torch.Tensor, gid: torch.Tensor, grid: RowGrid) -> RowState:
    """Flat (N, 3) positions -> dense row layout. Two stable sorts + one
    scatter; particles past a row's capacity are dropped and flag overflow."""
    n = pos.shape[0]
    R = grid.row_capacity
    n_slots = grid.ny * grid.nz * R
    dev = pos.device
    iy, iz = _row_coords(grid, pos)
    row = iy * grid.nz + iz
    # two-key sort (x within row): sort by x, then stable-sort by row
    order_x = torch.argsort(pos[:, 0], stable=True)
    order = order_x[torch.argsort(row[order_x], stable=True)]

    row_sorted = row[order]
    first = torch.ones(n, dtype=torch.bool, device=dev)
    first[1:] = row_sorted[1:] != row_sorted[:-1]
    ar = torch.arange(n, device=dev)
    row_start = torch.cummax(torch.where(first, ar, 0), dim=0).values
    rank = ar - row_start

    counts = torch.zeros(grid.ny * grid.nz, dtype=torch.int32, device=dev)
    counts.index_add_(0, row, torch.ones_like(row, dtype=torch.int32))
    overflow = (counts > R).any()

    # ranks past the capacity go to the dump slot n_slots (cut off below)
    slot = torch.where(rank < R, row_sorted * R + rank, n_slots)
    # Sentinel ~1e6 box heights below the box: any pair involving an invalid
    # slot is separated beyond every cutoff, and two sentinels of one row
    # coincide exactly (sep = 0), so neither contributes to a central force.
    extent_y = grid.cell_yz[0] * grid.ny
    sentinel_y = grid.origin[1] - 1e6 * (extent_y + 1.0)
    flat_pos = torch.zeros((n_slots + 1, 3), dtype=pos.dtype, device=dev)
    flat_pos[:, 1] = sentinel_y.to(pos.dtype)
    flat_pos[slot] = pos[order]
    flat_gid = torch.zeros(n_slots + 1, dtype=torch.int32, device=dev)
    flat_gid[slot] = gid[order].to(torch.int32)
    flat_valid = torch.zeros(n_slots + 1, dtype=torch.bool, device=dev)
    flat_valid[slot] = True

    shape = (grid.ny, grid.nz, R)
    p = flat_pos[:n_slots].reshape(shape + (3,))
    return RowState(grid=grid, pos=p, gid=flat_gid[:n_slots].reshape(shape),
                    valid=flat_valid[:n_slots].reshape(shape), ref_pos=p,
                    overflow=overflow)


def rows_to_flat(state: RowState, n: int) -> torch.Tensor:
    """Dense layout -> flat (N, 3) positions ordered by global id."""
    flat_pos = state.pos.reshape(-1, 3)
    idx = torch.where(state.valid.reshape(-1), state.gid.reshape(-1).to(torch.int64), n)
    out = torch.zeros((n + 1, 3), dtype=state.pos.dtype, device=state.pos.device)
    out[idx] = flat_pos
    return out[:n]


def orthorhombic_lengths(metric: Metric):
    """Static (Lx, Ly, Lz) + per-axis periodic flags from a diagonal metric,
    or None for a triclinic one. Call at sim construction time."""
    if not metric.diagonal:
        return None
    cell = metric.cell.cpu().numpy()
    per = metric.periodic.cpu().numpy()
    lengths = tuple(float(cell[i, i]) for i in range(3))
    flags = tuple(bool(per[i]) for i in range(3))
    return lengths, flags


def _roll_image_shift(n: int, d: int, L: float, dtype, device=None) -> torch.Tensor:
    """Per-index coordinate shift that turns a rolled candidate row into the
    periodic image nearest its partner row: roll(x, -d)[i] = x[(i+d) % n], so
    indices with i + d >= n (or < 0) wrapped and live one box away."""
    idx = np.arange(n)
    s = np.where(idx + d >= n, L, np.where(idx + d < 0, -L, 0.0))
    return torch.as_tensor(s, dtype=dtype, device=device)


# Half stencil for Newton's-third-law accumulation: these four offsets plus
# their negations cover all 8 neighbor rows, so each unordered row pair is
# evaluated exactly once (needs ny, nz >= 3; the >= 5 rule guarantees it).
_SYM_OFFSETS = ((0, 1), (1, -1), (1, 0), (1, 1))

# Byte budget for the pair-block temporaries of one y-slab of the plain
# half-stencil path: at 1M bodies one unchunked (R, 5R) block is 3.6 GB.
_PAIR_BUDGET_BYTES = 2.5e9


def _candidate_planes_half(pos: torch.Tensor, box: tuple):
    """Candidate component planes for the half stencil: (cx, cy, cz), each
    (ny, nz, 5R), the self row plus the 4 _SYM_OFFSETS rolled rows joined
    along the last axis, periodic y/z image shifts pre-applied."""
    ny, nz = pos.shape[:2]
    dtype, dev = pos.dtype, pos.device
    (lx, ly, lz), (px, py, pz) = box
    cand_x, cand_y, cand_z = [pos[..., 0]], [pos[..., 1]], [pos[..., 2]]
    for dy, dz in _SYM_OFFSETS:
        cp = torch.roll(pos, (-dy, -dz), dims=(0, 1))
        x, y, z = cp[..., 0], cp[..., 1], cp[..., 2]
        if dy != 0 and py:
            y = y + _roll_image_shift(ny, dy, ly, dtype, dev)[:, None, None]
        if dz != 0 and pz:
            z = z + _roll_image_shift(nz, dz, lz, dtype, dev)[None, :, None]
        cand_x.append(x)
        cand_y.append(y)
        cand_z.append(z)
    return (torch.cat(cand_x, dim=-1), torch.cat(cand_y, dim=-1),
            torch.cat(cand_z, dim=-1))


def _central_force_chunk_sym(ox, oy, oz, cx, cy_, cz, scalar_fn, lx_px, R):
    """Half-stencil pair force for one y-chunk.

    Returns (f_own (..., R, 3), f_par (..., 4R, 3)): f_own is the
    candidate-axis reduction over all 5R lanes; f_par is minus the own-axis
    reduction of the 4 off-row blocks (the Newton's-third-law partner force,
    still in the rolled candidate frame; the caller rolls it back)."""
    DX = cx[..., None, :] - ox[..., :, None]   # (chunk, nz, R, 5R)
    if lx_px is not None:
        lx, inv_lx = lx_px
        DX = DX - lx * torch.round(DX * inv_lx)  # one-component min image
    DY = cy_[..., None, :] - oy[..., :, None]
    DZ = cz[..., None, :] - oz[..., :, None]
    w = scalar_fn(DX * DX + DY * DY + DZ * DZ)
    WX, WY, WZ = w * DX, w * DY, w * DZ
    f_own = torch.stack([WX.sum(-1), WY.sum(-1), WZ.sum(-1)], dim=-1)
    f_par = -torch.stack([WX[..., R:].sum(-2), WY[..., R:].sum(-2),
                          WZ[..., R:].sum(-2)], dim=-1)
    return f_own, f_par


def pair_accumulate_central_sym(
    pos: torch.Tensor,
    box: tuple,
    scalar_fn: Callable[[torch.Tensor], torch.Tensor],
) -> torch.Tensor:
    """Half-stencil central pair forces f_i = sum_j w_ij * sep_ij on the row
    layout, with sep_ij = pos_j - pos_i (minimum image), w = scalar_fn(r2).

    pos: (ny, nz, R, 3) from build_rows. Contract as in the reference:
    scalar_fn vanishes beyond the grid cutoff (sentinel slots separate
    themselves, so no validity mask), is finite at r2 = 0 (self-pairs give
    w * 0 = 0), and is symmetric, because each off-row pair is evaluated
    once and the partner receives -w * sep. Needs a static orthorhombic
    `box` from orthorhombic_lengths with ny, nz >= 5 on periodic axes.

    The (R, 5R) pair blocks are evaluated in y-slabs whose temporaries stay
    within _PAIR_BUDGET_BYTES."""
    ny, nz, R = pos.shape[:3]
    (lx, ly, lz), (px, py, pz) = box
    if (py and ny < 5) or (pz and nz < 5):
        raise ValueError("pair_accumulate_central_sym needs ny,nz >= 5 on "
                         "periodic axes")
    cx, cy_, cz = _candidate_planes_half(pos, box)
    ox, oy, oz = pos[..., 0], pos[..., 1], pos[..., 2]
    lx_px = (lx, 1.0 / lx) if px else None

    # ~8 live (R, 5R) blocks per row
    bytes_per_row = 8 * nz * R * 5 * R * pos.element_size()
    chunk_y = max(min(int(_PAIR_BUDGET_BYTES // bytes_per_row), ny), 1)
    parts = [
        _central_force_chunk_sym(ox[s], oy[s], oz[s], cx[s], cy_[s], cz[s],
                                 scalar_fn, lx_px, R)
        for s in (slice(y0, y0 + chunk_y) for y0 in range(0, ny, chunk_y))
    ]
    f_own = torch.cat([p[0] for p in parts], dim=0)
    f_par = torch.cat([p[1] for p in parts], dim=0)

    # partner sums live in the rolled candidate frame: roll them back.
    # Wrapped rows saw image-shifted coordinates, but forces are translation
    # invariant so the shift needs no undoing.
    force = f_own
    for b, (dy, dz) in enumerate(_SYM_OFFSETS):
        force = force + torch.roll(f_par[..., b * R:(b + 1) * R, :], (dy, dz),
                                   dims=(0, 1))
    return force


def _candidate_planes(pos: torch.Tensor, box: tuple, extra_fields: tuple = ()):
    """Concatenated 9-row candidate component planes (cx, cy, cz, extras),
    each (ny, nz, 9R): the rolled rows (y+dy, z+dz) in (dy, dz) major order,
    periodic y/z image shifts pre-applied, so a pair needs a minimum image
    along x only."""
    ny, nz = pos.shape[:2]
    dtype, dev = pos.dtype, pos.device
    (_lx, ly, lz), (_px, py, pz) = box
    cand_x, cand_y, cand_z = [], [], []
    cand_extras = [[] for _ in extra_fields]
    for dy in (-1, 0, 1):
        for dz in (-1, 0, 1):
            if (dy, dz) == (0, 0):
                cp, ces = pos, extra_fields
            else:
                cp = torch.roll(pos, (-dy, -dz), dims=(0, 1))
                ces = tuple(torch.roll(f, (-dy, -dz), dims=(0, 1))
                            for f in extra_fields)
            x, y, z = cp[..., 0], cp[..., 1], cp[..., 2]
            if dy != 0 and py:
                y = y + _roll_image_shift(ny, dy, ly, dtype, dev)[:, None, None]
            if dz != 0 and pz:
                z = z + _roll_image_shift(nz, dz, lz, dtype, dev)[None, :, None]
            cand_x.append(x)
            cand_y.append(y)
            cand_z.append(z)
            for acc, f in zip(cand_extras, ces):
                acc.append(f)
    return (torch.cat(cand_x, dim=-1), torch.cat(cand_y, dim=-1),
            torch.cat(cand_z, dim=-1),
            tuple(torch.cat(a, dim=-1) for a in cand_extras))


def central_pair_terms(ox, oy, oz, own_extras, cx, cy_, cz, cand_extras,
                       scalar_fn, images):
    """The central pair arithmetic on component planes: own (..., R),
    candidates (..., 9R), every pair quantity a (..., R, 9R) plane.
    `images`: per axis (L, 1/L) for a minimum image, or None. Returns the
    separations (DX, DY, DZ), cand - own, their r2 and the weights w =
    scalar_fn(r2, own_extra, cand_extra, ...), unsummed."""
    seps = []
    for c, o, img in ((cx, ox, images[0]), (cy_, oy, images[1]), (cz, oz, images[2])):
        d = c[..., None, :] - o[..., :, None]
        if img is not None:
            d = d - img[0] * torch.round(d * img[1])
        seps.append(d)
    DX, DY, DZ = seps
    r2 = DX * DX + DY * DY + DZ * DZ
    args = [r2]
    for own_f, cand_f in zip(own_extras, cand_extras):
        args.append(own_f[..., :, None])
        args.append(cand_f[..., None, :])
    return DX, DY, DZ, r2, scalar_fn(*args)


def _central_force_chunk(*planes):
    """Central pair forces f_i = sum_j w * sep for one y-chunk:
    central_pair_terms on (chunk, nz, R) own and (chunk, nz, 9R) candidate
    planes, summed over the candidate axis."""
    DX, DY, DZ, _r2, w = central_pair_terms(*planes)
    return torch.stack([(w * DX).sum(-1), (w * DY).sum(-1), (w * DZ).sum(-1)], dim=-1)


def pair_accumulate_central(pos: torch.Tensor, box: tuple,
                            scalar_fn: Callable[..., torch.Tensor],
                            extra_fields: tuple = (),
                            hbm_budget_bytes: float = 2.5e9) -> torch.Tensor:
    """Full 9-row-stencil central pair forces f_i = sum_j w_ij * sep_ij on
    the row layout, sep_ij = pos_j - pos_i (minimum image), w =
    scalar_fn(r2, own_extra, cand_extra, ...) for each (ny, nz, R) field of
    `extra_fields` (a per-slot payload such as the mask or the radii).

    pos: (ny, nz, R, 3) from build_rows; scalar_fn vanishes beyond the grid
    cutoff, is finite at r2 = 0 (self-pairs give w * 0 = 0) and zeroes every
    pair with an invalid slot (take the mask as a payload). Every off-row
    pair is evaluated from both sides, so scalar_fn need not be symmetric.
    Needs a static orthorhombic `box` from orthorhombic_lengths with ny,
    nz >= 5 on periodic axes. The (R, 9R) pair blocks run in y-slabs whose
    ~8 live blocks stay within `hbm_budget_bytes`, as the reference sizes
    them.

    The reference takes the minimum image along x only, on candidate rows
    pre-shifted to the image nearest the own row; that misses the contacts
    of a particle that crossed a periodic y or z face since the last
    rebuild (its slot stays in its old row, its position wraps). This port
    takes the minimum image on every periodic axis, as kernel K6 does,
    which finds them. Elsewhere a pre-shifted separation spans at most two
    row cells (< L/2), so the added images round to zero and the forces are
    the reference's bit for bit. With every axis imaged a sentinel slot no
    longer separates itself, hence the mask."""
    ny, nz, R = pos.shape[:3]
    lengths, flags = box
    if (flags[1] and ny < 5) or (flags[2] and nz < 5):
        raise ValueError("pair_accumulate_central needs ny,nz >= 5 on "
                         "periodic axes; use pair_accumulate")
    cx, cy_, cz, cand_extras = _candidate_planes(pos, box, extra_fields)
    ox, oy, oz = pos[..., 0], pos[..., 1], pos[..., 2]
    images = tuple((L, 1.0 / L) if p else None for L, p in zip(lengths, flags))
    bytes_per_row = 8 * nz * R * 9 * R * pos.element_size()
    chunk_y = max(min(int(hbm_budget_bytes // bytes_per_row), ny), 1)
    return torch.cat([
        _central_force_chunk(ox[s], oy[s], oz[s], tuple(f[s] for f in extra_fields),
                             cx[s], cy_[s], cz[s], tuple(f[s] for f in cand_extras),
                             scalar_fn, images)
        for s in (slice(y0, y0 + chunk_y) for y0 in range(0, ny, chunk_y))])


def segment_pair_terms(ox, oy, oz, oex, oey, oez, own_scalars,
                       cx, cy_, cz, cex, cey, cez, cand_scalars,
                       out_fn, lx_px):
    """Clamped segment-segment closest points on component planes: own
    midpoints and half-edges (..., R), candidates (..., 9R), every per-pair
    quantity a (..., R, 9R) plane (geom/distance.segment_closest_planes,
    the reference's arithmetic). Returns the centre separations (sx, sy,
    sz), cand - own with the x minimum image when lx_px = (lx, 1/lx), and
    out_fn's per-pair planes, unsummed."""
    def o(p):  # own plane -> pair block
        return p[..., :, None]

    def k(p):  # cand plane -> pair block
        return p[..., None, :]

    SX = k(cx) - o(ox)
    if lx_px is not None:
        lx, inv_lx = lx_px
        SX = SX - lx * torch.round(SX * inv_lx)
    SY, SZ = k(cy_) - o(oy), k(cz) - o(oz)
    args = list(segment_closest_planes(SX, SY, SZ, o(oex), o(oey), o(oez),
                                       k(cex), k(cey), k(cez)))
    for own_f, cand_f in zip(own_scalars, cand_scalars):
        args.append(o(own_f))
        args.append(k(cand_f))
    return (SX, SY, SZ), out_fn(*args)


def _segment_pair_chunk(*planes):
    """segment_pair_terms for one y-chunk, (chunk, nz, R) own planes and
    (chunk, nz, 9R) candidates, its out_fn planes summed over the candidate
    axis."""
    return tuple(ov.sum(-1) for ov in segment_pair_terms(*planes)[1])


def pair_accumulate_segments(
    pos: torch.Tensor,
    box: tuple,
    half_edges: torch.Tensor,
    out_fn: Callable[..., tuple],
    extra_fields: tuple = (),
    hbm_budget_bytes: float = 2.5e9,
) -> tuple:
    """Segment-segment narrow phase on component planes over the full
    9-row stencil: the plain version of kernel K4.

    pos: (ny, nz, R, 3) segment midpoints from build_rows (sentinel invalid
    slots); half_edges: (ny, nz, R, 3) half-edge vectors, endpoints
    mid -/+ e. out_fn(s, t, dx, dy, dz, d2, own_extra, cand_extra, ...)
    receives (chunk, nz, R, 9R) planes: the clamped arc parameters in
    [0, 1], the closest vector (own -> cand), its squared norm (exactly 0
    below the coincident-pair noise floor) and each extra field's own and
    candidate planes. It returns a tuple of per-pair planes; each is summed
    over the candidate axis into (ny, nz, R). Outputs must vanish for pairs
    beyond the grid cutoff and for d2 == 0 (self pairs), as in the
    reference. Needs a static orthorhombic `box` with ny, nz >= 5 on
    periodic axes.

    The pair planes are evaluated in y-chunks sized so that ~28 live
    (R, 9R) planes per row stay within `hbm_budget_bytes`, as the
    reference sizes its chunks."""
    ny, nz, R = pos.shape[:3]
    (lx, ly, lz), (px, py, pz) = box
    if (py and ny < 5) or (pz and nz < 5):
        raise ValueError("pair_accumulate_segments needs ny,nz >= 5 on "
                         "periodic axes")
    ex, ey, ez = half_edges[..., 0], half_edges[..., 1], half_edges[..., 2]
    fields = (ex, ey, ez) + tuple(extra_fields)
    cx, cy_, cz, cand_f = _candidate_planes(pos, box, fields)
    cex, cey, cez = cand_f[:3]
    cand_scalars = cand_f[3:]
    ox, oy, oz = pos[..., 0], pos[..., 1], pos[..., 2]
    lx_px = (lx, 1.0 / lx) if px else None

    bytes_per_row = 28 * nz * R * 9 * R * pos.element_size()
    chunk_y = max(min(int(hbm_budget_bytes // bytes_per_row), ny), 1)
    parts = [
        _segment_pair_chunk(ox[s], oy[s], oz[s], ex[s], ey[s], ez[s],
                            tuple(f[s] for f in extra_fields),
                            cx[s], cy_[s], cz[s], cex[s], cey[s], cez[s],
                            tuple(f[s] for f in cand_scalars), out_fn, lx_px)
        for s in (slice(y0, y0 + chunk_y) for y0 in range(0, ny, chunk_y))
    ]
    return tuple(torch.cat(p, dim=0) for p in zip(*parts))


def _unsort_rows_to_gid(vals_flat: torch.Tensor, state: RowState, n: int) -> torch.Tensor:
    """(slots, K) per-row-slot values -> (N, K) in gid order, through the
    gid -> slot inverse permutation and one row gather. Bodies dropped by
    row overflow get the padded all-`n` row (the overflow flag covers
    them)."""
    slots, k = vals_flat.shape
    dev = vals_flat.device
    tgt = torch.where(state.valid.reshape(-1), state.gid.reshape(-1).to(torch.int64), n)
    slot_of = torch.full((n + 1,), slots, dtype=torch.int64, device=dev)
    slot_of[tgt] = torch.arange(slots, device=dev)  # index n is the dump
    vals_pad = torch.cat([vals_flat, vals_flat.new_full((1, k), n)])
    return vals_pad[slot_of[:n]]


def neighbor_matrix_rows(pos: torch.Tensor, search_radius: float, box_lengths,
                         periodic_axes=(True, True, True),
                         origin=(0.0, 0.0, 0.0), max_neighbors: int = 8,
                         capacity_slack: float = 1.9,
                         hbm_budget_bytes: float = 2.5e9,
                         grid: Optional[RowGrid] = None,
                         search_radii: Optional[torch.Tensor] = None):
    """NeighborMatrix built through the row layout, the fast broad phase.

    build_rows, then the K nearest in-cutoff neighbors of every row slot
    (kernel K2, ops/kernels/row_extract.py: distance-sorted, ties to the
    lower candidate lane), then the slot -> gid unsort. Pair cutoff is
    2 * search_radius or, with `search_radii` (N,) given, the per-pair
    s_i + s_j (neighbor_matrix's convention; K2's radius variant), and
    `search_radius` must then be max(search_radii): it sizes the row cells.
    Needs >= 5 cells per periodic y/z axis. Returns NeighborMatrix(idx
    (N, K) with N marking empty, mask, overflow)."""
    from mundy_tpu_torch.neighbor.cell_list import NeighborMatrix
    from mundy_tpu_torch.ops.kernels.row_extract import row_neighbor_extract

    n = pos.shape[0]
    dtype, dev = pos.dtype, pos.device
    cutoff = 2.0 * float(search_radius)
    lengths = tuple(float(v) for v in box_lengths)
    flags = tuple(bool(v) for v in periodic_axes)
    if grid is None:
        low = np.asarray(origin, np.float64)
        grid = make_row_grid(low, low + np.asarray(lengths, np.float64), cutoff, n,
                             capacity_slack=capacity_slack, dtype=dtype, align=8,
                             device=dev)
    if (flags[1] and grid.ny < 5) or (flags[2] and grid.nz < 5):
        raise ValueError("neighbor_matrix_rows needs >=5 cells per periodic "
                         "y/z axis; use neighbor_matrix")
    # wrap periodic axes into the primary cell: build_rows clamps y/z cell
    # coordinates, so an out-of-box position would land in an edge row the
    # partner's 9-row stencil never scans
    orig = torch.as_tensor(grid.origin, dtype=dtype, device=dev)
    L = torch.as_tensor(lengths, dtype=dtype, device=dev)
    wrapped = orig + torch.remainder(pos - orig, L)
    pos = torch.where(torch.as_tensor(flags, device=dev), wrapped, pos)
    state = build_rows(pos, torch.arange(n, dtype=torch.int32, device=dev), grid)
    sr_rows = None
    if search_radii is not None:
        sr = torch.as_tensor(search_radii, dtype=dtype, device=dev)
        sr_rows = torch.where(state.valid,
                              sr[torch.clamp(state.gid, max=n - 1).long()], 0.0)
    ids, count = row_neighbor_extract(state.pos, state.gid, state.valid,
                                      (lengths, flags), cutoff, max_neighbors, n,
                                      hbm_budget_bytes=hbm_budget_bytes, radii=sr_rows)
    idx = _unsort_rows_to_gid(ids.reshape(-1, max_neighbors), state, n)
    return NeighborMatrix(idx=idx, mask=idx < n,
                          overflow=state.overflow | (count > max_neighbors).any())


def rows_extract_feasible(grid: RowGrid, max_neighbors: int, itemsize: int = 4,
                          hbm_budget_bytes: float = 2.5e9) -> bool:
    """True when neighbor_matrix_rows can extract at this grid's shape on
    the grid's device. False means the distribution is too clustered for the
    row layout (R integrates clustering over the full x axis); callers then
    use the cell-list builder, whose 3D cells bound occupancy locally.

    On the card: K2 launches at this shape (ops/kernels/row_extract.fits:
    K within its top-K list, its 9 staged rows within the card's opt-in
    shared memory per block). This test takes the place of the reference's
    TPU VMEM envelope (row_extract_vmem_ok). Elsewhere: the reference's test
    off the TPU, the plain extraction chunking at least one y-plane under
    the byte budget."""
    from mundy_tpu_torch.ops.kernels.row_extract import fits

    nz, R = grid.nz, grid.row_capacity
    dev = grid.origin.device
    if dev.type == "cuda":
        return fits(R, max_neighbors, itemsize, dev)
    return 4 * nz * R * 9 * R * itemsize <= hbm_budget_bytes


def moved_beyond_skin(state: RowState, metric: Metric, skin: float) -> torch.Tensor:
    """() bool tensor: has any valid particle moved more than skin/2 since
    the last rebuild?"""
    disp = metric.sep(state.ref_pos, state.pos)
    d2 = torch.where(state.valid, (disp * disp).sum(-1), 0.0)
    return d2.max() > (0.5 * skin) ** 2


# ---- the general pair engine: pair_accumulate ------------------------------
#
# Port of the reference's pair_accumulate / pair_accumulate_multi: any
# pair_fn over the rows around each row, the small-box fallback of the row
# spheres app (ny or nz < 5 on a periodic axis), with `extra_fields` and the
# `box` fast path. Two departures, both about exactness:
# - the rows around a row are visited once each: with ny (or nz) <= 2 the
#   reference's nine rolls reach the same neighbour row two or three times
#   and count its pairs as often (ROADMAP queue 3); here the offsets along an
#   axis are (-1, 0, 1) from 3 rows on, (0, 1) at 2 and (0,) at 1, so every
#   pair within the cutoff counts once under the minimum image;
# - the candidate axis is summed by a fixed pairwise tree of elementwise
#   adds, so a row's sum does not depend on the chunking (or the device):
#   the result is bit-equal whatever the chunk count.
# The reference sizes its y-chunks for a TPU (128-lane padding of the
# (R, R) blocks, 16 GB of HBM); here the budget counts the (R, R) planes
# that one candidate block keeps live: the nine blocks run one after the
# other, so the (R, 9R) candidate set is never held at once.

PAIR_PLANES = 24  # live (R, R) planes per candidate block of pair_accumulate
PAIR_PLANES_MULTI = 48  # of pair_accumulate_multi (a force and a torque)
PAIR_BUDGET_BYTES = 4e9  # default byte budget of those temporaries


def _row_offsets(n: int) -> tuple:
    """Distinct neighbour-row offsets along an axis of n rows."""
    return (-1, 0, 1) if n >= 3 else tuple(range(n))


def _shift_blocks(state: RowState, extra_fields: tuple, box: Optional[tuple]):
    """The rolled candidate blocks, one per distinct neighbour row: a list of
    (cand_pos, cand_valid, cand_extras, is_self), and whether the `box` fast
    path applies. On it candidate coordinates are pre-shifted to the
    periodic image nearest their partner row, so a pair needs a minimum
    image along x only; it needs ny, nz >= 5 on periodic axes (a one-row
    offset never exceeds half a box), else the full minimum image runs."""
    pos, valid = state.pos, state.valid
    ny, nz = pos.shape[:2]
    dtype, dev = pos.dtype, pos.device
    fast = box is not None
    if fast:
        (lx, ly, lz), (px, py, pz) = box
        if (py and ny < 5) or (pz and nz < 5):
            fast = False
    blocks = []
    for dy in _row_offsets(ny):
        for dz in _row_offsets(nz):
            if dy == 0 and dz == 0:
                cand_pos, cand_valid, cand_extras = pos, valid, tuple(extra_fields)
            else:
                cand_pos = torch.roll(pos, (-dy, -dz), dims=(0, 1))
                cand_valid = torch.roll(valid, (-dy, -dz), dims=(0, 1))
                cand_extras = tuple(torch.roll(f, (-dy, -dz), dims=(0, 1))
                                    for f in extra_fields)
            if fast:
                shift = torch.zeros((ny, nz, 1, 3), dtype=dtype, device=dev)
                if dy != 0 and py:
                    shift[..., 1] = _roll_image_shift(ny, dy, ly, dtype, dev)[:, None, None]
                if dz != 0 and pz:
                    shift[..., 2] = _roll_image_shift(nz, dz, lz, dtype, dev)[None, :, None]
                if (dy != 0 and py) or (dz != 0 and pz):
                    cand_pos = cand_pos + shift
            blocks.append((cand_pos, cand_valid, cand_extras, dy == 0 and dz == 0))
    return blocks, fast


def _tree_sum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Sum over `dim` by a fixed pairwise tree of elementwise adds: the
    order depends on the length of `dim` alone."""
    x = x.movedim(dim, 0)
    while x.shape[0] > 1:
        h = x.shape[0] // 2
        y = x[:h] + x[h:2 * h]
        x = torch.cat([y, x[2 * h:]]) if x.shape[0] % 2 else y
    return x[0]


def _pair_geometry(own_pos, own_valid, cand_pos, cand_valid, is_self, metric, fast, box):
    """(sep (..., R, Rc, 3) from own to candidate, r2, mask) of one block."""
    if fast:
        (lx, _, _), (px, _, _) = box
        sep = cand_pos[..., None, :, :] - own_pos[..., :, None, :]
        if px:
            dxr = cand_pos[..., 0][..., None, :] - own_pos[..., 0][..., :, None]
            sep = torch.cat([(sep[..., 0] - lx * torch.round(dxr * (1.0 / lx)))[..., None],
                             sep[..., 1:]], dim=-1)
    else:
        sep = metric.sep(own_pos[..., :, None, :], cand_pos[..., None, :, :])
    r2 = sep[..., 0] * sep[..., 0] + sep[..., 1] * sep[..., 1] + sep[..., 2] * sep[..., 2]
    mask = own_valid[..., :, None] & cand_valid[..., None, :]
    if is_self:
        R = own_pos.shape[-2]
        mask = mask & ~torch.eye(R, dtype=torch.bool, device=own_pos.device)
    return sep, r2, mask


def _pair_force_chunk(own_pos, own_valid, own_extras, blocks, metric, pair_fn, fast, box):
    """Pair force of one y-chunk against the candidate blocks, summed over
    each block's candidate axis and then over the blocks in order."""
    force = torch.zeros_like(own_pos)
    for cand_pos, cand_valid, cand_extras, is_self in blocks:
        sep, r2, mask = _pair_geometry(own_pos, own_valid, cand_pos, cand_valid, is_self,
                                       metric, fast, box)
        args = [sep, r2, mask]
        for own_f, cand_f in zip(own_extras, cand_extras):
            args.append(own_f[..., :, None])
            args.append(cand_f[..., None, :])
        force = force + _tree_sum(pair_fn(*args), -2)
    return force


def _pair_multi_chunk(own_pos, own_valid, own_extras, blocks, metric, pair_fn, fast, box):
    """As _pair_force_chunk for a tuple-valued pair_fn; a vector extra field
    (..., R, D) broadcasts as (..., R, 1, D) and (..., 1, Rc, D)."""
    outs = None
    nd = own_pos.ndim
    for cand_pos, cand_valid, cand_extras, is_self in blocks:
        sep, r2, mask = _pair_geometry(own_pos, own_valid, cand_pos, cand_valid, is_self,
                                       metric, fast, box)
        args = [sep, r2, mask]
        for own_f, cand_f in zip(own_extras, cand_extras):
            args.append(own_f[..., :, None, :] if own_f.ndim == nd else own_f[..., :, None])
            args.append(cand_f[..., None, :, :] if cand_f.ndim == nd else cand_f[..., None, :])
        summed = tuple(_tree_sum(r, -2) for r in pair_fn(*args))
        outs = summed if outs is None else tuple(a + b for a, b in zip(outs, summed))
    return outs


def pair_chunk_rows(state: RowState, hbm_budget_bytes: float = PAIR_BUDGET_BYTES,
                    planes: int = PAIR_PLANES) -> int:
    """y rows per chunk of pair_accumulate: as many as keep `planes` (R, R)
    planes of every row of a chunk within the byte budget (at least 1)."""
    ny, nz, R = state.pos.shape[:3]
    per_row = planes * nz * R * R * state.pos.element_size()
    return max(1, min(ny, int(hbm_budget_bytes // max(per_row, 1))))


def _chunked(state: RowState, extra_fields: tuple, box, hbm_budget_bytes, planes, chunk_fn,
             metric, pair_fn):
    blocks, fast = _shift_blocks(state, extra_fields, box)
    ny = state.pos.shape[0]
    cy = pair_chunk_rows(state, hbm_budget_bytes, planes)
    parts = []
    for y0 in range(0, ny, cy):
        sl = slice(y0, y0 + cy)
        cblocks = [(cp[sl], cv[sl], tuple(f[sl] for f in ce), s) for cp, cv, ce, s in blocks]
        parts.append(chunk_fn(state.pos[sl], state.valid[sl],
                              tuple(f[sl] for f in extra_fields), cblocks, metric, pair_fn,
                              fast, box))
    return parts


def pair_accumulate(state: RowState, metric: Metric, pair_fn: Callable,
                    extra_fields: tuple = (), box: Optional[tuple] = None,
                    hbm_budget_bytes: float = PAIR_BUDGET_BYTES) -> torch.Tensor:
    """Accumulate sum_j pair_fn over the rows around each row, gather-free:
    (ny, nz, R, 3).

    pair_fn(sep (..., 3), r2 (...), mask (...)) -> (..., 3), the per-pair
    force on the row particle (already masked); with `extra_fields`
    ((ny, nz, R) scalar planes) it also receives (own_field, cand_field)
    per field. `box` (orthorhombic_lengths) takes the fast path where it
    applies (see _shift_blocks). The rows are evaluated in y-chunks of
    pair_chunk_rows, the result bit-equal whatever their count."""
    parts = _chunked(state, extra_fields, box, hbm_budget_bytes, PAIR_PLANES,
                     _pair_force_chunk, metric, pair_fn)
    return parts[0] if len(parts) == 1 else torch.cat(parts)


def pair_accumulate_multi(state: RowState, metric: Metric, pair_fn: Callable,
                          extra_fields: tuple = (), box: Optional[tuple] = None,
                          hbm_budget_bytes: float = PAIR_BUDGET_BYTES) -> tuple:
    """pair_accumulate for a multi-output pair_fn (e.g. force and torque):
    pair_fn(sep, r2, mask, own_f..., cand_f...) -> a tuple of (..., R, Rc,
    D_i), each summed over the candidate axis to (ny, nz, R, D_i). Vector
    extra fields ((ny, nz, R, D)) broadcast with the pair axes before their
    component axis."""
    parts = _chunked(state, extra_fields, box, hbm_budget_bytes, PAIR_PLANES_MULTI,
                     _pair_multi_chunk, metric, pair_fn)
    if len(parts) == 1:
        return parts[0]
    return tuple(torch.cat(leaves) for leaves in zip(*parts))
