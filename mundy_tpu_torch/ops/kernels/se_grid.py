"""Kernels K5s and K5i: spectral-Ewald spreading and interpolation.

Port of mundy_tpu/ops/pallas/se_grid.py: the TPU kernels se_spread_rows_pre
(K5s) and se_interp_rows_pre (K5i), under the contract of the tile gridding
the chromatin app runs (se_spread_tiles / se_interp_tiles). Particles are
binned into (G/m)^3 tiles of m grid points per edge (`se_bin_tiles`, the
tile size and capacity chosen as `make_se_grid_tiles` does); each slot
spreads its force with the separable window over P support points per axis
at offsets -(P/2 - 1) .. P/2 from floor(u), wrapped periodically, and
interpolation is the transpose, times h^3.

On a CUDA tensor `se_spread` and `se_interp` launch the hand-written
kernels of csrc/se_grid.cu (K5s an output-stationary gather per tile over
the occupied slots of the 27 tiles around it, no float atomics; K5i one
block per tile that stages its slots' box of the grid in shared memory and
reads the inverse FFT's planar layout; see the note there). On a CPU
tensor they compute the plain versions, `se_spread_plain` and
`se_interp_plain`: the P-point scatter (`index_add_`, deterministic on the
CPU) and gather of the reference's spectral.se_spread / se_interpolate
applied to the binned slots. With the ES window both equal the reference's
dense tile evaluation up to rounding (the ES weight is exactly zero off
the P support points); the Gaussian window is truncated at P points. A CUDA
tensor never takes the plain version: a failed build or launch raises.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from mundy_tpu_torch.ops.kernels import _build

_DTYPES = {torch.float32: "f32", torch.float64: "f64"}
MAX_P = 16  # the kernels' largest window support (csrc/se_grid.cu)
_PLAIN_CHUNK = 1 << 17  # slots per pass of the plain versions


class SEGridTiles(NamedTuple):
    """Static geometry of the 3D tile decomposition."""

    G: int  # FFT grid points per axis
    m: int  # grid points per tile edge (m | G)
    P: int  # window support points per axis
    R: int  # tile slot capacity
    box: float
    c: float  # Gaussian window exponent coefficient 2 xi^2 / eta
    kind: str = "gaussian"  # or "es" (exp of a semicircle)
    beta: float = 0.0  # ES shape parameter
    wh: float = 0.0  # ES half-support in grid units (P / 2)


def make_se_grid_tiles(G: int, P: int, box: float, xi: float, eta: float,
                       n_particles: int, capacity_slack: float = 1.15, min_m: int = 8,
                       kind: str = "gaussian", beta: float = 0.0,
                       slab_budget_bytes: float = 4.5e9) -> SEGridTiles:
    """The reference's choice of tile edge and capacity: the smallest m >=
    min_m dividing G whose (G/m)^3 float32 (m + P)^3 x 3 slabs fit
    `slab_budget_bytes`, and R from the Poisson maximum with slack (overflow
    flagged, host regrow). The app's overflow flag, regrow and capacity
    parity with the reference rest on this choice."""
    m = min_m
    while G % m != 0 or ((G // m) ** 3) * (m + P) ** 3 * 3 * 4 > slab_budget_bytes:
        m += 1
        if m >= G:
            m = G
            break
    n_tiles = (G // m) ** 3
    occ = n_particles / n_tiles
    R = int(occ * capacity_slack + 6 * math.sqrt(occ + 4) + 8)
    R = ((R + 7) // 8) * 8
    c = 2.0 * xi * xi / max(eta, 1e-300)
    return SEGridTiles(G=G, m=m, P=P, R=R, box=box, c=c, kind=kind, beta=float(beta),
                       wh=0.5 * P)


def window_weights_1d(geom: SEGridTiles, d_grid: torch.Tensor) -> torch.Tensor:
    """1D window weights at grid-unit distances d_grid. ES: exp(beta
    (sqrt(1 - (d/wh)^2) - 1)), zero outside |d| < wh, not normalized (its
    transform is divided out in k-space). Gaussian: sqrt(c/pi) exp(-c (d
    h)^2)."""
    if geom.kind == "es":
        t = d_grid / geom.wh
        s = torch.sqrt(torch.clamp(1.0 - t * t, min=0.0))
        w = torch.exp(torch.tensor(geom.beta, dtype=d_grid.dtype, device=d_grid.device)
                      * (s - 1.0))
        return torch.where(t.abs() < 1.0, w, 0.0)
    h = geom.box / geom.G
    dx = d_grid * h
    return math.sqrt(geom.c / math.pi) * torch.exp(-geom.c * dx * dx)


def se_bin_tiles(geom: SEGridTiles, pos: torch.Tensor, dtype=torch.float32):
    """Bin into (n_tiles, R) slots (one stable sort + one scatter). Returns
    (perm (n_tiles, R) int32, particle id per slot, n = empty; overflow ()
    bool; u (n_tiles, R, 3) grid-unit positions pos / h in `dtype`; valid
    (n_tiles, R) bool; slot_of (N,) int32, the slot of each particle,
    n_tiles R = dropped)."""
    G, m, R = geom.G, geom.m, geom.R
    nt1 = G // m
    n_tiles = nt1 ** 3
    n = pos.shape[0]
    dev = pos.device
    h = geom.box / G
    it = torch.clamp((pos / (m * h)).to(torch.int32), 0, nt1 - 1).to(torch.int64)
    tile = (it[:, 0] * nt1 + it[:, 1]) * nt1 + it[:, 2]
    order = torch.argsort(tile, stable=True)
    tile_s = tile[order]
    first = torch.ones(n, dtype=torch.bool, device=dev)
    first[1:] = tile_s[1:] != tile_s[:-1]
    ar = torch.arange(n, device=dev)
    rank = ar - torch.cummax(torch.where(first, ar, 0), dim=0).values
    overflow = (torch.bincount(tile, minlength=n_tiles) > R).any()
    slot = torch.where(rank < R, tile_s * R + torch.clamp(rank, max=R - 1), n_tiles * R)
    perm = torch.full((n_tiles * R + 1,), n, dtype=torch.int32, device=dev)
    perm[slot] = order.to(torch.int32)  # index n_tiles R is the dump
    perm = perm[:n_tiles * R].reshape(n_tiles, R)
    slot_of = torch.empty(n, dtype=torch.int32, device=dev)
    slot_of[order] = slot.to(torch.int32)
    valid = perm < n
    u = (pos[torch.clamp(perm, max=n - 1).long()] / h).to(dtype)
    return perm, overflow, u, valid, slot_of


def _support(geom: SEGridTiles, u: torch.Tensor):
    """(flat grid ids (S, P, P, P) int64, weights (S, P, P, P)) of the P
    support points per axis of slots at grid-unit positions u (S, 3)."""
    G, P = geom.G, geom.P
    base = torch.floor(u)
    frac = u - base
    base = base.to(torch.int64)
    offs = torch.arange(P, device=u.device) - (P // 2 - 1)
    w = [window_weights_1d(geom, offs.to(u.dtype)[None, :] - frac[:, a, None])
         for a in range(3)]
    g = [torch.remainder(base[:, a, None] + offs[None, :], G) for a in range(3)]
    idx = (g[0][:, :, None, None] * G + g[1][:, None, :, None]) * G + g[2][:, None, None, :]
    wt = w[0][:, :, None, None] * w[1][:, None, :, None] * w[2][:, None, None, :]
    return idx, wt


def se_spread_plain(geom: SEGridTiles, pieces, forces: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K5s (any device): the P-point scatter of each
    valid slot's force, (G, G, G, 3) in forces' dtype. Runs over the valid
    slots in chunks (one host read for their count)."""
    G = geom.G
    perm, _ovf, u, valid, _slot_of = pieces
    sel = valid.reshape(-1).nonzero()[:, 0]
    grid = forces.new_zeros((G * G * G, 3))
    u_flat = u.reshape(-1, 3)
    pid = perm.reshape(-1).long()
    for s0 in range(0, sel.shape[0], _PLAIN_CHUNK):
        s = sel[s0:s0 + _PLAIN_CHUNK]
        idx, wt = _support(geom, u_flat[s])
        vals = wt[..., None] * forces[pid[s]][:, None, None, None, :]
        grid.index_add_(0, idx.reshape(-1), vals.reshape(-1, 3))
    return grid.reshape(G, G, G, 3)


def se_interp_plain(geom: SEGridTiles, pieces, grid: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K5i (any device): each particle's P^3 x 3
    gather from its slot, weighted and summed, times h^3; (N, 3) in grid's
    dtype, zero for a particle that binning dropped. The grid lies in K5i's
    layout (`check_grid`)."""
    G = geom.G
    _perm, _ovf, u, _valid, slot_of = pieces
    check_grid(geom, grid)
    n = slot_of.shape[0]
    n_slots = u.shape[0] * u.shape[1]
    flat = grid.reshape(-1, 3)  # a copy of a planar grid
    u_flat = u.reshape(-1, 3)
    out = grid.new_zeros((n, 3))
    for i0 in range(0, n, _PLAIN_CHUNK):
        s = slot_of[i0:i0 + _PLAIN_CHUNK].long()
        kept = s < n_slots
        idx, wt = _support(geom, u_flat[torch.clamp(s, max=n_slots - 1)])
        vals = flat[idx.reshape(-1)].reshape(idx.shape + (3,))
        acc = (wt[..., None] * vals).sum(dim=(1, 2, 3))
        out[i0:i0 + _PLAIN_CHUNK] = torch.where(kept[:, None], acc, 0.0)
    h = geom.box / G
    return out * (h * h * h)


def _check(geom: SEGridTiles, pieces) -> None:
    perm, _ovf, u, valid, slot_of = pieces
    nt1 = geom.G // geom.m
    if geom.G % geom.m != 0:
        raise ValueError(f"tile edge m = {geom.m} does not divide G = {geom.G}")
    if perm.shape != (nt1 ** 3, geom.R) or u.shape != perm.shape + (3,):
        raise ValueError(f"pieces do not match the geometry: perm {tuple(perm.shape)}, "
                         f"u {tuple(u.shape)} for {nt1 ** 3} tiles of R = {geom.R}")
    if u.dtype not in _DTYPES:
        raise TypeError(f"u must be float32 or float64, got {u.dtype}")


def _check_cuda(geom: SEGridTiles, tensors) -> None:
    """The kernels' envelope: support within the 27 tiles around a slot's
    own (m >= P/2 + 1, one grid point of slack for the rounding between the
    binning and floor(u)), P <= MAX_P and P <= G, int32 ids, contiguous
    inputs."""
    if geom.m < geom.P // 2 + 1:
        raise ValueError(f"tile edge m = {geom.m} < P/2 + 1 = {geom.P // 2 + 1}: a slot's "
                         "window would reach past the neighbouring tiles")
    if geom.P > geom.G:
        raise ValueError(f"window support P = {geom.P} wider than the grid G = {geom.G}")
    if not 1 <= geom.P <= MAX_P:
        raise ValueError(f"window support P = {geom.P} outside the kernels' 1..{MAX_P}")
    if geom.kind not in ("es", "gaussian"):
        raise ValueError(f"unknown window kind {geom.kind!r}")
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError("the K5s/K5i inputs must be contiguous")


def _window_args(geom: SEGridTiles):
    h = geom.box / geom.G
    return (0 if geom.kind == "es" else 1, float(geom.beta), float(geom.wh),
            float(geom.c), float(h), math.sqrt(geom.c / math.pi))


def se_spread(geom: SEGridTiles, pieces, forces: torch.Tensor) -> torch.Tensor:
    """Kernel K5s: (G, G, G, 3) spread grid in forces' dtype from the binned
    `pieces` (se_bin_tiles) and the (N, 3) forces. A CPU tensor computes the
    plain version. A CUDA tensor launches the kernel (its extent pre-pass
    and the gather, counted once in `.launches`): int32 perm, u and forces
    of one dtype, contiguous, within the envelope of `_check_cuda`, or the
    wrapper raises."""
    _check(geom, pieces)
    perm, _ovf, u, _valid, _slot_of = pieces
    if forces.device.type == "cpu":
        return se_spread_plain(geom, pieces, forces)
    if forces.device.type != "cuda":
        raise ValueError(f"no K5s kernel for device {forces.device}")
    _check_cuda(geom, (perm, u, forces))
    if perm.dtype != torch.int32 or forces.dtype != u.dtype or forces.shape[1:] != (3,):
        raise TypeError("K5s needs int32 perm and (N, 3) forces in u's dtype")
    G = geom.G
    grid = torch.empty((G, G, G, 3), dtype=forces.dtype, device=forces.device)
    ext = torch.empty(perm.shape[0], dtype=torch.int32, device=forces.device)  # scratch
    lib = _build.load("se_grid")
    fn = getattr(lib, f"se_spread_{_DTYPES[forces.dtype]}")
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_double] * 5
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    with torch.cuda.device(forces.device):
        stream = torch.cuda.current_stream(forces.device).cuda_stream
        err = fn(u.data_ptr(), perm.data_ptr(), forces.data_ptr(), ext.data_ptr(),
                 grid.data_ptr(), forces.shape[0], G, geom.m, geom.P, geom.R,
                 *_window_args(geom), stream)
    if err != 0:
        raise RuntimeError(f"se_grid spread kernel launch failed: CUDA error {err}")
    se_spread.launches += 1
    return grid


def check_grid(geom: SEGridTiles, grid: torch.Tensor) -> None:
    """Raises unless the grid lies as K5i reads it: (G, G, G, 3) as three
    (G, G, G) planes, the channel axis outermost (element strides (G^2, G,
    1, G^3)), as the inverse FFT of mobility/spectral._k_apply returns it."""
    G = geom.G
    if tuple(grid.shape) != (G, G, G, 3):
        raise ValueError(f"the grid must be ({G}, {G}, {G}, 3), got {tuple(grid.shape)}")
    if grid.stride() != (G * G, G, 1, G ** 3):
        raise ValueError(f"K5i reads a grid as three planes, the channel axis outermost "
                         f"(strides {(G * G, G, 1, G ** 3)}); got strides {grid.stride()}")


def se_interp(geom: SEGridTiles, pieces, grid: torch.Tensor) -> torch.Tensor:
    """Kernel K5i: (N, 3) velocities interpolated from the (G, G, G, 3) grid
    at the binned particles, times h^3, unsorted through perm; zero for a
    particle that binning dropped. The grid lies as three planes, the
    channel axis outermost (`check_grid`). A CPU tensor computes the plain
    version. A CUDA tensor launches the kernel (counted in `.launches`)
    under the same conditions as se_spread."""
    _check(geom, pieces)
    perm, _ovf, u, _valid, slot_of = pieces
    check_grid(geom, grid)
    if grid.device.type == "cpu":
        return se_interp_plain(geom, pieces, grid)
    if grid.device.type != "cuda":
        raise ValueError(f"no K5i kernel for device {grid.device}")
    _check_cuda(geom, (perm, slot_of, u))
    if perm.dtype != torch.int32 or slot_of.dtype != torch.int32 or grid.dtype != u.dtype:
        raise TypeError("K5i needs int32 perm and slot_of and a grid in u's dtype")
    G = geom.G
    n = slot_of.shape[0]
    out = torch.empty((n, 3), dtype=grid.dtype, device=grid.device)
    h = geom.box / G
    lib = _build.load("se_grid")
    fn = getattr(lib, f"se_interp_{_DTYPES[grid.dtype]}")
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_double] * 6
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    with torch.cuda.device(grid.device):
        stream = torch.cuda.current_stream(grid.device).cuda_stream
        err = fn(u.data_ptr(), perm.data_ptr(), slot_of.data_ptr(), grid.data_ptr(),
                 out.data_ptr(), n, u.shape[0] * u.shape[1], G, geom.m, geom.P, geom.R,
                 *_window_args(geom), h * h * h, stream)
    if err != 0:
        raise RuntimeError(f"se_grid interp kernel launch failed: CUDA error {err}")
    se_interp.launches += 1
    return out


se_spread.launches = 0
se_interp.launches = 0


# ---------------------------------------------------------------------------
# The rows layout: kernels K5s-rows and K5i-rows.
#
# Port of the row decomposition of mundy_tpu/ops/pallas/se_grid.py
# (SEGridRows, _bin_rows, _windows, se_bin_and_windows) and of the contract
# of its two Pallas functions, se_spread_rows_pre and se_interp_rows_pre.
# Particles are binned into (G/m)^2 rows, one per (y, z) column of m x m
# grid points spanning the whole x axis, R slots each. The pieces hold per
# slot the particle id (perm, n = empty), the patch offsets gx0 and gy0 and
# the window weights wx (P), wy (P) and wz (W = m + P). Slot s of row (iy,
# iz) spreads onto grid point
#   x = (gx0 + a - XPAD/2) mod G,  y = (iy m - P/2 + gy0 + b) mod G,
#   z = (iz m - P/2 + c) mod G       for a, b < P and c < W
# the value wx[a] (wy[b] (wz[c] f)): z is weighted on the slab's whole width
# W, so with the Gaussian window the rows layout spreads tails that the tile
# layout truncates. Interpolation is the transpose, times h^3, unsorted
# through perm.
#
# On a CUDA tensor se_spread_rows_pre and se_interp_rows_pre launch the
# hand-written kernels of csrc/se_grid.cu, each after a pre-pass in the same
# counted launch that lists every row's occupied slots by run of RUN_X grid
# points along x, in slot order (K5s-rows an output-stationary gather per
# (row cell, x-run) over the run's lists of the rows around it, no float
# atomics; K5i-rows a block per (row, x-run) that stages its slots' box of
# the inverse FFT's planar grid in shared memory; see the note there). On a
# CPU tensor they compute the plain versions, `se_spread_rows_plain` and
# `se_interp_rows_plain`. The TPU's slab-and-fold
# structure (the (G + XPAD, W, 3 W) slab per row, the roll folds
# _combine_axis / _extract_axis, the z contraction outside the kernel) is not
# carried over. The dense trio (se_bin_dense, se_spread_dense,
# se_interp_dense) is XLA in the reference and plain PyTorch here,
# deterministic on the card: each row's slab goes through one matrix
# product and is added to the grid row after row.
# ---------------------------------------------------------------------------

XPAD = 16  # the reference's slab x pad: P <= XPAD keeps the x wrap exact
# constants of the rows kernels (csrc/se_grid.cu)
RUN_X = 32  # grid points along x per run of the x-ordered lists
MAX_RUNS = 128  # runs a row may have (the list pre-pass counts them in shared memory)
ROWS_THREADS = 256  # threads per block of either kernel
ROWS_CAP = 128  # K5s-rows: staged slots per turn
ICHUNK = 64  # K5i-rows: slots per chunk
ISLAB_BYTES = 24 * 1024  # K5i-rows: staged grid values per x-slab, at least one plane
SMEM_LIMIT = 232448  # bytes of shared memory a block may use (H100)
_ROWS_PLAIN_CHUNK = 1 << 15  # slots per pass of the rows plain versions
_DENSE_CHUNK_ELEMS = 1 << 25  # slab elements per pass of the dense trio


class SEGridRows(NamedTuple):
    """Static geometry of the gridding row decomposition."""

    G: int  # FFT grid points per axis
    m: int  # grid points per row cell edge (m | G)
    P: int  # window support points per axis
    R: int  # row slot capacity
    box: float
    c: float  # Gaussian window exponent coefficient 2 xi^2 / eta
    kind: str = "gaussian"  # or "es" (exp of a semicircle)
    beta: float = 0.0  # ES shape parameter
    wh: float = 0.0  # ES half-support in grid units (P / 2)


def make_se_grid_rows(G: int, P: int, box: float, xi: float, eta: float,
                      n_particles: int, capacity_slack: float = 1.15,
                      min_m: int = 8, kind: str = "gaussian",
                      beta: float = 0.0) -> SEGridRows:
    """The reference's row geometry: m the least divisor of G that is >=
    min_m, R the Poisson maximum (mean + 6 sigma) times the slack, rounded
    up to a multiple of 8 (the capacity the overflow flag is judged by)."""
    m = min_m
    while G % m != 0:
        m += 1
    occ = n_particles / (G // m) ** 2
    R = int(occ * capacity_slack + 6 * math.sqrt(occ + 4) + 8)
    R = ((R + 7) // 8) * 8
    c = 2.0 * xi * xi / max(eta, 1e-300)
    return SEGridRows(G=G, m=m, P=P, R=R, box=box, c=c, kind=kind, beta=float(beta),
                      wh=0.5 * P)


def _bin_rows(geom: SEGridRows, pos: torch.Tensor):
    """Sort particles into (n_rows, R) slots (one stable sort and one
    scatter). Returns (perm (n_rows, R) int32, n = empty; overflow () bool)."""
    G, m, R = geom.G, geom.m, geom.R
    nyz = G // m
    n = pos.shape[0]
    dev = pos.device
    h = geom.box / G
    iy = torch.clamp((pos[:, 1] / (m * h)).to(torch.int32), 0, nyz - 1).to(torch.int64)
    iz = torch.clamp((pos[:, 2] / (m * h)).to(torch.int32), 0, nyz - 1).to(torch.int64)
    row = iy * nyz + iz
    order = torch.argsort(row, stable=True)
    row_s = row[order]
    first = torch.ones(n, dtype=torch.bool, device=dev)
    first[1:] = row_s[1:] != row_s[:-1]
    ar = torch.arange(n, device=dev)
    rank = ar - torch.cummax(torch.where(first, ar, 0), dim=0).values
    overflow = (torch.bincount(row, minlength=nyz * nyz) > R).any()
    slot = torch.where(rank < R, row_s * R + torch.clamp(rank, max=R - 1), nyz * nyz * R)
    perm = torch.full((nyz * nyz * R + 1,), n, dtype=torch.int32, device=dev)
    perm[slot] = order.to(torch.int32)  # index n_rows R is the dump
    return perm[:nyz * nyz * R].reshape(nyz * nyz, R), overflow


def _row_iyz(geom: SEGridRows, device=None):
    """(iy, iz) of every row, (n_rows,) int64 each."""
    nyz = geom.G // geom.m
    rows = torch.arange(nyz * nyz, device=device)
    return rows // nyz, rows % nyz


def _windows(geom: SEGridRows, pos: torch.Tensor, perm: torch.Tensor, dtype):
    """Per-slot window pieces and patch offsets: gx0, gy0 (n_rows, R) int32
    offsets inside the slab, wx (.., P) zero on empty slots, wy (.., P) and
    wz (.., W) (an empty slot's from particle n - 1, as the reference's)."""
    G, m, P = geom.G, geom.m, geom.P
    W = m + P
    n = pos.shape[0]
    h = geom.box / G
    valid = perm < n
    p = pos[torch.clamp(perm, max=n - 1).long()]  # (n_rows, R, 3)
    u = p / h
    base = torch.floor(u)
    frac = (u - base).to(dtype)
    base = base.to(torch.int32)
    offs_p = torch.arange(P, dtype=dtype, device=pos.device) - (P // 2 - 1)

    def w1(fr):
        return window_weights_1d(geom, offs_p - fr[..., None]).to(dtype)

    wx = torch.where(valid[..., None], w1(frac[..., 0]), 0.0)
    wy = w1(frac[..., 1])
    iy, iz = _row_iyz(geom, pos.device)
    offs_w = torch.arange(W, dtype=dtype, device=pos.device)
    zslab = (iz * m - P // 2).to(dtype)[:, None, None] + offs_w  # (n_rows, 1, W)
    wz = window_weights_1d(geom, zslab - u[..., 2, None]).to(dtype)
    gx0 = torch.clamp(base[..., 0] - (P // 2 - 1) + XPAD // 2, 0, G + XPAD - P)
    gy0 = torch.clamp(base[..., 1] - (P // 2 - 1) - (iy[:, None] * m - P // 2).to(torch.int32),
                      0, W - P)
    return gx0.to(torch.int32), gy0.to(torch.int32), wx, wy, wz


def se_bin_and_windows(geom: SEGridRows, pos: torch.Tensor, dtype=torch.float32):
    """One binning and window precompute, shared by spread and interp:
    (perm, overflow, gx0, gy0, wx, wy, wz)."""
    perm, overflow = _bin_rows(geom, pos)
    return (perm, overflow) + _windows(geom, pos, perm, dtype)


def _rows_support(geom: SEGridRows, pieces, sel: torch.Tensor):
    """Grid coordinates of the selected flat slots' supports: x (S, P), y
    (S, P) and z (S, W), int64, wrapped."""
    G, m, P, R = geom.G, geom.m, geom.P, geom.R
    _perm, _ovf, gx0, gy0, _wx, _wy, _wz = pieces
    a = torch.arange(P, device=sel.device)
    c = torch.arange(m + P, device=sel.device)
    row = sel // R
    nyz = G // m
    iy, iz = row // nyz, row % nyz
    x = torch.remainder(gx0.reshape(-1)[sel].long()[:, None] + a - XPAD // 2, G)
    y = torch.remainder((iy * m - P // 2 + gy0.reshape(-1)[sel].long())[:, None] + a, G)
    z = torch.remainder((iz * m - P // 2)[:, None] + c, G)
    return x, y, z


def rows_spread_terms(geom: SEGridRows, pieces, forces: torch.Tensor, sel: torch.Tensor):
    """The spread terms of the selected flat slots: (flat grid ids (S P P W,)
    int64, values (S P P W, 3) = wx[a] (wy[b] (wz[c] f)))."""
    G, P, W = geom.G, geom.P, geom.m + geom.P
    perm, _ovf, _gx0, _gy0, wx, wy, wz = pieces
    x, y, z = _rows_support(geom, pieces, sel)
    f = forces[perm.reshape(-1)[sel].long()]
    wzf = wz.reshape(-1, W)[sel][:, :, None] * f[:, None, :]  # (S, W, 3)
    t = wy.reshape(-1, P)[sel][:, :, None, None] * wzf[:, None]  # (S, P, W, 3)
    vals = wx.reshape(-1, P)[sel][:, :, None, None, None] * t[:, None]  # (S, P, P, W, 3)
    idx = (x[:, :, None, None] * G + y[:, None, :, None]) * G + z[:, None, None, :]
    return idx.reshape(-1), vals.reshape(-1, 3)


def se_spread_rows_plain(geom: SEGridRows, pieces, forces: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K5s-rows (any device): every occupied
    slot's P x P x W terms (rows_spread_terms) added into the (G, G, G, 3)
    grid by `index_add_` (deterministic on the CPU), over the occupied
    slots in chunks (one host read for their count)."""
    G = geom.G
    sel = (pieces[0].reshape(-1) < forces.shape[0]).nonzero()[:, 0]
    grid = forces.new_zeros((G * G * G, 3))
    for s0 in range(0, sel.shape[0], _ROWS_PLAIN_CHUNK):
        grid.index_add_(0, *rows_spread_terms(geom, pieces, forces,
                                              sel[s0:s0 + _ROWS_PLAIN_CHUNK]))
    return grid.reshape(G, G, G, 3)


def se_interp_rows_plain(geom: SEGridRows, pieces, n: int, grid: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K5i-rows (any device): for every occupied
    slot u = h^3 sum_c wz[c] sum_a wx[a] sum_b wy[b] grid[x, y, z], the
    reference's order of contraction, written at perm; (n, 3) in the grid's
    dtype, zero for a particle that binning dropped."""
    G = geom.G
    perm, _ovf, _gx0, _gy0, wx, wy, wz = pieces
    P, W = geom.P, geom.m + geom.P
    sel = (perm.reshape(-1) < n).nonzero()[:, 0]
    out = grid.new_zeros((n + 1, 3))
    for s0 in range(0, sel.shape[0], _ROWS_PLAIN_CHUNK):
        s = sel[s0:s0 + _ROWS_PLAIN_CHUNK]
        x, y, z = _rows_support(geom, pieces, s)
        vals = grid[x[:, :, None, None], y[:, None, :, None], z[:, None, None, :]]
        yred = (wy.reshape(-1, P)[s][:, None, :, None, None] * vals).sum(2)  # (S, P, W, 3)
        acc = (wx.reshape(-1, P)[s][:, :, None, None] * yred).sum(1)  # (S, W, 3)
        out[perm.reshape(-1)[s].long()] = (acc * wz.reshape(-1, W)[s][:, :, None]).sum(1)
    h = geom.box / G
    return out[:n] * (h * h * h)


def _check_rows(geom: SEGridRows, pieces) -> None:
    perm, _ovf, gx0, gy0, wx, wy, wz = pieces
    nyz = geom.G // geom.m
    P, W = geom.P, geom.m + geom.P
    if geom.G % geom.m != 0:
        raise ValueError(f"row edge m = {geom.m} does not divide G = {geom.G}")
    shape = (nyz * nyz, geom.R)
    if (perm.shape != shape or gx0.shape != shape or gy0.shape != shape
            or wx.shape != shape + (P,) or wy.shape != shape + (P,)
            or wz.shape != shape + (W,)):
        raise ValueError(f"pieces do not match the geometry: perm {tuple(perm.shape)}, wz "
                         f"{tuple(wz.shape)} for {nyz * nyz} rows of R = {geom.R}, P = {P}")
    if wx.dtype not in _DTYPES or not wx.dtype == wy.dtype == wz.dtype:
        raise TypeError(f"the window weights must share float32 or float64, got {wx.dtype}")


class RowsPlan(NamedTuple):
    """The rows kernels' scratch and shared memory at one geometry."""

    nxr: int  # runs of RUN_X grid points along x
    max_runs: int  # the most runs one slot's x support meets
    spread_lcap: int  # K5s-rows list entries a row: R max_runs
    interp_lcap: int  # K5i-rows list entries a row: R (each slot in one run)
    spread_smem: int  # bytes of shared memory a K5s-rows block uses
    interp_smem: int  # bytes of shared memory a K5i-rows block uses


@functools.lru_cache(maxsize=64)
def rows_max_runs(G: int, P: int) -> int:
    """The most runs of RUN_X grid points along x that the P points of one
    x support, wrapped on the G-point axis, meet."""
    return max(len({(sx + a) % G // RUN_X for a in range(P)}) for sx in range(G))


@functools.lru_cache(maxsize=64)
def rows_plan(geom: SEGridRows, itemsize: int) -> RowsPlan:
    """The scratch and shared memory the rows kernels take at `geom` with
    `itemsize`-byte values, as csrc/se_grid.cu sizes them. Raises
    ValueError where a kernel cannot take the geometry: more than MAX_RUNS
    runs, list or slot ids past int32, or a block's shared memory (K5s-rows'
    ROWS_CAP staged slots; K5i-rows' chunk of ICHUNK slots, its sums and at
    least one staged (channel, x) plane) above SMEM_LIMIT."""
    G, m, P, R = geom.G, geom.m, geom.P, geom.R
    W = m + P
    nxr = -(-G // RUN_X)
    if nxr > MAX_RUNS:
        raise ValueError(f"G = {G} has {nxr} runs of {RUN_X} grid points along x, above "
                         f"the rows kernels' {MAX_RUNS}")
    max_runs = rows_max_runs(G, P)
    n_rows = (G // m) ** 2
    if n_rows * R * max_runs >= 1 << 31:
        raise ValueError(f"the x-run lists of {n_rows} rows of R = {R} ({max_runs} runs a "
                         "slot) need more than the int32 entries the kernels index")
    spread = (ROWS_CAP * ((RUN_X + 2 * m + 4 + 3) // 4 * 4) * itemsize
              + 4 * (5 * ROWS_THREADS + ROWS_CAP + 28 + ROWS_THREADS // 32))
    v = 16 // itemsize
    plane = 3 * W * ((W + 2 * v - 2) // v * v)  # the widest staged (channel, x) plane
    budget = ISLAB_BYTES // itemsize
    slab = plane if plane > budget else min(plane * (RUN_X + P - 1), budget)
    interp = ((slab + ICHUNK * (2 * P + W) + ICHUNK * W * 3) * itemsize
              + 4 * (6 * ICHUNK + 1 + ICHUNK * W + W + 2 * RUN_X + 1))
    for name, b in (("K5s-rows", spread), ("K5i-rows", interp)):
        if b > SMEM_LIMIT:
            raise ValueError(f"{name} would stage {b} bytes of shared memory a block at m = "
                             f"{m}, P = {P} ({itemsize}-byte values), above the "
                             f"{SMEM_LIMIT} a block may use")
    return RowsPlan(nxr, max_runs, R * max_runs, R, spread, interp)


def rows_run_members(geom: SEGridRows, pieces, n: int, starts: bool = False) -> torch.Tensor:
    """Plain version of the rows kernels' list pre-pass: (n_rows, R, nxr)
    bool, True where the occupied slot's x support meets run k of RUN_X
    grid points along x (starts=False, K5s-rows' lists) or starts in it
    (starts=True, K5i-rows'). A run's list is its column's slots in slot
    order."""
    G, P = geom.G, geom.P
    perm, _ovf, gx0 = pieces[:3]
    x0 = torch.arange(0, G, RUN_X, device=perm.device)
    sx = torch.remainder(gx0.long() - XPAD // 2, G)[..., None]
    member = torch.remainder(sx - x0, G) < torch.clamp(G - x0, max=RUN_X)
    if not starts:
        member = member | (torch.remainder(x0 - sx, G) < P)
    return member & (perm < n)[..., None]


def _check_rows_cuda(geom: SEGridRows, pieces, tensors) -> RowsPlan:
    """The rows kernels' envelope: a slot's support within the rows on
    either side of its own (m >= P/2 + 1), no axis wrapping onto itself (P
    <= XPAD, W = m + P <= G), the scratch and shared memory of `rows_plan`,
    int32 ids and offsets, contiguous inputs. Returns the plan."""
    G, m, P = geom.G, geom.m, geom.P
    if m < P // 2 + 1:
        raise ValueError(f"row edge m = {m} < P/2 + 1 = {P // 2 + 1}: a slot's window would "
                         "reach past the neighbouring rows")
    if not 1 <= P <= XPAD:
        raise ValueError(f"window support P = {P} outside the rows layout's 1..{XPAD}")
    if m + P > G:
        raise ValueError(f"slab width W = m + P = {m + P} wider than the grid G = {G}")
    perm, _ovf, gx0, gy0 = pieces[:4]
    if not perm.dtype == gx0.dtype == gy0.dtype == torch.int32:
        raise TypeError("the rows kernels need int32 perm, gx0 and gy0")
    for t in tuple(pieces[:1]) + tuple(pieces[2:]) + tuple(tensors):
        if not t.is_contiguous():
            raise ValueError("the K5s-rows/K5i-rows inputs must be contiguous")
    return rows_plan(geom, pieces[4].element_size())


def se_spread_rows_pre(geom: SEGridRows, pieces, forces: torch.Tensor) -> torch.Tensor:
    """Kernel K5s-rows: the (G, G, G, 3) spread grid in forces' dtype from
    the pieces of se_bin_and_windows and the (N, 3) forces. A CPU tensor
    computes the plain version. A CUDA tensor launches the kernel (its list
    pre-pass and the gather, counted once in `.launches`): forces in the
    weights' dtype, within the envelope of `_check_rows_cuda`, or the
    wrapper raises."""
    _check_rows(geom, pieces)
    if forces.device.type == "cpu":
        return se_spread_rows_plain(geom, pieces, forces)
    if forces.device.type != "cuda":
        raise ValueError(f"no K5s-rows kernel for device {forces.device}")
    plan = _check_rows_cuda(geom, pieces, (forces,))
    perm, _ovf, gx0, gy0, wx, wy, wz = pieces
    if forces.dtype != wx.dtype or forces.shape[1:] != (3,):
        raise TypeError("K5s-rows needs (N, 3) forces in the weights' dtype")
    G = geom.G
    dev = forces.device
    grid = torch.empty((G, G, G, 3), dtype=forces.dtype, device=dev)
    lists = torch.empty(perm.shape[0] * plan.spread_lcap, dtype=torch.int32, device=dev)
    offs = torch.empty(perm.shape[0] * (plan.nxr + 1), dtype=torch.int32, device=dev)
    lib = _build.load("se_grid")
    fn = getattr(lib, f"se_spread_rows_{_DTYPES[forces.dtype]}")
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(perm.data_ptr(), gx0.data_ptr(), gy0.data_ptr(), wx.data_ptr(),
                 wy.data_ptr(), wz.data_ptr(), forces.data_ptr(), lists.data_ptr(),
                 offs.data_ptr(), grid.data_ptr(), forces.shape[0], G, geom.m, geom.P, geom.R,
                 plan.spread_lcap, stream)
    if err != 0:
        raise RuntimeError(f"se_grid rows spread kernel launch failed: CUDA error {err}")
    se_spread_rows_pre.launches += 1
    return grid


def se_interp_rows_pre(geom: SEGridRows, pieces, n: int, grid: torch.Tensor) -> torch.Tensor:
    """Kernel K5i-rows: (n, 3) velocities interpolated from the (G, G, G,
    3) grid at the binned particles, times h^3, written at perm; zero for a
    particle that binning dropped. A CPU tensor computes the plain version
    (any grid strides). A CUDA tensor launches the kernel (counted in
    `.launches`) on a grid in the inverse FFT's planar layout (`check_grid`)
    under the conditions of se_spread_rows_pre, or the wrapper raises."""
    _check_rows(geom, pieces)
    if grid.device.type == "cpu":
        return se_interp_rows_plain(geom, pieces, n, grid)
    if grid.device.type != "cuda":
        raise ValueError(f"no K5i-rows kernel for device {grid.device}")
    check_grid(geom, grid)
    plan = _check_rows_cuda(geom, pieces, ())
    perm, _ovf, gx0, gy0, wx, wy, wz = pieces
    if grid.dtype != wx.dtype:
        raise TypeError("K5i-rows needs a grid in the weights' dtype")
    G = geom.G
    h = geom.box / G
    dev = grid.device
    out = torch.zeros((n, 3), dtype=grid.dtype, device=dev)
    lists = torch.empty(perm.shape[0] * plan.interp_lcap, dtype=torch.int32, device=dev)
    offs = torch.empty(perm.shape[0] * (plan.nxr + 1), dtype=torch.int32, device=dev)
    lib = _build.load("se_grid")
    fn = getattr(lib, f"se_interp_rows_{_DTYPES[grid.dtype]}")
    fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 6 + [ctypes.c_double]
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(perm.data_ptr(), gx0.data_ptr(), gy0.data_ptr(), wx.data_ptr(),
                 wy.data_ptr(), wz.data_ptr(), grid.data_ptr(), out.data_ptr(),
                 lists.data_ptr(), offs.data_ptr(), n, G, geom.m, geom.P, geom.R,
                 plan.interp_lcap, h * h * h, stream)
    if err != 0:
        raise RuntimeError(f"se_grid rows interp kernel launch failed: CUDA error {err}")
    se_interp_rows_pre.launches += 1
    return out


se_spread_rows_pre.launches = 0
se_interp_rows_pre.launches = 0


def se_spread_rows(geom: SEGridRows, pos: torch.Tensor, forces: torch.Tensor):
    """Bin, then spread through K5s-rows. Returns (grid, overflow)."""
    pieces = se_bin_and_windows(geom, pos, forces.dtype)
    return se_spread_rows_pre(geom, pieces, forces), pieces[1]


def se_interp_rows(geom: SEGridRows, pos: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """Bin, then interpolate through K5i-rows."""
    pieces = se_bin_and_windows(geom, pos, grid.dtype)
    return se_interp_rows_pre(geom, pieces, pos.shape[0], grid)


# ---- the dense trio --------------------------------------------------------


def se_bin_dense(geom: SEGridRows, pos: torch.Tensor, dtype=torch.float32):
    """Binning and per-slot grid-unit positions for the dense gridding:
    (perm, overflow, u (n_rows, R, 3), valid (n_rows, R))."""
    if geom.P > XPAD:
        raise ValueError(f"window support P={geom.P} exceeds the dense-gridding x wrap pad "
                         f"XPAD={XPAD}: wrapped window mass would be silently truncated")
    perm, overflow = _bin_rows(geom, pos)
    n = pos.shape[0]
    h = geom.box / geom.G
    u = (pos[torch.clamp(perm, max=n - 1).long()] / h).to(dtype)
    return perm, overflow, u, perm < n


def _dense_windows(geom: SEGridRows, u: torch.Tensor, valid: torch.Tensor,
                   iy: torch.Tensor, iz: torch.Tensor):
    """Dense windows of a chunk of rows: wx (c, R, G + XPAD) along the
    padded x axis, zero on empty slots; wy, wz (c, R, W) on the slab axes
    (origin i m - P/2)."""
    G, m, P = geom.G, geom.m, geom.P
    dt = u.dtype
    xg = torch.arange(G + XPAD, dtype=dt, device=u.device) - XPAD // 2
    wx = torch.where(valid[..., None], window_weights_1d(geom, xg - u[..., 0, None]), 0.0)
    offs_w = torch.arange(m + P, dtype=dt, device=u.device)
    yslab = (iy * m - P // 2).to(dt)[:, None, None] + offs_w
    zslab = (iz * m - P // 2).to(dt)[:, None, None] + offs_w
    wy = window_weights_1d(geom, yslab - u[..., 1, None])
    wz = window_weights_1d(geom, zslab - u[..., 2, None])
    return wx.to(dt), wy.to(dt), wz.to(dt)


def _dense_chunk(geom: SEGridRows) -> int:
    W = geom.m + geom.P
    return max(1, _DENSE_CHUNK_ELEMS // ((geom.G + XPAD) * W * W * 3))


def se_spread_dense(geom: SEGridRows, pieces_dense, forces: torch.Tensor) -> torch.Tensor:
    """(G, G, G, 3) spread grid through one matrix product per row: slab
    (x, yz) = sum_s wx_s(x) wyzf_s(yz) on the dense slab axes, the x pad
    folded, each slab added into a y/z-padded grid row after row (one fixed
    order, so two runs on the card are bit-equal), the y/z pads folded at
    the end."""
    if geom.P > XPAD:
        raise ValueError(f"P={geom.P} > XPAD={XPAD}: wrapped x window mass "
                         "would be silently truncated")
    G, m, P, R = geom.G, geom.m, geom.P, geom.R
    W = m + P
    nyz = G // m
    perm, _ovf, u, valid = pieces_dense
    n = forces.shape[0]
    dt = forces.dtype
    f = torch.where(valid[..., None], forces[torch.clamp(perm, max=n - 1).long()], 0.0)
    iy_all, iz_all = _row_iyz(geom, forces.device)
    half, xh = P // 2, XPAD // 2
    gpad = forces.new_zeros((G, G + P, G + P, 3))
    step = _dense_chunk(geom)
    for r0 in range(0, perm.shape[0], step):
        sl = slice(r0, r0 + step)
        wx, wy, wz = _dense_windows(geom, u[sl].to(dt), valid[sl], iy_all[sl], iz_all[sl])
        wzf = wz[..., None] * f[sl][:, :, None, :]  # (c, R, W, 3)
        wyzf = (wy[..., None, None] * wzf[:, :, None]).reshape(wx.shape[0], R, W * W * 3)
        slab = torch.bmm(wx.transpose(1, 2), wyzf).reshape(-1, G + XPAD, W, W, 3)
        core = slab[:, xh:xh + G].clone()
        core[:, G - xh:] += slab[:, :xh]
        core[:, :xh] += slab[:, xh + G:]
        for k in range(core.shape[0]):
            y0, z0 = ((r0 + k) // nyz) * m, ((r0 + k) % nyz) * m  # no host read
            gpad[:, y0:y0 + W, z0:z0 + W] += core[k]
    g = gpad[:, half:half + G].clone()
    g[:, G - half:] += gpad[:, :half]
    g[:, :P - half] += gpad[:, half + G:]
    g2 = g[:, :, half:half + G].clone()
    g2[:, :, G - half:] += g[:, :, :half]
    g2[:, :, :P - half] += g[:, :, half + G:]
    return g2


def se_interp_dense(geom: SEGridRows, pieces_dense, n: int, grid: torch.Tensor) -> torch.Tensor:
    """Interpolate grid velocities to particles: the transposed product,
    each row's region read from a y/z-padded copy of the grid; (n, 3) times
    h^3, zero for a particle that binning dropped."""
    G, m, P, R = geom.G, geom.m, geom.P, geom.R
    W = m + P
    perm, _ovf, u, valid = pieces_dense
    dt = grid.dtype
    iy_all, iz_all = _row_iyz(geom, grid.device)
    half, xh = P // 2, XPAD // 2
    gw = torch.cat([grid[:, G - half:], grid, grid[:, :P - half]], dim=1)
    gpad = torch.cat([gw[:, :, G - half:], gw, gw[:, :, :P - half]], dim=2)
    offs = torch.arange(W, device=grid.device)
    out = grid.new_zeros((n + 1, 3))
    step = _dense_chunk(geom)
    for r0 in range(0, perm.shape[0], step):
        sl = slice(r0, r0 + step)
        iy, iz = iy_all[sl], iz_all[sl]
        wx, wy, wz = _dense_windows(geom, u[sl].to(dt), valid[sl], iy, iz)
        yy = iy[:, None] * m + offs  # (c, W)
        zz = iz[:, None] * m + offs
        region = gpad[:, yy[:, :, None], zz[:, None, :]].permute(1, 0, 2, 3, 4)  # (c, G, W, W, 3)
        ext = torch.cat([region[:, G - xh:], region, region[:, :xh]], dim=1)
        zl = torch.bmm(wx, ext.reshape(-1, G + XPAD, W * W * 3)).reshape(-1, R, W, W, 3)
        yred = (wy[..., None, None] * zl).sum(2)  # (c, R, W, 3)
        vals = (wz[..., None] * yred).sum(2)  # (c, R, 3)
        out[torch.clamp(perm[sl], max=n).long().reshape(-1)] = vals.reshape(-1, 3)
    h = geom.box / G
    return out[:n] * (h * h * h)
