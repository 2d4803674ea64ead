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
