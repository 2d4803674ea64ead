"""Spectral-Ewald (SE) wave-space RPY sum: FFT-accelerated periodic Stokes
mobility.

Port of mundy_tpu/mobility/spectral.py (ref: the PVFMM/STKFMM long-range
Stokes sums, `TPLsList.cmake:29-30`): spread the forces onto a (G, G, G)
grid with a window, FFT, multiply each mode by the RPY x Hasimoto
coefficient with the window transform divided out, inverse FFT,
interpolate back to the particles. Two griddings: the tile layout of the
apps (kernels K5s and K5i, `se_wave_apply_dense`) and the reference's
scatter-add and gather over every particle's P^3 support points
(`se_spread`, `se_interpolate`, `se_wave_apply`: plain PyTorch, as the
reference's are XLA; small N, CPU tensors only: on the card they raise,
naming the tile gridding). The FFTs are cuFFT through
`torch.fft`, as the reference leaves them to XLA; the forward transform
runs in float32 in every dtype, as the reference's does. The real-space
correction comes from mobility/ewald.py on the 3D-cell engine.

Windows (Lindbo & Tornberg 2011; Barnett, Magland & af Klinteberg 2019):
"gaussian" splits the screen exp(-k^2/4xi^2) between the grid convolutions
(eta), "es" keeps the whole screen in k-space and divides the exp of a
semicircle window's transform out twice, at smaller P and G for the same
tolerance.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from mundy_tpu_torch.mobility.ewald import (
    EwaldRPY,
    build_ewald_rpy,
    ewald_real_apply,
    ewald_real_apply_cells,
    rpy_real_cells_kernel,
)
from mundy_tpu_torch.ops.kernels.se_grid import (
    SEGridRows,
    SEGridTiles,
    _support,
    make_se_grid_rows,
    make_se_grid_tiles,
    se_bin_and_windows,
    se_bin_dense,
    se_bin_tiles,
    se_interp,
    se_interp_dense,
    se_interp_rows_pre,
    se_spread_dense,
    se_spread_rows_pre,
)
from mundy_tpu_torch.ops.kernels.se_grid import se_spread as se_spread_tiles


class SpectralEwaldRPY(NamedTuple):
    """Precomputed spectral-Ewald operator (wave part on a (G, G, G) grid)."""

    base: EwaldRPY  # real-space tables + self term (shared with the direct sum)
    grid_n: int  # G, FFT grid points per axis
    support: int  # P, window support in grid points per axis
    eta: float  # shape-splitting fraction (0 for ES)
    kvec: tuple  # (kx (G,), ky (G,), kz (G//2+1,)) mode wavenumbers
    window: str = "gaussian"
    es_beta: float = 0.0
    # ES window transform samples (|w^(kx)| (G,), |w^(kz)| (G//2+1,)), empty
    # for the Gaussian window
    wk: tuple = ()


def _fft_wavenumbers(G: int, box: float):
    k = 2.0 * np.pi * np.fft.fftfreq(G, d=box / G)
    kr = 2.0 * np.pi * np.fft.rfftfreq(G, d=box / G)
    return k, kr


def _smooth_size(n: int) -> int:
    """Smallest 5-smooth integer >= n that is a multiple of 16 (fast FFTs;
    the tile edge m = 8 then divides G)."""
    def smooth(v):
        for p in (2, 3, 5):
            while v % p == 0:
                v //= p
        return v == 1

    n = ((n + 15) // 16) * 16
    while not smooth(n // 16) or not smooth(n):
        n += 16
    return n


def _es_window_transform(k: np.ndarray, beta: float, wh: float) -> np.ndarray:
    """1D Fourier transform of the ES window at wavenumbers k (host float64
    Gauss-Legendre quadrature): 2 int_0^wh exp(beta (sqrt(1 - (x/wh)^2) -
    1)) cos(k x) dx."""
    nodes, wts = np.polynomial.legendre.leggauss(200)
    x = 0.5 * wh * (nodes + 1.0)
    jac = 0.5 * wh
    t = x / wh
    w = np.exp(beta * (np.sqrt(np.maximum(1.0 - t * t, 0.0)) - 1.0))
    c = np.cos(np.asarray(k)[:, None] * x[None, :])
    return 2.0 * jac * (c * (w * wts)[None, :]).sum(axis=1)


def build_spectral_ewald(box: float, radius: float, viscosity: float,
                         xi: Optional[float] = None, r_cut: Optional[float] = None,
                         tol: float = 1e-4, support: Optional[int] = None,
                         oversample: float = 1.0, n_particles: Optional[int] = None,
                         dtype=torch.float32, window: str = "es",
                         device=None) -> SpectralEwaldRPY:
    """Precompute (host, float64) the SE operator, as tensors of `dtype` on
    `device`. P and the grid follow from `tol` by the truncation/alias
    balance of the chosen window; `support` overrides P, `oversample`
    widens the grid."""
    s2 = max(math.log(1.0 / tol), 1.0)
    if xi is None and r_cut is None and n_particles is not None:
        spacing = box / max(n_particles, 1) ** (1.0 / 3.0)
        r_cut = min(0.25 * box, 3.5 * spacing)
        xi = math.sqrt(s2) / r_cut
    base = build_ewald_rpy(box, radius, viscosity, xi=xi, r_cut=r_cut, tol=tol,
                           dtype=dtype, device=device)
    xi = base.xi
    kmax = 2.0 * xi * math.sqrt(s2)
    G_min = int(np.ceil(kmax * box / np.pi * oversample))

    def t(a):
        return torch.as_tensor(a, dtype=dtype, device=device)

    if window == "es":
        # aliasing ~exp(-pi P sqrt(1 - 1/sigma)) at oversampling sigma = 1.5
        sigma = 1.5
        if support is None:
            support = int(np.ceil(s2 / (np.pi * math.sqrt(1.0 - 1.0 / sigma))))
            support = max(support, 4)
        support = int(support)
        es_beta = 0.97 * np.pi * support * (1.0 - 1.0 / (2.0 * sigma))
        G = _smooth_size(max(int(np.ceil(sigma * G_min)), 2 * support, 16))
        kx, kz = _fft_wavenumbers(G, box)
        wh_x = 0.5 * support * (box / G)  # physical half-support
        return SpectralEwaldRPY(
            base=base, grid_n=G, support=support, eta=0.0,
            kvec=(t(kx), t(kx), t(kz)), window="es", es_beta=float(es_beta),
            wk=(t(_es_window_transform(kx, es_beta, wh_x)),
                t(_es_window_transform(kz, es_beta, wh_x))))

    # Gaussian: eta = 8 xi^2 s2 / k_N^2, P = 4 s2 / pi, power-of-two G with
    # eta <= 0.9
    G = G_min
    if support is None:
        support = int(np.ceil(4.0 * s2 / np.pi))
    G = max(G, 2 * support)
    G = int(2 ** np.ceil(np.log2(G)))
    while 8.0 * xi * xi * s2 / (np.pi * G / box) ** 2 > 0.9:
        G *= 2
    k_nyq = np.pi * G / box
    eta = 8.0 * xi * xi * s2 / (k_nyq * k_nyq)
    support = min(int(support), G)
    kx, kz = _fft_wavenumbers(G, box)
    return SpectralEwaldRPY(base=base, grid_n=G, support=int(support), eta=float(eta),
                            kvec=(t(kx), t(kx), t(kz)))


def _window_1d(op: SpectralEwaldRPY, frac: torch.Tensor, dtype) -> torch.Tensor:
    """(N, P) window weights along one axis at the grid offsets -(P/2 - 1)
    .. P/2 from a particle's base grid point; `frac` (N,) is its offset from
    that point in grid units, in [0, 1)."""
    P = op.support
    h = op.base.box / op.grid_n
    offs = torch.arange(P, dtype=dtype, device=frac.device) - (P // 2 - 1)
    d = offs[None, :] - frac[:, None]
    if op.window == "es":
        t = d / (0.5 * P)
        s = torch.sqrt(torch.clamp(1.0 - t * t, min=0.0))
        w = torch.exp(torch.tensor(op.es_beta, dtype=dtype, device=frac.device) * (s - 1.0))
        return torch.where(t.abs() < 1.0, w, 0.0)
    c = 2.0 * op.base.xi * op.base.xi / op.eta
    dx = d * h
    return math.sqrt(c / math.pi) * torch.exp(-c * dx * dx)


def _k_apply(op: SpectralEwaldRPY, grid: torch.Tensor) -> torch.Tensor:
    """FFT -> transverse-project and scale each mode -> inverse FFT. The
    forward FFT is float32 in every dtype (the reference's cast); the mode
    arithmetic and the inverse FFT run in the operator's dtype."""
    G = op.grid_n
    fhat = torch.fft.rfftn(grid.to(torch.float32), dim=(0, 1, 2))
    kx, ky, kz = op.kvec
    KX = kx[:, None, None]
    KY = ky[None, :, None]
    KZ = kz[None, None, :]
    k2 = KX * KX + KY * KY + KZ * KZ
    inv_k2 = torch.where(k2 > 0, 1.0 / torch.clamp(k2, min=1e-30), 0.0)
    kdotf = KX * fhat[..., 0] + KY * fhat[..., 1] + KZ * fhat[..., 2]
    proj = kdotf * inv_k2
    # mode coefficients sinc(ka)^2 (1 + k^2/4xi^2) exp(-k^2 (1-eta)/4xi^2)
    # / (visc k^2 V); k = 0 excluded
    xi = op.base.xi
    kn = torch.sqrt(torch.clamp(k2, min=1e-30))
    sinc_ka = torch.sinc(kn * (op.base.radius / math.pi))
    H = (1 + k2 / (4 * xi**2)) * torch.exp(-k2 * ((1.0 - op.eta) / (4 * xi**2)))
    c = sinc_ka**2 * H * inv_k2 / (op.base.viscosity * op.base.box**3)
    if op.window == "es":
        # PME-style deconvolution: the window transform divided out twice
        wkx, wkz = op.wk
        wprod = wkx[:, None, None] * wkx[None, :, None] * wkz[None, None, :]
        c = c / torch.clamp(wprod * wprod, min=1e-300)
    uhat = torch.stack([c * (fhat[..., 0] - proj * KX),
                        c * (fhat[..., 1] - proj * KY),
                        c * (fhat[..., 2] - proj * KZ)], dim=-1)
    ugrid = torch.fft.irfftn(uhat, s=(G, G, G), dim=(0, 1, 2))
    return ugrid * (op.base.box ** 3)


def _scatter_support(op: SpectralEwaldRPY, pos: torch.Tensor):
    """(flat grid ids (N, P, P, P), separable weights (N, P, P, P)) of every
    particle's P^3 support points at offsets -(P/2 - 1) .. P/2 from
    floor(pos / h), wrapped periodically: the support of the tile plain
    versions (se_grid._support), whose window depends on the operator only.
    A CUDA tensor raises: the card grids through K5s and K5i."""
    if pos.is_cuda:
        raise RuntimeError("the scatter gridding is the CPU's; on the card use the tile "
                           "gridding (se_wave_apply_dense, se_rpy_apply_cells, or "
                           "freespace_rpy_apply with geom=)")
    return _support(make_se_geometry_tiles(op, 1), pos / (op.base.box / op.grid_n))


def se_spread(op: SpectralEwaldRPY, pos: torch.Tensor, forces: torch.Tensor) -> torch.Tensor:
    """Spread the forces onto the (G, G, G, 3) grid: a scatter-add of every
    particle's P^3 weighted force (`index_add_`)."""
    G = op.grid_n
    idx, wt = _scatter_support(op, pos)
    vals = wt[..., None] * forces[:, None, None, None, :]
    grid = forces.new_zeros((G * G * G, 3))
    grid.index_add_(0, idx.reshape(-1), vals.reshape(-1, 3))
    return grid.reshape(G, G, G, 3)


def se_interpolate(op: SpectralEwaldRPY, pos: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """Interpolate the grid's velocities at the particles: a gather of every
    particle's P^3 support, weighted and summed, times h^3. (N, 3)."""
    h = op.base.box / op.grid_n
    idx, wt = _scatter_support(op, pos)
    vals = grid.reshape(-1, 3)[idx.reshape(-1)].reshape(idx.shape + (3,))
    return (wt[..., None] * vals).sum(dim=(1, 2, 3)) * (h * h * h)


def se_wave_apply(op: SpectralEwaldRPY, pos: torch.Tensor, forces: torch.Tensor) -> torch.Tensor:
    """Wave-space sum through the scatter gridding (small N): spread, the
    FFT mode product, interpolate. (N, 3)."""
    grid = se_spread(op, pos, forces)
    ugrid = _k_apply(op, grid)
    return se_interpolate(op, pos, ugrid.to(forces.dtype))


def make_se_geometry(op: SpectralEwaldRPY, n_particles: int,
                     capacity_slack: float = 1.15) -> SEGridRows:
    """Row-gridding geometry of the operator (ops/kernels/se_grid
    .make_se_grid_rows): `capacity_slack` scales the Poisson bound of the
    slots per row; clustered systems need more, and an overflowed slot
    leaves the wave sum (flagged)."""
    return make_se_grid_rows(op.grid_n, op.support, op.base.box, op.base.xi, op.eta,
                             n_particles, capacity_slack=capacity_slack,
                             kind=op.window, beta=op.es_beta)


def se_wave_apply_rows(op: SpectralEwaldRPY, geom: SEGridRows, pos: torch.Tensor,
                       forces: torch.Tensor, pieces=None):
    """Wave-space sum through the row gridding: K5s-rows, the FFT mode
    product, K5i-rows on the inverse FFT's planar output. Returns (u (N,
    3), overflow). Pass `pieces` (se_bin_and_windows) to reuse one binning
    and window evaluation across applies at fixed positions, e.g. the
    mobility products of one BBPGD solve."""
    if pieces is None:
        pieces = se_bin_and_windows(geom, pos, forces.dtype)
    grid = se_spread_rows_pre(geom, pieces, forces.contiguous())
    ugrid = _k_apply(op, grid)
    u = se_interp_rows_pre(geom, pieces, pos.shape[0], ugrid.to(forces.dtype))
    return u, pieces[1]


def make_se_geometry_tiles(op: SpectralEwaldRPY, n_particles: int,
                           capacity_slack: float = 1.15) -> SEGridTiles:
    """3D-tile gridding geometry: occupancy bounded locally on all three
    axes."""
    return make_se_grid_tiles(op.grid_n, op.support, op.base.box, op.base.xi, op.eta,
                              n_particles, capacity_slack=capacity_slack,
                              kind=op.window, beta=op.es_beta)


def se_bin_geom(geom, pos: torch.Tensor, dtype=torch.float32):
    """Binning of either dense-gridding geometry, the 3D tiles or the
    (y, z) rows (overflow at pieces[1] in both)."""
    if isinstance(geom, SEGridRows):
        return se_bin_dense(geom, pos, dtype)
    return se_bin_tiles(geom, pos, dtype)


def se_wave_apply_dense(op: SpectralEwaldRPY, geom, pos: torch.Tensor,
                        forces: torch.Tensor, pieces=None):
    """Wave-space sum through a dense gridding: on the 3D tiles K5s, the
    FFT mode product and K5i; on the (y, z) rows the plain dense trio
    (se_spread_dense / se_interp_dense, one matrix product per row).
    Returns (u (N, 3), overflow); `pieces` from se_bin_geom reuses one
    binning across applies at fixed positions."""
    if pieces is None:
        pieces = se_bin_geom(geom, pos, forces.dtype)
    if isinstance(geom, SEGridRows):
        grid = se_spread_dense(geom, pieces, forces)
        u = se_interp_dense(geom, pieces, pos.shape[0], _k_apply(op, grid).to(forces.dtype))
        return u, pieces[1]
    # K5s reads contiguous forces; K3's (N, 3) sums of a single body block
    # come out as a transposed view
    grid = se_spread_tiles(geom, pieces, forces.contiguous())
    ugrid = _k_apply(op, grid)  # the inverse FFT's strides: the channel axis outermost
    u = se_interp(geom, pieces, ugrid.to(forces.dtype))  # K5i reads that layout
    return u, pieces[1]


def se_rpy_apply_cells(op: SpectralEwaldRPY, cells, pos: torch.Tensor,
                       forces: torch.Tensor, box_lengths, geom: SEGridTiles, pieces=None):
    """Full periodic RPY product: the real-space correction on the 3D cells
    (self term included) plus the wave sum. `cells` from build_cells3d
    (edge >= r_cut) or build_cells3d_split (the density-split engine).
    Returns (u, overflow): the SE binning's flag, which callers must fold
    into their sticky overflow (a dropped slot leaves the wave sum)."""
    from mundy_tpu_torch.neighbor.cells3d import CellsSplitState, pair_apply_cells3d_split

    if isinstance(cells, CellsSplitState):
        u = pair_apply_cells3d_split(cells, box_lengths, forces,
                                     rpy_real_cells_kernel(op.base), 3)
    else:
        u = ewald_real_apply_cells(op.base, cells, forces, box_lengths)
    uw, ovf = se_wave_apply_dense(op, geom, pos, forces, pieces=pieces)
    return u + uw, ovf


def se_rpy_apply(op: SpectralEwaldRPY, pos: torch.Tensor, forces: torch.Tensor, nmat,
                 metric) -> torch.Tensor:
    """Full periodic RPY product through the scatter gridding (small N):
    the real-space correction over a neighbor matrix (cutoff >= r_cut), the
    wave sum and the self term. (N, 3)."""
    u = ewald_real_apply(op.base, pos, forces, nmat, metric)
    return u + se_wave_apply(op, pos, forces) + op.base.self_coeff * forces
