"""Free-space spectral Stokes: O(N log N) RPY mobility without periodicity.

Port of mundy_tpu/mobility/freespace.py (the confined-domain completion of
the PVFMM/STKFMM role, `TPLsList.cmake:29-30`, for the periphery-confined
HP1 geometry, `alens/src/mundy_alens/periphery/Periphery.hpp:1155`).

Method (Vico-Greengard kernel truncation, af Klinteberg-Tornberg free-space
Ewald): the Ewald screen split of the periodic operator, the short-range
part summed over neighbors, the smooth remainder G_l on a grid; but the
grid convolution runs on a zero-padded box with the truncated kernel K =
G_l 1_{|r| < L}, rolled off by a cos^2 taper over [E, L] (a hard cut at
the domain extent E rings at ~3e-3). Every pair lies within E <= L and the
padded period is >= E + L, so the circular convolution never wraps an image
into range. The kernel spectrum is the discrete transform of the sampled
kernel (host float64, once: a radial table of the window scalars, sampled
on the grid, 6 rfftn of the symmetric tensor); the analytic truncated
transform aliases a non-decaying cos(kL) tail into the resolved modes.

The gridding is the tile layout of the periodic operator (kernels K5s and
K5i, `make_se_geometry_tiles`) on the padded grid, where the reference
grids through its rows layout: the same sums in another order. The
scatter gridding of `spectral.se_spread` serves small N.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from mundy_tpu_torch.geom.periodicity import free_space
from mundy_tpu_torch.mobility.ewald import _window_scalars, ewald_real_apply
from mundy_tpu_torch.mobility.spectral import (
    SpectralEwaldRPY,
    build_spectral_ewald,
    make_se_geometry_tiles,
    se_bin_geom,
    se_interpolate,
    se_spread,
)
from mundy_tpu_torch.ops.kernels.se_grid import SEGridTiles
from mundy_tpu_torch.ops.kernels.se_grid import se_interp as se_interp_tiles
from mundy_tpu_torch.ops.kernels.se_grid import se_spread as se_spread_tiles


class FreeSpaceStokes(NamedTuple):
    se: SpectralEwaldRPY  # the spectral operator on the padded box
    khat: torch.Tensor  # (6, G, G, G//2+1) real discrete kernel spectrum (xx yy zz xy xz yz)
    trunc_L: float  # kernel truncation radius (>= the largest pair distance)
    origin: tuple  # the domain's least corner (the shift into the padded grid)
    extent: float  # the domain extent given to build_freespace_stokes


def build_freespace_stokes(domain: float, radius: float, viscosity: float,
                           origin=(0.0, 0.0, 0.0), extent: Optional[float] = None,
                           xi: Optional[float] = None, r_cut: Optional[float] = None,
                           tol: float = 1e-4, n_particles: Optional[int] = None,
                           dtype=torch.float32, device=None) -> FreeSpaceStokes:
    """The free-space operator for sources in [origin, origin + domain)^3,
    as tensors of `dtype` on `device`. `extent` is the largest
    source-target distance (default the cube diagonal; the sphere diameter
    for a periphery-confined cloud shrinks the padded grid from 2.73x to 2x
    per axis). The radial table runs on torch's intra-op threads."""
    E = float(extent) if extent is not None else math.sqrt(3.0) * domain
    L = 1.3 * E  # the taper runs over [E, L]
    pad = (domain + L) * 1.01  # P >= E + L, with 1% margin
    # the e^{-(xi r_cut)^2} truncation estimate is ~40x optimistic in the
    # aggregate: split for tol/50
    tol_split = tol / 50.0
    if xi is None and r_cut is None and n_particles is not None:
        spacing = domain / max(n_particles, 1) ** (1.0 / 3.0)
        r_cut = min(0.25 * domain, 3.5 * spacing)
        xi = math.sqrt(max(math.log(1.0 / tol_split), 1.0)) / r_cut
    elif xi is None:
        r_cut = r_cut if r_cut is not None else 0.25 * domain
        xi = math.sqrt(max(math.log(1.0 / tol_split), 1.0)) / r_cut
    # the sampled kernel keeps taper-tail content near Nyquist: a window
    # 4 points wider than the ES default
    s2 = max(math.log(1.0 / tol), 1.0)
    p_es = max(int(math.ceil(s2 / (math.pi * math.sqrt(1.0 - 1.0 / 1.5)))), 4)
    se = build_spectral_ewald(pad, radius, viscosity, xi=xi, r_cut=r_cut, tol=tol,
                              dtype=dtype, window="es", support=p_es + 4, device=device)

    # ---- the discrete kernel spectrum (host float64, once) ----
    G = se.grid_n
    P = se.base.box
    h = P / G
    rt = np.linspace(0.0, math.sqrt(3.0) * P / 2 + h, 4000)
    # nk = 200000: the trapezoid error of the 20000 default (~1e-4 relative
    # at r ~ 10) would bake into the spectrum
    fwt, gwt = _window_scalars(rt, radius, viscosity, se.base.xi, nk=200000)
    coord = np.arange(G) * h
    coord = np.where(coord > P / 2, coord - P, coord)
    axes = (coord[:, None, None], coord[None, :, None], coord[None, None, :])
    R = np.sqrt(axes[0] * axes[0] + axes[1] * axes[1] + axes[2] * axes[2])
    t = np.clip((R - E) / max(L - E, 1e-12), 0.0, 1.0)
    taper = np.cos(0.5 * np.pi * t) ** 2  # C^1 roll-off, 1 on r <= E
    del t
    fw = taper * np.interp(R, rt, fwt)
    gw = taper * np.interp(R, rt, gwt)
    del taper
    Rs = np.maximum(R, 1e-300)
    del R
    unit = [c / Rs for c in axes]
    del Rs
    comps = []
    for a, b in ((0, 0), (1, 1), (2, 2), (0, 1), (0, 2), (1, 2)):
        Kab = gw * unit[a] * unit[b]
        if a == b:
            Kab = Kab + fw
        Kab[0, 0, 0] = fwt[0] if a == b else 0.0
        spec = np.fft.rfftn(Kab).real
        del Kab
        comps.append(torch.as_tensor(np.ascontiguousarray(spec)).to(dtype=dtype, device=device))
        del spec
    return FreeSpaceStokes(se=se, khat=torch.stack(comps), trunc_L=float(L),
                           origin=tuple(float(o) for o in origin), extent=E)


def _k_apply_free(op: FreeSpaceStokes, grid: torch.Tensor) -> torch.Tensor:
    """FFT -> the discrete kernel spectrum times the window deconvolution,
    c_ab = khat_ab / (G^3 |w^|^2) -> inverse FFT. A float64 grid stays float64
    (the reference keeps it), any other runs in float32. The result keeps
    the inverse FFT's strides, the channel axis outermost, as K5i reads it."""
    se = op.se
    G = se.grid_n
    ft = grid.dtype if grid.dtype == torch.float64 else torch.float32
    fhat = torch.fft.rfftn(grid.to(ft), dim=(0, 1, 2))
    wkx, wkz = se.wk
    wprod = wkx[:, None, None] * wkx[None, :, None] * wkz[None, None, :]
    scale = 1.0 / (float(G) ** 3 * torch.clamp(wprod * wprod, min=1e-300))
    k = op.khat
    uhat = torch.stack([
        scale * (k[0] * fhat[..., 0] + k[3] * fhat[..., 1] + k[4] * fhat[..., 2]),
        scale * (k[3] * fhat[..., 0] + k[1] * fhat[..., 1] + k[5] * fhat[..., 2]),
        scale * (k[4] * fhat[..., 0] + k[5] * fhat[..., 1] + k[2] * fhat[..., 2]),
    ], dim=-1)
    ugrid = torch.fft.irfftn(uhat, s=(G, G, G), dim=(0, 1, 2))
    return ugrid * (se.base.box ** 3)


def _shift(op: FreeSpaceStokes, pos: torch.Tensor) -> torch.Tensor:
    return pos - torch.as_tensor(op.origin, dtype=pos.dtype, device=pos.device)[None, :]


def freespace_wave_apply(op: FreeSpaceStokes, pos: torch.Tensor,
                         forces: torch.Tensor) -> torch.Tensor:
    """The smooth remainder's sum on the padded grid through the scatter
    gridding (small N). (N, 3)."""
    p = _shift(op, pos)
    grid = se_spread(op.se, p, forces)
    ugrid = _k_apply_free(op, grid)
    return se_interpolate(op.se, p, ugrid.to(forces.dtype))


def freespace_wave_apply_dense(op: FreeSpaceStokes, geom: SEGridTiles, pos: torch.Tensor,
                               forces: torch.Tensor, pieces=None):
    """The smooth remainder's sum through the tile gridding: binning of the
    shifted positions, K5s, `_k_apply_free`, K5i. Returns (u (N, 3),
    overflow); `pieces` from se_bin_geom of the shifted positions reuses a
    binning."""
    p = _shift(op, pos)
    if pieces is None:
        pieces = se_bin_geom(geom, p, forces.dtype)
    grid = se_spread_tiles(geom, pieces, forces.contiguous())
    ugrid = _k_apply_free(op, grid)
    u = se_interp_tiles(geom, pieces, ugrid.to(forces.dtype))
    return u, pieces[1]


def freespace_rpy_apply(op: FreeSpaceStokes, pos: torch.Tensor, forces: torch.Tensor, nmat,
                        geom: Optional[SEGridTiles] = None, pieces=None):
    """The full free-space RPY product: the screened real-space part over
    the neighbor matrix (no metric), the wave part on the padded grid
    (through the tile gridding when `geom` is given, else the scatter
    gridding) and the self term. Returns (u, overflow): a binning overflow
    drops bodies from the wave sum, so callers fold the flag into their
    sticky overflow."""
    u = ewald_real_apply(op.se.base, pos, forces, nmat, free_space(pos.dtype, pos.device))
    ovf = torch.zeros((), dtype=torch.bool, device=pos.device)
    if geom is not None:
        uw, ovf = freespace_wave_apply_dense(op, geom, pos, forces, pieces=pieces)
        u = u + uw
    else:
        u = u + freespace_wave_apply(op, pos, forces)
    return u + op.se.base.self_coeff * forces, ovf


def freespace_geometry(op: FreeSpaceStokes, n_particles: int,
                       capacity_slack: float = 1.3) -> SEGridTiles:
    """The tile-gridding geometry of the padded grid (the reference gives
    its rows layout here)."""
    return make_se_geometry_tiles(op.se, n_particles, capacity_slack=capacity_slack)
