"""Ewald-split periodic RPY mobility (the long-range Stokes path).

Port of mundy_tpu/mobility/ewald.py. The split (Hasimoto screening):

    M(k) = (I - k_hat k_hat) sinc^2(k a) / (eta k^2)      exact RPY in k
    H(k) = (1 + k^2/(4 xi^2)) exp(-k^2/(4 xi^2))          splitting window
    wave part  = lattice sum over k != 0 of M(k) H(k)
    real part  = RPY(r) - W(r),  W = continuum FT^-1[M H]

The window scalars W are computed once on the host in float64 by radial
quadrature, tabulated and fitted by Chebyshev series; the self term
replaces W(0) by the true 1/(6 pi eta a). The direct sum
(`ewald_rpy_apply`: the real part over a neighbor matrix, the wave part as
dense products over k-mode chunks, the self term) serves the LCP app's
`rpy_ewald` mode; the spectral-Ewald path (mobility/spectral.py) reads the
real-space pieces and grids the wave part instead.
"""

from __future__ import annotations

import concurrent.futures
import math
from typing import NamedTuple, Optional

import numpy as np
import torch

_WINDOW_BLOCK = 8  # radii per block of _window_scalars


class EwaldRPY(NamedTuple):
    """Precomputed periodic RPY operator pieces."""

    box: float
    radius: float
    viscosity: float
    xi: float
    r_cut: float
    # real-space correction tables R(r) = RPY(r) - W(r): iso + rr scalars
    table_r: torch.Tensor  # (T,) radii
    table_f: torch.Tensor  # (T,) isotropic scalar
    table_g: torch.Tensor  # (T,) r_hat r_hat scalar
    # wave-space modes of the direct sum
    kvecs: torch.Tensor  # (K, 3)
    kcoeff: torch.Tensor  # (K,) M(k) H(k) / V
    self_coeff: float  # 1/(6 pi eta a) - W(0)
    # Chebyshev coefficients of the smooth window scalars fw, gw on [0, r_cut]
    cheb_fw: tuple = ()
    cheb_gw: tuple = ()


def _rpy_scalars(r, a, eta):
    """Exact free-space RPY scalars: M = f I + g rr_hat (r > 0), with the
    overlap-corrected branch for r < 2a."""
    r = np.asarray(r, np.float64)
    c = 1.0 / (8 * np.pi * eta * r)
    far_f = c * (1 + (2 * a * a) / (3 * r * r))
    far_g = c * (1 - (2 * a * a) / (r * r))
    c6 = 1.0 / (6 * np.pi * eta * a)
    near_f = c6 * (1 - 9 * r / (32 * a))
    near_g = c6 * (3 * r / (32 * a))
    f = np.where(r < 2 * a, near_f, far_f)
    g = np.where(r < 2 * a, near_g, far_g)
    return f, g


def _window_scalars(r_grid, a, eta, xi, kmax=None, nk=20000):
    """W(r) = continuum FT^-1 of M(k) H(k) = fw(r) I + gw(r) rr_hat:
        fw(r) = (1/2 pi^2) int dk k^2 K(k) (j0(x) - j1(x)/x)
        gw(r) = (1/2 pi^2) int dk k^2 K(k) (3 j1(x)/x - j0(x)),  x = k r
    with K(k) = sinc^2(ka) H(k) / (eta k^2), by the trapezoid rule (the H
    window damps the integrand like a Gaussian). Blocks of radii at once,
    on torch's intra-op thread count (numpy's ufuncs release the GIL); each radius
    takes the reference's per-radius operations in their order, the
    trapezoid as a row sum, so the values are the reference's bit for bit."""
    if kmax is None:
        kmax = 14.0 * xi  # e^{-(kmax/2xi)^2} ~ 3e-22
    r_grid = np.asarray(r_grid, np.float64)
    k = np.linspace(1e-8, kmax, nk)
    sinc_ka = np.sinc(k * a / np.pi)
    H = (1 + k**2 / (4 * xi**2)) * np.exp(-(k**2) / (4 * xi**2))
    k2K = k**2 * (sinc_ka**2 * H / (eta * k**2))
    dk = np.diff(k)
    pref = 1.0 / (2 * np.pi**2)
    fw = np.empty_like(r_grid)
    gw = np.empty_like(r_grid)

    def trapz(y):
        return (dk * (y[..., 1:] + y[..., :-1]) / 2.0).sum(axis=-1)

    def block(i0):
        rb = r_grid[i0:i0 + _WINDOW_BLOCK]
        zero = rb < 1e-12  # j0 -> 1, j1/x -> 1/3
        x = k[None, :] * np.where(zero, 1.0, rb)[:, None]
        j0 = np.sin(x) / x
        j1_over_x = (j0 - np.cos(x)) / (x * x)
        fw[i0:i0 + len(rb)] = np.where(zero, pref * trapz(k2K * (2.0 / 3.0)),
                                       pref * trapz(k2K * (j0 - j1_over_x)))
        gw[i0:i0 + len(rb)] = np.where(zero, 0.0, pref * trapz(k2K * (3 * j1_over_x - j0)))

    starts = range(0, len(r_grid), _WINDOW_BLOCK)
    threads = torch.get_num_threads()
    if threads > 1:
        with concurrent.futures.ThreadPoolExecutor(threads) as pool:
            list(pool.map(block, starts))
    else:
        for i0 in starts:
            block(i0)
    return fw, gw


def build_ewald_rpy(box: float, radius: float, viscosity: float,
                    xi: Optional[float] = None, r_cut: Optional[float] = None,
                    tol: float = 1e-6, table_points: int = 2048,
                    dtype=torch.float32, device=None) -> EwaldRPY:
    """Tables, Chebyshev fits and k-mode coefficients (host, float64), as
    tensors of `dtype` on `device`. The real-space part must be paired with
    a neighbor structure whose cutoff is >= r_cut."""
    if xi is None:
        xi = 3.0 / (0.25 * box)  # r_cut ~ box/4 by default
    s = math.sqrt(max(math.log(1.0 / tol), 1.0))
    if r_cut is None:
        r_cut = s / xi
    r_cut = min(r_cut, 0.49 * box)

    r_grid = np.linspace(0.0, r_cut, table_points)
    f_rpy = np.empty_like(r_grid)
    g_rpy = np.empty_like(r_grid)
    f_rpy[0] = 1.0 / (6 * np.pi * viscosity * radius)
    g_rpy[0] = 0.0
    f_rpy[1:], g_rpy[1:] = _rpy_scalars(r_grid[1:], radius, viscosity)
    fw, gw = _window_scalars(r_grid, radius, viscosity, xi)
    table_f = f_rpy - fw
    table_g = g_rpy - gw

    # direct-sum wave modes |k| <= kmax = 2 xi s
    kmax = 2.0 * xi * s
    mmax = int(np.ceil(kmax * box / (2 * np.pi)))
    rng = np.arange(-mmax, mmax + 1)
    mx, my, mz = np.meshgrid(rng, rng, rng, indexing="ij")
    m = np.stack([mx.ravel(), my.ravel(), mz.ravel()], axis=1).astype(np.float64)
    del mx, my, mz
    kv = (2 * np.pi / box) * m
    del m
    k2 = np.sum(kv * kv, axis=1)
    keep = (k2 > 0) & (k2 <= kmax * kmax)
    kv = kv[keep]
    k2 = k2[keep]
    kn = np.sqrt(k2)
    sinc_ka = np.sinc(kn * radius / np.pi)
    H = (1 + k2 / (4 * xi**2)) * np.exp(-k2 / (4 * xi**2))
    kcoeff = sinc_ka**2 * H / (viscosity * k2) / box**3

    self_coeff = 1.0 / (6 * np.pi * viscosity * radius) - fw[0]

    # Chebyshev interpolants of the smooth window scalars, from values at
    # Chebyshev nodes (a finer quadrature than the tables)
    D = 16
    xk = np.cos(np.pi * (np.arange(D + 1) + 0.5) / (D + 1))
    rk = 0.5 * (xk + 1) * r_cut
    fwk, gwk = _window_scalars(rk, radius, viscosity, xi, nk=200000)
    from numpy.polynomial import chebyshev as _C
    cheb_fw = tuple(float(c) for c in _C.chebfit(xk, fwk, D))
    cheb_gw = tuple(float(c) for c in _C.chebfit(xk, gwk, D))

    def t(a):
        return torch.as_tensor(a, dtype=dtype, device=device)

    return EwaldRPY(box=float(box), radius=float(radius), viscosity=float(viscosity),
                    xi=float(xi), r_cut=float(r_cut), table_r=t(r_grid),
                    table_f=t(table_f), table_g=t(table_g), kvecs=t(kv),
                    kcoeff=t(kcoeff), self_coeff=float(self_coeff),
                    cheb_fw=cheb_fw, cheb_gw=cheb_gw)


def _clenshaw(coeffs: tuple, x: torch.Tensor) -> torch.Tensor:
    """Chebyshev series with python-float coefficients: the reference's
    recurrence b1 <- (2 x) b1 - b2 + c_k, rounded step for step as there,
    with one new pair-block tensor per step (the others update in place)."""
    x2 = 2.0 * x
    b1 = torch.full_like(x, coeffs[-1])  # the first step: 0 - 0 + c_D
    b2 = torch.zeros_like(x)
    for k in range(len(coeffs) - 2, 0, -1):
        t = torch.mul(x2, b1)
        b1, b2 = t.sub_(b2).add_(coeffs[k]), b1
    return torch.mul(x, b1).sub_(b2).add_(coeffs[0])


def real_scalars(op: EwaldRPY, r: torch.Tensor, rinv: torch.Tensor):
    """Real-space correction scalars R(r) = RPY(r) - W(r): the RPY branches
    (kink at r = 2a) analytic, the smooth window from the Chebyshev fits,
    zero beyond r_cut."""
    a = op.radius
    eta = op.viscosity
    c8 = rinv / (8 * math.pi * eta)
    a2 = a * a
    far_f = c8 * (1 + (2.0 / 3.0) * a2 * rinv * rinv)
    far_g = c8 * (1 - 2.0 * a2 * rinv * rinv)
    c6 = 1.0 / (6 * math.pi * eta * a)
    near_f = c6 * (1 - 9.0 * r / (32.0 * a))
    near_g = c6 * (3.0 * r / (32.0 * a))
    near = r < 2 * a
    f_rpy = torch.where(near, near_f, far_f)
    g_rpy = torch.where(near, near_g, far_g)
    x = 2.0 * r / op.r_cut - 1.0
    fw = _clenshaw(op.cheb_fw, x)
    gw = _clenshaw(op.cheb_gw, x)
    inside = r < op.r_cut
    return torch.where(inside, f_rpy - fw, 0.0), torch.where(inside, g_rpy - gw, 0.0)


def rpy_real_cells_kernel(op: EwaldRPY):
    """The real-space RPY pair kernel in neighbor/cells3d.pair_apply_cells3d's
    contract: kernel(DX, DY, DZ, r2, pj) over (rows, nz, C, S) pair blocks
    with (rows, nz, S, 3) source forces -> (rows, nz, C, 3) velocities."""
    if not op.cheb_fw:
        raise ValueError("rpy_real_cells_kernel needs the Chebyshev window "
                         "coefficients (rebuild the operator)")

    def kernel(DX, DY, DZ, r2, pj):
        r2c = torch.clamp(r2, min=1e-24)
        rinv = torch.rsqrt(r2c)
        r = r2c * rinv
        f, g = real_scalars(op, r, rinv)
        fx = pj[..., None, :, 0]
        fy = pj[..., None, :, 1]
        fz = pj[..., None, :, 2]
        rdotf = (DX * fx + DY * fy + DZ * fz) * (rinv * rinv)
        grf = g * rdotf
        ux = (f * fx + grf * DX).sum(-1)
        uy = (f * fy + grf * DY).sum(-1)
        uz = (f * fz + grf * DZ).sum(-1)
        return torch.stack([ux, uy, uz], dim=-1)

    return kernel


def ewald_real_apply_cells(op: EwaldRPY, cells, forces: torch.Tensor,
                           box_lengths) -> torch.Tensor:
    """Real-space correction over the dense 3D cells (edge >= r_cut),
    including the self term: the self pair's sep = 0 contribution is exactly
    self_coeff * F_i, so callers must not add it again."""
    from mundy_tpu_torch.neighbor.cells3d import (
        gather_from_flat,
        pair_apply_cells3d,
        scatter_to_flat,
    )

    payload = gather_from_flat(cells, forces)
    u = pair_apply_cells3d(cells, box_lengths, payload, rpy_real_cells_kernel(op), 3)
    return scatter_to_flat(cells, u, forces.shape[0])


def _interp_tables(op: EwaldRPY, r: torch.Tensor):
    """Linear interpolation of the tabulated real-space correction scalars,
    zero beyond r_cut (the operator's path when it has no Chebyshev fits)."""
    n_t = op.table_r.shape[0]
    t = r / op.r_cut * (n_t - 1)
    i0 = torch.clamp(t.to(torch.int32), 0, n_t - 2).to(torch.int64)
    w = t - i0
    f = op.table_f[i0] * (1 - w) + op.table_f[i0 + 1] * w
    g = op.table_g[i0] * (1 - w) + op.table_g[i0 + 1] * w
    inside = r < op.r_cut
    return torch.where(inside, f, 0.0), torch.where(inside, g, 0.0)


def ewald_wave_apply(op: EwaldRPY, pos: torch.Tensor, forces: torch.Tensor,
                     chunk_k: int = 4096) -> torch.Tensor:
    """Wave-space sum as dense products over chunks of chunk_k k-modes:

        u_i = sum_k c(k) (I - khat khat) [cos(k.x_i) Sc(k) + sin(k.x_i) Ss(k)]

    with Sc = sum_j cos(k.x_j) f_j, Ss = sum_j sin(k.x_j) f_j; each row adds
    the chunks in mode order, as the reference does. The products need full
    float32 (the reference pins its matmuls to the highest precision: bf16
    products left a 2.9e-3 relative error in this sum), so a float32 call on
    the card raises while TF32 is allowed."""
    if (forces.is_cuda and forces.dtype == torch.float32
            and torch.backends.cuda.matmul.allow_tf32):
        raise RuntimeError("the Ewald wave sum needs full float32 products: "
                           "torch.backends.cuda.matmul.allow_tf32 is on")
    u = torch.zeros_like(forces)
    for c0 in range(0, op.kvecs.shape[0], chunk_k):
        kvc = op.kvecs[c0:c0 + chunk_k]
        kcc = op.kcoeff[c0:c0 + chunk_k]
        k2 = torch.clamp((kvc * kvc).sum(1), min=1e-30)
        phase = pos @ kvc.T  # (n, Kc)
        cosp = torch.cos(phase)
        sinp = torch.sin(phase)
        # project the structure factors transverse per mode: P f = f - khat (khat . f)
        fk_c = cosp.T @ forces  # (Kc, 3)
        fk_s = sinp.T @ forces
        kdotc = (kvc * fk_c).sum(1) / k2
        kdots = (kvc * fk_s).sum(1) / k2
        tc = (fk_c - kdotc[:, None] * kvc) * kcc[:, None]
        ts = (fk_s - kdots[:, None] * kvc) * kcc[:, None]
        u = u + cosp @ tc + sinp @ ts
    return u


def ewald_real_apply(op: EwaldRPY, pos: torch.Tensor, forces: torch.Tensor, nmat,
                     metric, hbm_budget_bytes: float = 1.0e9) -> torch.Tensor:
    """Real-space correction over a neighbor matrix whose cutoff is >=
    r_cut, chunked over particles so that the ~8 live (chunk, K, 3) pair
    temporaries stay within hbm_budget_bytes. The scalars come from the
    Chebyshev fits, or from the tables when the operator has none."""
    n, k = nmat.idx.shape
    pf = torch.cat([pos, forces], dim=1)  # (N, 6): one row gather per pair
    use_cheb = len(op.cheb_fw) > 0

    def apply_rows(idx_c, mask_c, pos_c):
        pfj = pf[torch.clamp(idx_c, max=n - 1).to(torch.int64)]  # (rows, K, 6)
        rvec = metric.sep(pfj[..., :3], pos_c[:, None, :])  # from j toward i
        fj = pfj[..., 3:]
        r2 = torch.clamp((rvec * rvec).sum(-1), min=1e-24)
        rinv = torch.rsqrt(r2)
        r = r2 * rinv
        f, g = real_scalars(op, r, rinv) if use_cheb else _interp_tables(op, r)
        rdotf = (rvec * fj).sum(-1) * rinv * rinv
        u = f[..., None] * fj + (g * rdotf)[..., None] * rvec
        return torch.where(mask_c[..., None], u, 0.0).sum(1)

    chunk = int(hbm_budget_bytes // max(8 * k * 3 * pos.element_size(), 1))
    if chunk >= n:
        return apply_rows(nmat.idx, nmat.mask, pos)
    chunk = max(1024, (chunk // 1024) * 1024)
    return torch.cat([apply_rows(nmat.idx[s:s + chunk], nmat.mask[s:s + chunk],
                                 pos[s:s + chunk]) for s in range(0, n, chunk)])


def ewald_rpy_apply(op: EwaldRPY, pos: torch.Tensor, forces: torch.Tensor, nmat,
                    metric, chunk_k: int = 4096) -> torch.Tensor:
    """Full periodic RPY product: real + wave + self. (N, 3)."""
    u = ewald_real_apply(op, pos, forces, nmat, metric)
    u = u + ewald_wave_apply(op, pos, forces, chunk_k=chunk_k)
    return u + op.self_coeff * forces
