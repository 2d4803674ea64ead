"""No-slip periphery confinement by a dense boundary-integral method.

Port of mundy_tpu/mobility/periphery.py (ref: FastDirectPeriphery,
`alens/src/mundy_alens/periphery/Periphery.hpp:1155-2140`): a sphere shell
discretized by quadrature nodes enforces no-slip on the suspension inside.

1. quadrature (`gen_sphere_quadrature:90-150`): Gauss-Legendre in
   cos(theta) x a uniform ring in phi;
2. the second-kind Fredholm matrix M = T_PV - 1/2 I + N (`fill_skfie_matrix:
   1693-1742`): the Stokes double layer with singularity subtraction on the
   diagonal and the null-space completion N = n n^T w;
3. M^-1 once, in float64 on the host, cached on disk as a `.npy`
   (`build_inverse_self_interaction_matrix:2094`, `write_matrix_to_file:217`;
   the reference's file format, so either package reads the other's cache);
4. per step: the surface densities q = -M^-1 u_slip
   (`compute_surface_forces:2125-2140`), a full float32 (or float64) product
   on the device, then the double-layer flow of q at the beads.

Steps 1-3 are the reference's numpy code, kept here as the port's own copy.
"""

from __future__ import annotations

import os
from typing import NamedTuple, Optional

import numpy as np
import torch


def gen_sphere_quadrature(order: int, radius: float, center=(0.0, 0.0, 0.0)):
    """Spherical quadrature: Gauss-Legendre in cos(theta), uniform in phi.
    Returns (points (Q, 3), weights (Q,), inward normals (Q, 3)), float64
    numpy, Q = 2 (order + 1)^2."""
    if order < 1:
        raise ValueError("order must be >= 1")
    nodes, wts = np.polynomial.legendre.leggauss(order + 1)
    n_phi = 2 * (order + 1)
    phi = 2 * np.pi * np.arange(n_phi) / n_phi
    cos_t = nodes
    sin_t = np.sqrt(np.maximum(1 - cos_t**2, 0.0))

    pts, weights = [], []
    for ct, st, w in zip(cos_t, sin_t, wts):
        for p in phi:
            pts.append([st * np.cos(p), st * np.sin(p), ct])
            # area element: R^2 dcos(theta) dphi
            weights.append(w * (2 * np.pi / n_phi) * radius**2)
    pts = np.asarray(pts)
    weights = np.asarray(weights)
    normals = -pts  # inward: the shell encloses the suspension
    points = np.asarray(center) + radius * pts
    return points, weights, normals


def stokes_double_layer_matrix(src_pos, src_normals, weights, tgt_pos, viscosity,
                               self_surface: bool) -> np.ndarray:
    """(3T, 3S) double-layer matrix T[3t+i, 3s+j] = -3/(4 pi) r_i r_j (r.n_s)
    w_s / r^5, r = x_t - x_s (`fill_stokes_double_layer_matrix`); on the
    self surface the s == t blocks are zero (singularity subtraction fills
    them). The kernel does not depend on the viscosity: q is a velocity."""
    src_pos = np.asarray(src_pos, np.float64)
    tgt_pos = np.asarray(tgt_pos, np.float64)
    src_normals = np.asarray(src_normals, np.float64)
    weights = np.asarray(weights, np.float64)
    T = tgt_pos.shape[0]
    S = src_pos.shape[0]
    r = tgt_pos[:, None, :] - src_pos[None, :, :]  # (T, S, 3)
    r2 = np.sum(r * r, axis=-1)
    with np.errstate(divide="ignore", invalid="ignore"):
        rinv5 = np.where(r2 > 1e-24, r2 ** (-2.5), 0.0)
    rdotn = np.sum(r * src_normals[None, :, :], axis=-1)
    coeff = -(3.0 / (4.0 * np.pi)) * rdotn * rinv5 * weights[None, :]
    blocks = coeff[:, :, None, None] * r[:, :, :, None] * r[:, :, None, :]  # (T, S, 3, 3)
    if self_surface and T == S:
        idx = np.arange(T)
        blocks[idx, idx] = 0.0
    return blocks.transpose(0, 2, 1, 3).reshape(3 * T, 3 * S)


def skfie_matrix(src_pos, src_normals, weights) -> np.ndarray:
    """Second-kind Fredholm matrix M = T_PV - 1/2 I + N. With inward normals
    and r = target - source, D[c] = -c inside and 0 outside, so T_PV[c] =
    -c/2: the diagonal block is -1/2 I minus the off-diagonal row sum
    (constants exactly), and N = n_t n_s^T w_s completes the rigid-motion
    null space. M q = -u_ambient on the surface then extends to the no-slip
    correction inside."""
    S = np.asarray(src_pos).shape[0]
    T = stokes_double_layer_matrix(src_pos, src_normals, weights, src_pos,
                                   viscosity=1.0, self_surface=True)
    Tb = T.reshape(S, 3, S, 3)
    row_sum = Tb.sum(axis=2)  # (S, 3, 3)
    idx = np.arange(S)
    Tb[idx, :, idx, :] += -0.5 * np.eye(3)[None, :, :] - row_sum
    T = Tb.reshape(3 * S, 3 * S)

    n = np.asarray(src_normals, np.float64)
    w = np.asarray(weights, np.float64)
    N = (n[:, :, None, None] * n[None, None, :, :] * w[None, None, :, None])
    N = N.reshape(S, 3, S, 3).reshape(3 * S, 3 * S)
    return T - 0.5 * np.eye(3 * S) + N


class Periphery(NamedTuple):
    """The confinement operator, as tensors on one device."""

    points: torch.Tensor  # (Q, 3)
    normals: torch.Tensor  # (Q, 3) inward
    weights: torch.Tensor  # (Q,)
    m_inv: torch.Tensor  # (3Q, 3Q)


def build_sphere_periphery(order: int, radius: float, center=(0.0, 0.0, 0.0),
                           cache_path: Optional[str] = None, dtype=torch.float32,
                           device=None) -> Periphery:
    """Quadrature and M^-1 (float64 on the host; read from `cache_path` when
    it holds a matrix of the right shape, else computed and written there
    through a temporary file), as tensors of `dtype` on `device`."""
    pts, wts, nrm = gen_sphere_quadrature(order, radius, center)
    m_inv = None
    if cache_path is not None and os.path.exists(cache_path):
        m_inv = np.load(cache_path)
        if m_inv.shape != (3 * len(pts), 3 * len(pts)):
            m_inv = None
    if m_inv is None:
        m_inv = np.linalg.inv(skfie_matrix(pts, nrm, wts))
        if cache_path is not None:
            tmp = cache_path + ".tmp"
            np.save(tmp, m_inv)  # np.save appends .npy
            os.replace(tmp + ".npy" if not tmp.endswith(".npy") else tmp, cache_path)

    def t(a):
        return torch.as_tensor(a, dtype=dtype, device=device)

    return Periphery(points=t(pts), normals=t(nrm), weights=t(wts), m_inv=t(m_inv))


def surface_densities(periphery: Periphery, u_slip: torch.Tensor) -> torch.Tensor:
    """q = -M^-1 u_slip (`compute_surface_forces:2137`), (Q, 3) from the
    ambient velocity at the nodes (Q, 3). A full-precision product: the
    reference pins it to the highest precision (a bf16 product injects ~1e-2
    relative error into the no-slip balance), so a float32 call on the card
    raises while TF32 is allowed."""
    if (u_slip.is_cuda and u_slip.dtype == torch.float32
            and torch.backends.cuda.matmul.allow_tf32):
        raise RuntimeError("the periphery densities need full float32 products: "
                           "torch.backends.cuda.matmul.allow_tf32 is on")
    q = -torch.matmul(periphery.m_inv, u_slip.reshape(-1))
    return q.reshape(-1, 3)


def double_layer_flow(periphery: Periphery, q: torch.Tensor,
                      targets: torch.Tensor) -> torch.Tensor:
    """Correction flow at interior targets (T, 3) from the densities q:
    u(x_t) = -3/(4 pi) sum_s w_s (r.n_s)(r.q_s) r / r^5, r = x_t - x_s."""
    r = targets[:, None, :] - periphery.points[None, :, :]  # (T, Q, 3)
    r2 = (r * r).sum(-1)
    rinv5 = torch.where(r2 > 1e-24, r2 ** (-2.5), 0.0)
    rdotn = (r * periphery.normals[None, :, :]).sum(-1)
    rdotq = (r * q[None, :, :]).sum(-1)
    coeff = -(3.0 / (4.0 * np.pi)) * periphery.weights[None, :] * rdotn * rdotq * rinv5
    return (coeff[:, :, None] * r).sum(1)


def no_slip_correction(periphery: Periphery, ambient_at_surface: torch.Tensor,
                       targets: torch.Tensor) -> torch.Tensor:
    """The periphery correction at the targets: densities from the ambient
    slip at the nodes, then their double-layer flow. Total velocity =
    ambient + correction."""
    q = surface_densities(periphery, ambient_at_surface)
    return double_layer_flow(periphery, q, targets)
