"""Rotne-Prager-Yamakawa mobility of equal spheres.

Port of mundy_tpu/mobility/rpy.py (ref: `RPYKernel::operator()`,
`StkNgpLCP.cpp:296-360`): per target-source pair r = x_t - x_s,

    u += 1/(8 pi mu) [f/r + r (f.r)/r^3 + (2a^2/3)(f/r^3 - 3 r (f.r)/r^5)],

with the regularized overlap branch for r < 2a (Rotne & Prager 1969)
    u += 1/(6 pi mu a) [(1 - 9r/32a) f + (3/32a) (f.r) r / r]
and the self term 1/(6 pi mu a) f. Three applies: over a neighbor matrix
(HYDRO_NEAREST), over all pairs in chunks of targets (HYDRO_ALL, the
periphery modes' ambient flow), and at off-particle points (the flow at the
periphery's quadrature nodes).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from mundy_tpu_torch.geom.periodicity import Metric

_EPS = 1e-12


def rpy_self_mobility(forces: torch.Tensor, radius, viscosity) -> torch.Tensor:
    """Self term U = F / (6 pi mu a) (`StkNgpLCP.cpp:620-624`)."""
    return forces / (6.0 * math.pi * viscosity * radius)


def _rpy_pair_velocity(rvec: torch.Tensor, f: torch.Tensor, radius, viscosity,
                       overlap_correction: bool) -> torch.Tensor:
    """Velocity at the target from one source, batched over the leading
    axes; rvec = x_target - x_source."""
    scale = 1.0 / (8.0 * math.pi * viscosity)
    a2_3 = radius * radius / 3.0
    r2 = (rvec * rvec).sum(-1)
    near_zero = r2 < _EPS
    rinv = torch.where(near_zero, 0.0, torch.rsqrt(torch.clamp(r2, min=_EPS)))
    rinv3 = rinv * rinv * rinv
    rinv5 = rinv * rinv * rinv3
    fdotr = (f * rvec).sum(-1)
    c = f * rinv3[..., None] - (3.0 * fdotr * rinv5)[..., None] * rvec
    far = scale * (f * rinv[..., None] + (fdotr * rinv3)[..., None] * rvec + (2.0 * a2_3) * c)
    if not overlap_correction:
        return far
    r = r2 * rinv  # |r| (0 when near_zero)
    inv6 = 1.0 / (6.0 * math.pi * viscosity * radius)
    iso = (1.0 - 9.0 * r / (32.0 * radius))[..., None] * f
    rr = (3.0 / (32.0 * radius)) * fdotr * rinv
    near = inv6 * (iso + torch.where(near_zero, 0.0, rr)[..., None] * rvec)
    return torch.where((r < 2.0 * radius)[..., None], near, far)


def rpy_apply_neighbors(pos: torch.Tensor, forces: torch.Tensor, nmat, radius,
                        viscosity, metric: Optional[Metric] = None,
                        include_self: bool = True,
                        overlap_correction: bool = False) -> torch.Tensor:
    """U = M F restricted to the neighbor matrix (idx, mask). (N, 3)."""
    n = pos.shape[0]
    idx = torch.clamp(nmat.idx, max=n - 1).long()
    pj = pos[idx]
    fj = forces[idx]
    if metric is None:
        rvec = pos[:, None, :] - pj
    else:
        rvec = -metric.sep(pos[:, None, :], pj)
    u = _rpy_pair_velocity(rvec, fj, radius, viscosity, overlap_correction)
    out = torch.where(nmat.mask[..., None], u, 0.0).sum(1)
    if include_self:
        out = out + rpy_self_mobility(forces, radius, viscosity)
    return out


def rpy_apply_dense(pos: torch.Tensor, forces: torch.Tensor, radius, viscosity,
                    metric: Optional[Metric] = None, include_self: bool = True,
                    overlap_correction: bool = False, chunk: int = 1024) -> torch.Tensor:
    """U = M F over all pairs, a loop over chunks of `chunk` targets, each
    against every source at once (the reference's lax.map over target
    chunks, `apply_rpy_kernel` + panelize, `StkNgpLCP.cpp:370-390`). The
    self pair is masked (the overlap branch at r = 0 would give the self
    term again); the self term is added under `include_self`. (N, 3)."""
    n = pos.shape[0]
    src = torch.arange(n, device=pos.device)
    parts = []
    for start in range(0, n, chunk):
        tgt = pos[start:start + chunk]
        if metric is None:
            rvec = tgt[:, None, :] - pos[None, :, :]
        else:
            rvec = -metric.sep(tgt[:, None, :], pos[None, :, :])
        u = _rpy_pair_velocity(rvec, forces[None, :, :], radius, viscosity,
                               overlap_correction)
        same = (start + torch.arange(tgt.shape[0], device=pos.device))[:, None] == src[None, :]
        parts.append(torch.where(same[..., None], 0.0, u).sum(1))
    u = torch.cat(parts)
    if include_self:
        u = u + rpy_self_mobility(forces, radius, viscosity)
    return u


def rpy_flow_at(targets: torch.Tensor, pos: torch.Tensor, forces: torch.Tensor, radius,
                viscosity, chunk: int = 1024) -> torch.Tensor:
    """Ambient RPY flow at off-particle points (T, 3): u(x_t) = sum_b
    M(x_t - x_b) f_b with the overlap branch and no self term, in chunks of
    targets; the flow the periphery BIE needs at its quadrature nodes (ref
    `HP1...neigh_linker.cpp:1487-1493`)."""
    parts = []
    for start in range(0, targets.shape[0], chunk):
        rvec = targets[start:start + chunk, None, :] - pos[None, :, :]
        u = _rpy_pair_velocity(rvec, forces[None, :, :], radius, viscosity,
                               overlap_correction=True)
        parts.append(u.sum(1))
    return torch.cat(parts)
