"""Spring-network forces over connectivity index arrays.

Port of mundy_tpu/forces/springs.py (ref: `HookeanSpringsKernel.cpp:137-166`,
`FENESpringsKernel.cpp:148-162`, `FENEWCASpringsKernel.cpp`,
`AngularSpringsKernel.cpp:144-170`). The reference's scatter-adds become
`index_put_(accumulate=True)`: on the card it sorts the targets and sums
each target's contributions in index order, so a bead that many
crosslinkers bind gets the same sum on every run (an `index_add_` would sum
repeated targets with atomics, in no fixed order).
"""

from __future__ import annotations

from typing import Optional

import torch

from mundy_tpu_torch.forces.contact import wca_pair_force
from mundy_tpu_torch.geom.periodicity import Metric
from mundy_tpu_torch.math.linalg import norm

_EPS = 1e-12


def _edge(pos, i, j, metric: Optional[Metric]):
    if metric is None:
        t = pos[j] - pos[i]
    else:
        t = metric.sep(pos[i], pos[j])
    L = torch.clamp(norm(t), min=_EPS)
    return t / L[..., None], L


def _scatter_pair(n: int, i: torch.Tensor, j: torch.Tensor,
                  f_on_j: torch.Tensor) -> torch.Tensor:
    """(n, 3): +f at j, -f at i, repeated targets summed in index order."""
    out = f_on_j.new_zeros((n, 3))
    out.index_put_((j.long(),), f_on_j, accumulate=True)
    out.index_put_((i.long(),), -f_on_j, accumulate=True)
    return out


def hookean_spring_forces(pos: torch.Tensor, i: torch.Tensor, j: torch.Tensor, k,
                          rest_length, mask: Optional[torch.Tensor] = None,
                          metric: Optional[Metric] = None) -> torch.Tensor:
    """F_on_j = -k (L - L0) t_hat(i->j). ref: HookeanSpringsKernel.cpp:146-166."""
    that, L = _edge(pos, i.long(), j.long(), metric)
    fmag = k * (L - rest_length)
    if mask is not None:
        fmag = torch.where(mask, fmag, 0.0)
    return _scatter_pair(pos.shape[0], i, j, -fmag[..., None] * that)


def fene_spring_forces(pos: torch.Tensor, i: torch.Tensor, j: torch.Tensor, k, r_max,
                       mask: Optional[torch.Tensor] = None, metric: Optional[Metric] = None,
                       epsilon_reg: float = 1e-4) -> torch.Tensor:
    """FENE attraction F = k L / (1 - (L / r_max)^2), L clamped below r_max
    - epsilon_reg. ref: FENESpringsKernel.cpp:148-162."""
    that, L = _edge(pos, i.long(), j.long(), metric)
    L_adj = torch.minimum(L, torch.as_tensor(r_max - epsilon_reg, dtype=L.dtype,
                                             device=L.device))
    fmag = k * L_adj / (1.0 - (L_adj / r_max) ** 2)
    if mask is not None:
        fmag = torch.where(mask, fmag, 0.0)
    return _scatter_pair(pos.shape[0], i, j, -fmag[..., None] * that)


def fenewca_spring_forces(pos: torch.Tensor, i: torch.Tensor, j: torch.Tensor, k, r_max,
                          sigma, epsilon, mask: Optional[torch.Tensor] = None,
                          metric: Optional[Metric] = None) -> torch.Tensor:
    """FENE bond plus WCA excluded volume on the same edge (the
    Kremer-Grest bond). ref: FENEWCASpringsKernel.cpp."""
    that, L = _edge(pos, i.long(), j.long(), metric)
    L_adj = torch.minimum(L, torch.as_tensor(r_max - 1e-4, dtype=L.dtype, device=L.device))
    fene = k * L_adj / (1.0 - (L_adj / r_max) ** 2)
    fmag = fene - wca_pair_force(L, sigma, epsilon)  # WCA positive = repulsive
    if mask is not None:
        fmag = torch.where(mask, fmag, 0.0)
    return _scatter_pair(pos.shape[0], i, j, -fmag[..., None] * that)


def fenewca_chain_forces(pos: torch.Tensor, beads_per_chain: int, k, r_max, sigma,
                         epsilon, metric: Optional[Metric] = None) -> torch.Tensor:
    """FENE-WCA (Kremer-Grest) backbone forces of contiguous chains: bead n
    bonds bead n+1 except at chain ends. Bond vectors are shifted slices and
    each bead sums its two bonds by two shifted adds, with the arithmetic of
    the reference per bond."""
    n = pos.shape[0]
    per = int(beads_per_chain)
    if metric is None:
        t = pos[1:] - pos[:-1]
    else:
        t = metric.sep(pos[:-1], pos[1:])
    L = torch.clamp(norm(t), min=_EPS)
    that = t / L[..., None]
    L_adj = torch.minimum(L, torch.as_tensor(r_max - 1e-4, dtype=L.dtype, device=L.device))
    fene = k * L_adj / (1.0 - (L_adj / r_max) ** 2)
    wca = wca_pair_force(L, sigma, epsilon)
    fmag = fene - wca
    valid = (torch.arange(n - 1, device=pos.device) + 1) % per != 0
    f_on_j = torch.where(valid[:, None], -fmag[..., None] * that, 0.0)
    zero = pos.new_zeros((1, 3))
    return torch.cat([zero, f_on_j]) - torch.cat([f_on_j, zero])


def angular_spring_forces(pos: torch.Tensor, i: torch.Tensor, j: torch.Tensor,
                          apex: torch.Tensor, k, rest_angle,
                          mask: Optional[torch.Tensor] = None,
                          metric: Optional[Metric] = None) -> torch.Tensor:
    """Three-body angular spring about `apex` (nodes i -- apex -- j): the
    cosine-harmonic torque tau = k (cos theta - cos theta0) with HOOMD's
    force distribution. ref: AngularSpringsKernel.cpp:144-170."""
    i, j, apex = i.long(), j.long(), apex.long()
    if metric is None:
        v1 = pos[i] - pos[apex]
        v2 = pos[j] - pos[apex]
    else:
        v1 = metric.sep(pos[apex], pos[i])
        v2 = metric.sep(pos[apex], pos[j])
    d1sq = torch.clamp((v1 * v1).sum(-1), min=_EPS)
    d2sq = torch.clamp((v2 * v2).sum(-1), min=_EPS)
    d1, d2 = torch.sqrt(d1sq), torch.sqrt(d2sq)
    cos_t = (v1 * v2).sum(-1) / (d1 * d2)
    tau = k * (cos_t - torch.cos(torch.as_tensor(rest_angle, dtype=pos.dtype,
                                                 device=pos.device)))
    if mask is not None:
        tau = torch.where(mask, tau, 0.0)
    a11 = tau * cos_t / d1sq
    a13 = -tau / (d1 * d2)
    a33 = tau * cos_t / d2sq
    f1 = a11[..., None] * v1 + a13[..., None] * v2
    f2 = a33[..., None] * v2 + a13[..., None] * v1
    out = pos.new_zeros((pos.shape[0], 3))
    out.index_put_((i,), f1, accumulate=True)
    out.index_put_((j,), f2, accumulate=True)
    out.index_put_((apex,), -(f1 + f2), accumulate=True)
    return out
