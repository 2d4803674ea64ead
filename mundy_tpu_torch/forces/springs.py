"""Spring-network forces over connectivity index arrays.

Port of the Hookean and FENE-WCA parts of mundy_tpu/forces/springs.py (ref:
`HookeanSpringsKernel.cpp:137-166`, `FENEWCASpringsKernel.cpp`). The
reference's scatter-adds become `index_put_(accumulate=True)`: on the card
it sorts the targets and sums each target's contributions in index order,
so a bead that many crosslinkers bind gets the same sum on every run (an
`index_add_` would sum repeated targets with atomics, in no fixed order).
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
