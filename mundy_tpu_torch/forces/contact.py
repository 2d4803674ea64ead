"""Pairwise contact forces over the dense neighbor matrix.

Port of mundy_tpu/forces/contact.py (ref: SphereSphereHertzianContact.cpp
:188-215 and the WCA kernels of evaluate_linker_potentials). Each particle
sums its own force over its neighbor row, a one-sided sum: no scatter, no
atomics, the same result on every run.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from mundy_tpu_torch.geom.periodicity import Metric

_EPS = 1e-12


def hertzian_pair_force(sep: torch.Tensor, r_eff: torch.Tensor,
                        e_eff: torch.Tensor) -> torch.Tensor:
    """Hertz normal force magnitude F = 4/3 E* sqrt(R*) delta^{3/2}.

    `sep` is the signed surface separation (negative = overlap, delta = -sep);
    `r_eff` and `e_eff` are tensors in sep's dtype, as in the reference.
    """
    delta = torch.clamp(-sep, min=0.0)
    return (4.0 / 3.0) * e_eff * torch.sqrt(r_eff) * delta * torch.sqrt(delta)


def wca_pair_force(r: torch.Tensor, sigma, epsilon) -> torch.Tensor:
    """WCA (shifted-truncated LJ) force magnitude along the center line,
    positive = repulsive; zero beyond the 2^(1/6) sigma cutoff."""
    cutoff = (2.0 ** (1.0 / 6.0)) * sigma
    r_safe = torch.clamp(r, min=1e-6 * sigma)
    sr6 = (sigma / r_safe) ** 6
    f = 24.0 * epsilon * (2.0 * sr6 * sr6 - sr6) / r_safe
    return torch.where(r < cutoff, f, 0.0)


def effective_radius(r1, r2):
    return (r1 * r2) / (r1 + r2)


def effective_youngs(e1, e2, nu1, nu2):
    return (e1 * e2) / (e2 - e2 * nu1 * nu1 + e1 - e1 * nu2 * nu2)


def _pair_scalar(x: torch.Tensor, idx: torch.Tensor):
    """(value_i (N, 1), value_j (N, K)) for a per-particle scalar field."""
    return x[:, None], x[idx]


def contact_forces(pos: torch.Tensor, radius, nmat,
                   pair_force_mag: Callable, metric: Optional[Metric] = None,
                   sources: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Central-force accumulation over the neighbor matrix `nmat` (idx, mask).

    pair_force_mag(signed_sep, idx_i, idx_j) -> magnitude (positive =
    repulsive along the i->j normal); `radius` a python scalar or an (N,)
    tensor. Returns (N, 3) forces. `sources` (S, 3): the bodies that nmat's
    ids name when the rows are a subset of them (a rank's own rows against
    the gathered positions; a uniform radius only); default pos."""
    src = pos if sources is None else sources
    n = src.shape[0]
    idx = torch.clamp(nmat.idx, max=n - 1).long()  # clamp padding
    pj = src[idx]  # (N, K, 3)
    if metric is None:
        sepv = pj - pos[:, None, :]
    else:
        sepv = metric.sep(pos[:, None, :], pj)
    r2 = torch.clamp((sepv * sepv).sum(-1), min=_EPS * _EPS)
    rinv = torch.rsqrt(r2)
    d = r2 * rinv
    if isinstance(radius, torch.Tensor) and radius.ndim > 0:
        if sources is not None:
            raise ValueError("contact_forces(sources=) takes a uniform radius")
        r_i, r_j = _pair_scalar(radius, idx)
        signed_sep = d - r_i - r_j
    else:
        signed_sep = d - 2.0 * radius
    mag = pair_force_mag(signed_sep, torch.arange(pos.shape[0], device=pos.device)[:, None], idx)
    mag = torch.where(nmat.mask, mag, 0.0)
    # repulsive: force on i points away from j
    return -((mag * rinv)[..., None] * sepv).sum(1)


def _is_uniform(x) -> bool:
    """True for python and 0-d scalars (the per-particle gathers are
    skipped)."""
    return not (isinstance(x, torch.Tensor) and x.ndim > 0)


def hertzian_contact_forces(pos: torch.Tensor, radius, youngs, poisson, nmat,
                            metric: Optional[Metric] = None,
                            sources: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Hertzian sphere-sphere contact over the neighbor matrix. (N, 3).
    `sources`: as contact_forces' (uniform radius, youngs and poisson only).

    Uniform (python or 0-d) radius, youngs and poisson take the reference's
    gather-free branch. Per-particle (N,) values take its packed branch:
    R* = r_i r_j / (r_i + r_j) and E* = m_i m_j / (m_i + m_j) with the
    plane-strain modulus m = E / (1 - nu^2). The constants round to pos's
    dtype as the reference's do; pass them as tensors on pos's device to
    keep host copies out of a step."""
    kw = dict(dtype=pos.dtype, device=pos.device)
    r = torch.as_tensor(radius, **kw)
    e, nu = torch.as_tensor(youngs, **kw), torch.as_tensor(poisson, **kw)
    if r.ndim == 0 and e.ndim == 0 and nu.ndim == 0:
        r_eff = 0.5 * r
        e_eff = effective_youngs(e, e, nu, nu)

        def mag(signed_sep, i, j):
            return hertzian_pair_force(signed_sep, r_eff, e_eff)

        return contact_forces(pos, r, nmat, mag, metric, sources=sources)

    if sources is not None:
        raise ValueError("hertzian_contact_forces(sources=) takes uniform radius, youngs "
                         "and poisson")
    n = pos.shape[0]
    r, e, nu = (torch.broadcast_to(v, (n,)) for v in (r, e, nu))
    params = torch.stack([r, e / (1.0 - nu * nu)], dim=1)

    def mag_packed(signed_sep, i, j):
        pi = params[i[:, 0]]  # (N, 2)
        pj = params[torch.clamp(j, max=n - 1)]  # (N, K, 2)
        r_eff = effective_radius(pi[:, None, 0], pj[..., 0])
        m_i, m_j = pi[:, None, 1], pj[..., 1]
        e_eff = (m_i * m_j) / torch.clamp(m_i + m_j, min=_EPS)
        return hertzian_pair_force(signed_sep, r_eff, e_eff)

    return contact_forces(pos, r, nmat, mag_packed, metric)


def wca_contact_forces(pos: torch.Tensor, radius, epsilon, nmat,
                       metric: Optional[Metric] = None) -> torch.Tensor:
    """WCA contact over the neighbor matrix with sigma = r_i + r_j (contact
    at center distance sigma) and epsilon_ij = sqrt(epsilon_i epsilon_j).
    (N, 3). Uniform (python or 0-d) radius and epsilon take the reference's
    gather-free branch; per-particle (N,) values its packed one."""
    n = pos.shape[0]
    if _is_uniform(radius) and _is_uniform(epsilon):

        def mag(signed_sep, i, j):
            sigma = 2.0 * radius
            return wca_pair_force(signed_sep + sigma, sigma, epsilon)

        return contact_forces(pos, radius, nmat, mag, metric)

    kw = dict(dtype=pos.dtype, device=pos.device)
    r = torch.broadcast_to(torch.as_tensor(radius, **kw), (n,))
    params = torch.stack([r, torch.broadcast_to(torch.as_tensor(epsilon, **kw), (n,))], dim=1)

    def mag_packed(signed_sep, i, j):
        pi = params[i[:, 0]]
        pj = params[torch.clamp(j, max=n - 1)]
        sigma = pi[:, None, 0] + pj[..., 0]
        eps_pair = torch.sqrt(pi[:, None, 1] * pj[..., 1])
        return wca_pair_force(signed_sep + sigma, sigma, eps_pair)

    return contact_forces(pos, r, nmat, mag_packed, metric)
