"""Frictional Hertzian contact (granular DEM, history-dependent).

Port of mundy_tpu/forces/friction.py (ref: the
FrictionalHertzianContact kernels,
`SpherocylinderSegmentSpherocylinderSegmentFrictionalHertzianContact.cpp:
440-520`, LAMMPS granular hertz/history convention): spring-dashpot normal
force, tangential spring on the accumulated (projected) tangential
displacement, Coulomb cap |Ft| <= mu |Fn| with the reference's history
rescale.

The per-contact tangential displacement is the history variable; it lives in
the pair-list slot (or the neighbor-row slot, for the segment contact of
the rods app) and the caller carries it across steps, and across a rebuild
with constraints/collision.remap_gamma (or remap_row_history). The reference's pair
scatter-adds become `index_put_(accumulate=True)`, which on the card sums
each body's contributions in slot order (see forces/springs.py); slots out
of contact add their zeros to dump rows instead of to body 0.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from mundy_tpu_torch.geom.periodicity import Metric
from mundy_tpu_torch.math.linalg import cross, norm
from mundy_tpu_torch.neighbor.cell_list import PairList

_EPS = 1e-12


class FrictionalContactResult(NamedTuple):
    forces: torch.Tensor  # (N, 3) per body
    torques: torch.Tensor  # (N, 3) per body (from tangential forces at contact)
    tang_disp: torch.Tensor  # (C, 3) updated history
    normal_force_mag: torch.Tensor  # (C,) diagnostics


def _pair_scatter(n: int, i: torch.Tensor, j: torch.Tensor, v_i: torch.Tensor,
                  v_j: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
    """(n, 3): v_i summed at i, then v_j at j, each body's terms in slot
    order, as the reference's two scatter-adds. A slot with keep False (its
    values are zero) adds into a dump row of its own past the n bodies: the
    card's sorted accumulation walks each target's run serially, so the
    thousands of (0, 0) pad slots of a pair list would otherwise make body
    0 one run as long as the padding."""
    dump = n + torch.arange(i.shape[0], device=i.device)
    buf = v_i.new_zeros((n + i.shape[0], 3))
    buf.index_put_((torch.where(keep, i, dump),), v_i, accumulate=True)
    buf.index_put_((torch.where(keep, j, dump),), v_j, accumulate=True)
    return buf[:n]


def frictional_hertzian_contact(pos: torch.Tensor, vel: torch.Tensor, radius,
                                pairs: PairList, tang_disp: torch.Tensor, dt,
                                normal_spring: float, normal_damping: float,
                                tang_spring: float, tang_damping: float,
                                friction_coeff: float, density: float = 1.0,
                                metric: Optional[Metric] = None) -> FrictionalContactResult:
    """Sphere-sphere frictional Hertzian contact over a pair list.

    Force on the left body i (the reference's convention): normal
    spring-dashpot hertz_poly (k_n sep n + m_eff c_n v_n) plus tangential
    hertz_poly (k_t xi + m_eff c_t v_t), Coulomb-capped; equal and opposite
    on j; torques from the force at each body's contact point. Slots out of
    contact (or masked) reset their history to 0. `radius`: a scalar or
    (N,); `dt` a scalar or 0-d tensor in pos's dtype."""
    n = pos.shape[0]
    radius = torch.broadcast_to(torch.as_tensor(radius, dtype=pos.dtype, device=pos.device),
                                (n,))
    i, j = pairs.i.long(), pairs.j.long()
    pi, pj = pos[i], pos[j]
    sepv = (pj - pi) if metric is None else metric.sep(pi, pj)
    r2 = torch.clamp((sepv * sepv).sum(-1), min=_EPS)
    rinv = torch.rsqrt(r2)
    dist = r2 * rinv
    nhat = sepv * rinv[:, None]  # from i toward j (the left contact normal)
    ri, rj = radius[i], radius[j]
    signed_sep = dist - ri - rj
    in_contact = pairs.mask & (signed_sep < 0.0)

    # contact-point velocities (spheres: the centers' velocities, no spin)
    rel = vel[j] - vel[i]
    rel_n = (rel * nhat).sum(-1)[:, None] * nhat
    rel_t = rel - rel_n

    # history: accumulate, project onto the tangent plane, reset the slots
    # out of contact (ref `:432-434`)
    xi = tang_disp + rel_t * dt
    xi = xi - (xi * nhat).sum(-1)[:, None] * nhat
    xi = torch.where(in_contact[:, None], xi, 0.0)

    m = (4.0 / 3.0) * math.pi * density * radius ** 3
    m_eff = (m[i] * m[j]) / (m[i] + m[j])
    r_eff = (ri * rj) / (ri + rj)
    hertz_poly = torch.sqrt(torch.clamp(-r_eff * signed_sep, min=0.0))

    f_n = hertz_poly[:, None] * (normal_spring * signed_sep[:, None] * nhat
                                 + (m_eff * normal_damping)[:, None] * rel_n)
    f_t = hertz_poly[:, None] * (tang_spring * xi
                                 + (m_eff * tang_damping)[:, None] * rel_t)

    # Coulomb cap with the history rescale (ref `:497-513`)
    fn_mag = norm(f_n)
    ft_mag = norm(f_t)
    cap = friction_coeff * fn_mag
    over = ft_mag > cap
    scale = cap / torch.clamp(ft_mag, min=_EPS)
    damp_term = (m_eff * tang_damping)[:, None] * rel_t / max(tang_spring, _EPS)
    xi_rescaled = scale[:, None] * (xi + damp_term) - damp_term
    xi = torch.where(over[:, None], xi_rescaled, xi)
    f_t = torch.where(over[:, None], f_t * scale[:, None], f_t)

    f_on_i = torch.where(in_contact[:, None], f_n + f_t, 0.0)
    forces = _pair_scatter(n, i, j, f_on_i, -f_on_i, in_contact)

    # torques: the force acts at the contact point on each surface
    arm_i = (ri * torch.ones_like(ri))[:, None] * nhat
    arm_j = -rj[:, None] * nhat
    torques = _pair_scatter(n, i, j, cross(arm_i, f_on_i), cross(arm_j, -f_on_i), in_contact)
    return FrictionalContactResult(
        forces=forces, torques=torques, tang_disp=xi,
        normal_force_mag=torch.where(in_contact, norm(f_n), 0.0))


class SegmentFrictionResult(NamedTuple):
    forces: torch.Tensor  # (N, 3) per body
    torques: torch.Tensor  # (N, 3) per body
    tang_disp: torch.Tensor  # (N, K, 3) updated per-slot history
    normal_mag: torch.Tensor  # (N, K) Hertzian normal magnitudes (diagnostics)


def frictional_segment_contact_rows(pos: torch.Tensor, hedge: torch.Tensor,
                                    vel: torch.Tensor, omega: torch.Tensor,
                                    nmat_idx: torch.Tensor, nmat_mask: torch.Tensor,
                                    tang_disp: torch.Tensor, dt, radius: float,
                                    youngs: float, poisson: float, tang_spring: float,
                                    friction_coeff: float, tang_damping: float = 0.0,
                                    metric: Optional[Metric] = None) -> SegmentFrictionResult:
    """Frictional Hertzian contact between spherocylinder segments over an
    (N, K) neighbor matrix (ref: `SpherocylinderSegmentSpherocylinderSegment
    FrictionalHertzianContact.cpp:440-520`, the CollidingFrictionalSperm
    capability).

    pos, hedge: (N, 3) midpoints and half-edges (axis length/2); vel, omega:
    (N, 3) the body velocities of the previous step (the explicit friction
    closure of overdamped dynamics); tang_disp (N, K, 3) the per-slot
    history; dt a scalar or 0-d tensor in pos's dtype. The narrow phase is
    segment_closest_planes; the normal force is Hertz's, the tangential one
    a spring on the accumulated contact-point slip, sqrt(R* delta) scaled,
    with the Coulomb cap and history rescale. Each contact sits on both
    bodies' rows with mirrored normals, so the two histories evolve as exact
    negatives and the one-sided sums keep action and reaction."""
    from mundy_tpu_torch.forces.contact import effective_youngs, hertzian_pair_force
    from mundy_tpu_torch.geom.distance import segment_closest_planes

    n = pos.shape[0]
    idx = torch.clamp(nmat_idx.long(), max=n - 1)
    payload = torch.cat([pos, hedge, vel, omega], dim=1)  # (N, 12)
    cand = payload[idx]  # (N, K, 12): one gather
    cmid, chedge = cand[..., 0:3], cand[..., 3:6]
    cvel, comega = cand[..., 6:9], cand[..., 9:12]
    S = cmid - pos[:, None, :] if metric is None else metric.sep(pos[:, None, :], cmid)

    s, t, DX, DY, DZ, d2 = segment_closest_planes(
        S[..., 0], S[..., 1], S[..., 2],
        hedge[:, None, 0], hedge[:, None, 1], hedge[:, None, 2],
        chedge[..., 0], chedge[..., 1], chedge[..., 2])
    d2c = torch.clamp(d2, min=_EPS)
    rinv = torch.rsqrt(d2c)
    dist = d2c * rinv
    nhat = torch.stack([DX, DY, DZ], dim=-1) * rinv[..., None]  # own -> cand
    sep0 = dist - 2.0 * radius
    in_contact = nmat_mask & (sep0 < 0.0)

    kw = dict(dtype=pos.dtype, device=pos.device)
    e_eff = effective_youngs(youngs, youngs, poisson, poisson)
    fn_mag = hertzian_pair_force(sep0, torch.tensor(0.5 * radius, **kw),
                                 torch.tensor(e_eff, **kw))

    # contact arms from each body's center (closest point + radius n)
    arm_i = (2.0 * s - 1.0)[..., None] * hedge[:, None, :] + radius * nhat
    arm_j = (2.0 * t - 1.0)[..., None] * chedge - radius * nhat
    v_i = vel[:, None, :] + cross(omega[:, None, :], arm_i)
    v_j = cvel + cross(comega, arm_j)
    rel = v_j - v_i
    rel_n = (rel * nhat).sum(-1)[..., None] * nhat
    rel_t = rel - rel_n

    xi = tang_disp + rel_t * dt
    xi = xi - (xi * nhat).sum(-1)[..., None] * nhat
    xi = torch.where(in_contact[..., None], xi, 0.0)

    # hertz/history scaling: the tangential stiffness grows with the
    # contact patch, sqrt(R* delta) (ref `:470-497`)
    hertz_poly = torch.sqrt(torch.clamp(-0.5 * radius * sep0, min=0.0))
    f_t = hertz_poly[..., None] * (tang_spring * xi + tang_damping * rel_t)
    ft_mag = torch.linalg.vector_norm(f_t, dim=-1)
    cap = friction_coeff * fn_mag
    over = ft_mag > cap
    scale = cap / torch.clamp(ft_mag, min=_EPS)
    damp = tang_damping * rel_t / max(tang_spring, _EPS)
    xi = torch.where(over[..., None], scale[..., None] * (xi + damp) - damp, xi)
    f_t = torch.where(over[..., None], f_t * scale[..., None], f_t)

    f_pair = torch.where(in_contact[..., None], -fn_mag[..., None] * nhat + f_t, 0.0)
    return SegmentFrictionResult(
        forces=f_pair.sum(1), torques=cross(arm_i, f_pair).sum(1), tang_disp=xi,
        normal_mag=torch.where(in_contact, fn_mag, 0.0))


def remap_row_history(old_idx: torch.Tensor, old_mask: torch.Tensor,
                      old_vals: torch.Tensor, new_idx: torch.Tensor,
                      new_mask: torch.Tensor) -> torch.Tensor:
    """Carry (N, K, ...) per-slot history across a neighbor rebuild by pair
    identity: new slot (i, q) inherits old slot (i, p) where the neighbor ids
    match (a K x K probe per row, the reference's einsum; the row form of
    constraints.remap_gamma). The old and new K may differ (a regrow). The
    contraction is a batched product: in float32 on the card it refuses
    TF32, which would round the carried values to 11 bits."""
    if (old_vals.is_cuda and old_vals.dtype == torch.float32
            and torch.backends.cuda.matmul.allow_tf32):
        raise RuntimeError("remap_row_history needs full float32: "
                           "torch.backends.cuda.matmul.allow_tf32 is on")
    hit = ((old_idx[:, None, :] == new_idx[:, :, None])
           & old_mask[:, None, :] & new_mask[:, :, None])
    return torch.einsum("npq,nq...->np...", hit.to(old_vals.dtype), old_vals)
