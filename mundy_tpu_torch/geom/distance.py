"""Segment-segment closest points on component planes.

Port of `segment_closest_planes` from mundy_tpu/geom/distance.py, the one
distance function the rods and filaments paths run (the row narrow phase,
neighbor/rows.segment_pair_terms, and the filaments neighbor-matrix narrow
phase). The other distance functions wait for their callers.
"""

from __future__ import annotations

import torch


def _clip(x: torch.Tensor, lo: float, hi) -> torch.Tensor:
    """jnp.clip(x, lo, hi) with a tensor or scalar upper bound."""
    x = torch.clamp(x, min=lo)
    return torch.minimum(x, hi) if isinstance(hi, torch.Tensor) else torch.clamp(x, max=hi)


def segment_closest_planes(SX, SY, SZ, oex, oey, oez, cex, cey, cez):
    """Clamped segment-segment closest points on broadcast-compatible
    component planes, operation for operation as the reference.

    S = candidate midpoint - own midpoint (minimum image already applied);
    oe* and ce*: the own and candidate half-edges (endpoints mid -/+ e). The
    edge-clamped Lumelsky solve, then the best of five candidates (the
    clamped solution and four endpoint projections) by strict `<` on the
    expanded quadratic, then the coincident-pair noise floor. Returns
    (s, t, DX, DY, DZ, d2): clamped arc parameters in [0, 1], the closest
    vector own -> cand (an exact zero below the noise floor, so 1/dist
    force laws see a true zero for coincident segments) and its squared
    norm. Temporaries are dropped as soon as they are spent: the row
    narrow phase sizes its chunks by the live planes."""
    dt = torch.result_type(SX, oex)
    eps = 1e-12 if dt == torch.float64 else 1e-8
    # segment endpoints: own a0/a1 = -/+ E, cand b0/b1 = S -/+ F, so
    # u = 2E, v = 2F, w = a0 - b0 = F - E - S (componentwise planes)
    WX = cex - oex - SX
    WY = cey - oey - SY
    WZ = cez - oez - SZ
    a = 4.0 * (oex * oex + oey * oey + oez * oez)
    c = 4.0 * (cex * cex + cey * cey + cez * cez)
    b = 4.0 * (oex * cex + oey * cey + oez * cez)
    d = 2.0 * (oex * WX + oey * WY + oez * WZ)
    e = 2.0 * (cex * WX + cey * WY + cez * WZ)
    D = a * c - b * b

    sN = b * e - c * d
    tN = a * e - b * d
    sD = torch.where(D > 0, D, 1.0)
    tD = sD
    s_lo = sN < 0.0
    s_hi = sN > sD
    tN = torch.where(s_lo, e, torch.where(s_hi, e + b, tN))
    tD = torch.where(s_lo | s_hi, c, tD)
    sN = _clip(sN, 0.0, sD)
    t_lo = tN < 0.0
    t_hi = tN > tD
    sN = torch.where(t_lo, _clip(-d, 0.0, a),
                     torch.where(t_hi, _clip(b - d, 0.0, a), sN))
    sD = torch.where(t_lo | t_hi, torch.clamp(a, min=eps), sD)
    tN = _clip(tN, 0.0, tD)
    s = sN / torch.clamp(sD, min=eps)
    t = tN / torch.clamp(tD, min=eps)
    del sN, tN, sD, tD, s_lo, s_hi, t_lo, t_hi, D

    # the best of five always-feasible candidates on the expanded quadratic
    # d2(s,t) = w2 + s^2 a + t^2 c + 2sd - 2te - 2stb (continuous in the
    # inputs, exact for near-parallel segments)
    w2 = WX * WX + WY * WY + WZ * WZ
    inv_a = 1.0 / torch.clamp(a, min=eps)
    inv_c = 1.0 / torch.clamp(c, min=eps)
    zero = torch.zeros_like(s)
    one = torch.ones_like(s)
    cands = (
        (zero, _clip(e * inv_c, 0.0, 1.0)),
        (one, _clip((e + b) * inv_c, 0.0, 1.0)),
        (_clip(-d * inv_a, 0.0, 1.0), zero),
        (_clip((b - d) * inv_a, 0.0, 1.0), one),
    )

    def q(ss, tt):
        return (w2 + ss * ss * a + tt * tt * c + 2.0 * ss * d
                - 2.0 * tt * e - 2.0 * ss * tt * b)

    d2_best = q(s, t)
    for ss, tt in cands:
        d2c = q(ss, tt)
        take = d2c < d2_best
        s = torch.where(take, ss, s)
        t = torch.where(take, tt, t)
        d2_best = torch.where(take, d2c, d2_best)
    del cands, d2_best, zero, one, inv_a, inv_c, b, d, e

    # closest vector own -> cand: c2 - c1 = -(w + s u - t v)
    DX = 2.0 * (t * cex - s * oex) - WX
    DY = 2.0 * (t * cey - s * oey) - WY
    DZ = 2.0 * (t * cez - s * oez) - WZ
    d2 = DX * DX + DY * DY + DZ * DZ
    # coincident closest points have no contact normal: an exact zero vector
    # below the squared machine-eps noise floor of the reconstruction
    m_eps = float(torch.finfo(dt).eps)
    noise2 = (32.0 * m_eps) ** 2 * (a + c + w2)
    clean = d2 > noise2
    DX = torch.where(clean, DX, 0.0)
    DY = torch.where(clean, DY, 0.0)
    DZ = torch.where(clean, DZ, 0.0)
    d2 = torch.where(clean, d2, 0.0)
    return s, t, DX, DY, DZ, d2
