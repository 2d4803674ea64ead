"""Batched distance functions for all shape pairs.

Port of mundy_tpu/geom/distance.py (ref: the overloaded `distance()`
family, `mundy/geom/src/mundy_geom/distance.hpp:26-53`, and the per-pair
headers in `distance/`). Every function is branch-free (where-selects in
place of if/else) and broadcasts over leading batch axes; each takes an
optional periodic `Metric` that shifts body 2 to its minimum image before
the free-space computation (valid while bodies are smaller than half the
box).

Return convention: `SepResult(dist, point1, point2, normal)` where
- dist is the shared-normal signed separation (negative = overlap) for
  pairs with surfaces (sphere, capsule, ellipsoid, plane), Euclidean
  otherwise;
- point1/point2 are the closest (foot) points on each object's surface or
  skeleton (for point/line/segment pairs: the closest points themselves);
- normal is the unit shared normal pointing from object 1 toward object 2.

The arithmetic follows the reference operation for operation, so float64
results agree to rounding. Where the reference takes `jax.grad` (the
ellipsoid-ellipsoid minimization), the gradient comes from torch.autograd
on leaf copies under `torch.enable_grad`, detached afterwards.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from mundy_tpu_torch.geom.periodicity import Metric
from mundy_tpu_torch.geom.primitives import (
    Circle3D,
    Ellipsoid,
    LineSegment,
    Plane,
    Sphere,
    Spherocylinder,
    SpherocylinderSegment,
    VSegment,
    spherocylinder_endpoints,
)
from mundy_tpu_torch.math.lbfgs import grad_of_sum, minimize_lbfgs
from mundy_tpu_torch.math.linalg import cross, dot, norm, normalize
from mundy_tpu_torch.math.quaternion import quat_inverse_rotate, quat_rotate


class SepResult(NamedTuple):
    dist: torch.Tensor  # (...) signed separation (or Euclidean distance)
    point1: torch.Tensor  # (..., 3) closest/foot point on object 1
    point2: torch.Tensor  # (..., 3) closest/foot point on object 2
    normal: torch.Tensor  # (..., 3) unit normal from 1 to 2


_EPS = 1e-12


def _clip(x: torch.Tensor, lo: float, hi) -> torch.Tensor:
    """jnp.clip(x, lo, hi) with a tensor or scalar upper bound."""
    x = torch.clamp(x, min=lo)
    return torch.minimum(x, hi) if isinstance(hi, torch.Tensor) else torch.clamp(x, max=hi)


def _image_shift(anchor1: torch.Tensor, anchor2: torch.Tensor,
                 metric: Optional[Metric]) -> torch.Tensor:
    """Translation that moves object 2 to its minimum image w.r.t. object 1."""
    if metric is None:
        return torch.zeros_like(anchor1)
    return metric.sep(anchor1, anchor2) - (anchor2 - anchor1)


def _safe_normal(sep_vec: torch.Tensor) -> torch.Tensor:
    return normalize(sep_vec, eps=_EPS)


def _sign(cond: torch.Tensor) -> torch.Tensor:
    """-1 where cond, else +1, in a float dtype fit to multiply with."""
    return torch.where(cond, -1.0, 1.0)


# --------------------------------------------------------------------------
# point family
# --------------------------------------------------------------------------
def distance_point_point(p1, p2, metric: Optional[Metric] = None) -> SepResult:
    """ref: distance/PointPoint.hpp"""
    sep = p2 - p1 if metric is None else metric.sep(p1, p2)
    return SepResult(norm(sep), p1, p1 + sep, _safe_normal(sep))


def distance_point_line(p, line_point, line_dir,
                        metric: Optional[Metric] = None) -> SepResult:
    """ref: distance/PointLine.hpp. line_dir must be unit."""
    lp = line_point + _image_shift(p, line_point, metric)
    t = dot(p - lp, line_dir)
    foot = lp + t[..., None] * line_dir
    sep = foot - p
    return SepResult(norm(sep), p, foot, _safe_normal(sep))


def _closest_param_on_segment(p, a, b) -> torch.Tensor:
    u = b - a
    uu = torch.clamp(dot(u, u), min=_EPS)
    return torch.clamp(dot(p - a, u) / uu, 0.0, 1.0)


def distance_point_segment(p, seg: LineSegment,
                           metric: Optional[Metric] = None) -> SepResult:
    """ref: distance/PointLineSegment.hpp"""
    shift = _image_shift(p, 0.5 * (seg.start + seg.end), metric)
    a, b = seg.start + shift, seg.end + shift
    t = _closest_param_on_segment(p, a, b)
    foot = a + t[..., None] * (b - a)
    sep = foot - p
    return SepResult(norm(sep), p, foot, _safe_normal(sep))


def distance_point_plane(p, plane: Plane, metric: Optional[Metric] = None) -> SepResult:
    """Signed by the plane normal. ref: distance/PointPlane.hpp"""
    pp = plane.point + _image_shift(p, plane.point, metric)
    s = dot(p - pp, plane.normal)
    foot = p - s[..., None] * plane.normal
    return SepResult(s, p, foot, -plane.normal)


def distance_point_sphere(p, sph: Sphere, metric: Optional[Metric] = None) -> SepResult:
    """Signed (negative inside). ref: distance/PointSphere.hpp"""
    c = sph.center + _image_shift(p, sph.center, metric)
    sep = c - p
    d = norm(sep)
    n = _safe_normal(sep)
    surf = c - n * sph.radius[..., None]
    return SepResult(d - sph.radius, p, surf, n)


def _point_ellipsoid_body(p: torch.Tensor, radii: torch.Tensor, newton_iters: int = 64):
    """Closest point on an axis-aligned ellipsoid (body frame) to p, and the
    signed distance: Eberly's secular equation in t,
        sum_i (r_i^2 p_i / (t + r_i^2))^2 / r_i^2 = 1,
    solved by a fixed count of bisections (the reference's replacement for
    the in-kernel minimization of distance/PointEllipsoid.hpp)."""
    r2 = radii * radii
    # perturb exact-zero components to avoid the degenerate axis case
    p_safe = torch.where(torch.abs(p) < 1e-14, 1e-14, p)

    def f(t):
        x = r2 * p_safe / (t[..., None] + r2)
        return torch.sum((x / radii) ** 2, dim=-1) - 1.0

    r2_min = torch.amin(r2, dim=-1)
    batch = torch.broadcast_shapes(p.shape[:-1], radii.shape[:-1])
    # t > -r2_min; f is strictly decreasing on that interval
    lo = torch.broadcast_to(-r2_min + 1e-12, batch)
    hi = torch.broadcast_to(norm(radii * p_safe) + torch.amax(r2, dim=-1), batch)
    for _ in range(newton_iters):
        mid = 0.5 * (lo + hi)
        pos = f(mid) > 0
        lo = torch.where(pos, mid, lo)
        hi = torch.where(pos, hi, mid)
    t = 0.5 * (lo + hi)
    x = r2 * p_safe / (t[..., None] + r2)
    inside = torch.sum((p_safe / radii) ** 2, dim=-1) < 1.0
    return x, norm(p - x) * _sign(inside)


def distance_point_ellipsoid(p, ell: Ellipsoid, metric: Optional[Metric] = None) -> SepResult:
    """Signed (negative inside). ref: distance/PointEllipsoid.hpp"""
    c = ell.center + _image_shift(p, ell.center, metric)
    pb = quat_inverse_rotate(ell.orientation, p - c)
    xb, d = _point_ellipsoid_body(pb, ell.radii)
    foot = quat_rotate(ell.orientation, xb) + c
    n = _safe_normal(foot - p) * _sign(d < 0)[..., None]
    return SepResult(d, p, foot, n)


def distance_point_vsegment(p, v: VSegment, metric: Optional[Metric] = None) -> SepResult:
    """The nearer of the two legs."""
    r1 = distance_point_segment(p, LineSegment(v.start, v.middle), metric)
    r2 = distance_point_segment(p, LineSegment(v.middle, v.end), metric)
    take1 = (r1.dist <= r2.dist)[..., None]
    return SepResult(torch.minimum(r1.dist, r2.dist), p,
                     torch.where(take1, r1.point2, r2.point2),
                     torch.where(take1, r1.normal, r2.normal))


# --------------------------------------------------------------------------
# line family
# --------------------------------------------------------------------------
def distance_line_line(p1, d1, p2, d2, metric: Optional[Metric] = None) -> SepResult:
    """Closest approach of two infinite lines (unit directions).
    ref: distance/LineLine.hpp"""
    p2 = p2 + _image_shift(p1, p2, metric)
    w = p1 - p2
    b = dot(d1, d2)
    d_ = dot(d1, w)
    e = dot(d2, w)
    denom = 1.0 - b * b
    parallel = denom < 1e-12
    safe = torch.where(parallel, 1.0, denom)
    s = torch.where(parallel, 0.0, (b * e - d_) / safe)
    t = torch.where(parallel, e, (e - b * d_) / safe)
    c1 = p1 + s[..., None] * d1
    c2 = p2 + t[..., None] * d2
    sep = c2 - c1
    return SepResult(norm(sep), c1, c2, _safe_normal(sep))


def distance_line_sphere(lp, ld, sph: Sphere, metric: Optional[Metric] = None) -> SepResult:
    """Signed to the surface. ref: distance/LineSphere.hpp"""
    r = distance_point_line(sph.center, lp, ld, metric)
    n = -r.normal  # from the line toward the center
    surf = sph.center - n * sph.radius[..., None]
    return SepResult(r.dist - sph.radius, r.point2, surf, n)


def distance_line_plane(lp, ld, plane: Plane, metric: Optional[Metric] = None) -> SepResult:
    """0 unless parallel; then the plane offset. ref: distance/LinePlane.hpp"""
    pp = plane.point + _image_shift(lp, plane.point, metric)
    denom = dot(ld, plane.normal)
    parallel = torch.abs(denom) < 1e-12
    t = torch.where(parallel, 0.0,
                    -dot(lp - pp, plane.normal) / torch.where(parallel, 1.0, denom))
    hit = lp + t[..., None] * ld
    s = dot(lp - pp, plane.normal)
    d = torch.where(parallel, s, 0.0)
    foot = torch.where(parallel[..., None], lp - s[..., None] * plane.normal, hit)
    p_on_line = torch.where(parallel[..., None], lp, hit)
    return SepResult(d, p_on_line, foot, -plane.normal)


# --------------------------------------------------------------------------
# segment family
# --------------------------------------------------------------------------
def segment_segment_closest(a0, a1, b0, b1):
    """Clamped closest points between segments [a0, a1] and [b0, b1].

    The reference's branch-free form of the classic algorithm
    (distance/LineSegmentLineSegment.hpp:51-200), with the near-parallel
    fallback that takes the best of the four endpoint projections.
    Returns (s, t, c1, c2): arc parameters and closest points."""
    u = a1 - a0
    v = b1 - b0
    w = a0 - b0
    a = dot(u, u)
    b = dot(u, v)
    c = dot(v, v)
    d = dot(u, w)
    e = dot(v, w)
    D = a * c - b * b

    # general (non-parallel) case with edge clamping
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
    sN = torch.where(t_lo, _clip(-d, 0.0, a), torch.where(t_hi, _clip(-d + b, 0.0, a), sN))
    sD = torch.where(t_lo | t_hi, torch.clamp(a, min=_EPS), sD)
    tN = _clip(tN, 0.0, tD)
    s = sN / torch.clamp(sD, min=_EPS)
    t = tN / torch.clamp(tD, min=_EPS)

    # near-parallel / degenerate fallback: the best of 4 endpoint projections
    ta0 = _closest_param_on_segment(a0, b0, b1)
    ta1 = _closest_param_on_segment(a1, b0, b1)
    sb0 = _closest_param_on_segment(b0, a0, a1)
    sb1 = _closest_param_on_segment(b1, a0, a1)
    cands_s = torch.stack([torch.zeros_like(s), torch.ones_like(s), sb0, sb1], dim=-1)
    cands_t = torch.stack([ta0, ta1, torch.zeros_like(t), torch.ones_like(t)], dim=-1)
    c1s = a0[..., None, :] + cands_s[..., :, None] * u[..., None, :]
    c2s = b0[..., None, :] + cands_t[..., :, None] * v[..., None, :]
    best = torch.argmin(torch.sum((c2s - c1s) ** 2, dim=-1), dim=-1, keepdim=True)
    s_par = torch.gather(cands_s, -1, best)[..., 0]
    t_par = torch.gather(cands_t, -1, best)[..., 0]

    parallel = D < 1e-9 * torch.clamp(a * c, min=_EPS)
    s = torch.where(parallel, s_par, s)
    t = torch.where(parallel, t_par, t)
    return s, t, a0 + s[..., None] * u, b0 + t[..., None] * v


def distance_segment_segment(s1: LineSegment, s2: LineSegment,
                             metric: Optional[Metric] = None) -> SepResult:
    """ref: distance/LineSegmentLineSegment.hpp:51-200"""
    shift = _image_shift(0.5 * (s1.start + s1.end), 0.5 * (s2.start + s2.end), metric)
    _s, _t, c1, c2 = segment_segment_closest(s1.start, s1.end, s2.start + shift,
                                             s2.end + shift)
    sep = c2 - c1
    return SepResult(norm(sep), c1, c2, _safe_normal(sep))


def distance_segment_sphere(seg: LineSegment, sph: Sphere,
                            metric: Optional[Metric] = None) -> SepResult:
    """ref: distance/LineSegmentSphere.hpp"""
    r = distance_point_segment(sph.center, seg, metric)
    n = -r.normal  # from the segment toward the center
    surf = sph.center - n * sph.radius[..., None]
    return SepResult(r.dist - sph.radius, r.point2, surf, n)


def distance_segment_plane(seg: LineSegment, plane: Plane,
                           metric: Optional[Metric] = None) -> SepResult:
    """Signed; 0 if the segment crosses the plane. ref: distance/LineSegmentPlane.hpp"""
    pp = plane.point + _image_shift(0.5 * (seg.start + seg.end), plane.point, metric)
    s0 = dot(seg.start - pp, plane.normal)
    s1 = dot(seg.end - pp, plane.normal)
    crosses = s0 * s1 < 0.0
    pick0 = torch.abs(s0) <= torch.abs(s1)
    s = torch.where(crosses, 0.0, torch.where(pick0, s0, s1))
    p_on = torch.where(pick0[..., None], seg.start, seg.end)
    foot = p_on - torch.where(pick0, s0, s1)[..., None] * plane.normal
    return SepResult(s, p_on, foot, -plane.normal)


# --------------------------------------------------------------------------
# sphere / plane / ellipsoid families
# --------------------------------------------------------------------------
def distance_sphere_sphere(s1: Sphere, s2: Sphere, metric: Optional[Metric] = None) -> SepResult:
    """Signed surface separation. ref: distance/SphereSphere.hpp:45-72"""
    sep = (s2.center - s1.center) if metric is None else metric.sep(s1.center, s2.center)
    d = norm(sep)
    n = _safe_normal(sep)
    p1 = s1.center + n * s1.radius[..., None]
    p2 = s1.center + sep - n * s2.radius[..., None]
    return SepResult(d - s1.radius - s2.radius, p1, p2, n)


def distance_sphere_ellipsoid(sph: Sphere, ell: Ellipsoid,
                              metric: Optional[Metric] = None) -> SepResult:
    """ref: distance/SphereEllipsoid.hpp"""
    r = distance_point_ellipsoid(sph.center, ell, metric)
    p1 = sph.center + r.normal * sph.radius[..., None]
    return SepResult(r.dist - sph.radius, p1, r.point2, r.normal)


def _side(h: torch.Tensor) -> torch.Tensor:
    """sign(h), with +1 at h == 0."""
    return torch.sign(torch.where(h == 0, 1.0, h))


def distance_plane_sphere(plane: Plane, sph: Sphere,
                          metric: Optional[Metric] = None) -> SepResult:
    """Signed surface-to-plane (the sign of the center's side).
    ref: distance/PlaneSphere.hpp"""
    c = sph.center + _image_shift(plane.point, sph.center, metric)
    s = dot(c - plane.point, plane.normal)
    side = _side(s)
    d = torch.abs(s) - sph.radius
    n = plane.normal * side[..., None]  # from the plane toward the sphere
    p2 = c - n * sph.radius[..., None]
    p1 = c - s[..., None] * plane.normal
    return SepResult(d * side, p1, p2, n)


def distance_plane_plane(p1: Plane, p2: Plane, metric: Optional[Metric] = None) -> SepResult:
    """0 unless parallel. ref: distance/PlanePlane.hpp"""
    q2 = p2.point + _image_shift(p1.point, p2.point, metric)
    parallel = norm(cross(p1.normal, p2.normal)) < 1e-9
    s = dot(q2 - p1.point, p1.normal)
    d = torch.where(parallel, s, 0.0)
    foot2 = torch.where(parallel[..., None], p1.point + s[..., None] * p1.normal, p1.point)
    return SepResult(d, p1.point, foot2, p1.normal)


def distance_plane_ellipsoid(plane: Plane, ell: Ellipsoid,
                             metric: Optional[Metric] = None) -> SepResult:
    """Support-function form: separation = |h| - support(n).
    ref: distance/PlaneEllipsoid.hpp"""
    c = ell.center + _image_shift(plane.point, ell.center, metric)
    h = dot(c - plane.point, plane.normal)
    side = _side(h)
    # the support radius along n: sqrt(n^T R diag(r^2) R^T n)
    nb = quat_inverse_rotate(ell.orientation, plane.normal)
    supp = torch.sqrt(torch.sum((ell.radii * nb) ** 2, dim=-1))
    d = torch.abs(h) - supp
    n_to_ell = plane.normal * side[..., None]
    # the foot point on the surface: the support point facing the plane
    grad_dir = -(side[..., None]) * nb
    scale = torch.sqrt(torch.sum((ell.radii * grad_dir) ** 2, dim=-1))
    xb = (ell.radii ** 2) * grad_dir / torch.clamp(scale[..., None], min=_EPS)
    p2 = quat_rotate(ell.orientation, xb) + c
    p1 = p2 - dot(p2 - plane.point, plane.normal)[..., None] * plane.normal
    return SepResult(d * side, p1, p2, n_to_ell)


# --------------------------------------------------------------------------
# spherocylinders (capsules)
# --------------------------------------------------------------------------
def distance_sphere_scsegment(sph: Sphere, sc: SpherocylinderSegment,
                              metric: Optional[Metric] = None) -> SepResult:
    """ref: the SphereSpherocylinderSegment narrow-phase kernels"""
    r = distance_point_segment(sph.center, LineSegment(sc.start, sc.end), metric)
    n = r.normal  # from the sphere center toward the segment axis
    d = r.dist - sph.radius - sc.radius
    p1 = sph.center + n * sph.radius[..., None]
    p2 = r.point2 - n * sc.radius[..., None]
    return SepResult(d, p1, p2, n)


def distance_scsegment_scsegment(sc1: SpherocylinderSegment, sc2: SpherocylinderSegment,
                                 metric: Optional[Metric] = None) -> SepResult:
    """ref: the SpherocylinderSegmentSpherocylinderSegment kernels"""
    r = distance_segment_segment(LineSegment(sc1.start, sc1.end),
                                 LineSegment(sc2.start, sc2.end), metric)
    d = r.dist - sc1.radius - sc2.radius
    p1 = r.point1 + r.normal * sc1.radius[..., None]
    p2 = r.point2 - r.normal * sc2.radius[..., None]
    return SepResult(d, p1, p2, r.normal)


def distance_sphere_spherocylinder(sph: Sphere, sc: Spherocylinder,
                                   metric: Optional[Metric] = None) -> SepResult:
    return distance_sphere_scsegment(sph, spherocylinder_endpoints(sc), metric)


def distance_spherocylinder_spherocylinder(sc1: Spherocylinder, sc2: Spherocylinder,
                                           metric: Optional[Metric] = None) -> SepResult:
    return distance_scsegment_scsegment(spherocylinder_endpoints(sc1),
                                        spherocylinder_endpoints(sc2), metric)


# --------------------------------------------------------------------------
# ellipsoid-ellipsoid (in-kernel minimization) and line/segment-ellipsoid
# --------------------------------------------------------------------------
def _foot_point_from_normal(nhat_lab: torch.Tensor, ell: Ellipsoid) -> torch.Tensor:
    """Lab-frame surface point of `ell` whose outward normal is nhat_lab:
    x_i = r_i^2 n_i / sqrt(sum_j r_j^2 n_j^2) in the body frame (ref:
    map_surface_normal_to_foot_point_on_ellipsoid, primitives/Ellipsoid.hpp:
    420-468)."""
    nb = quat_inverse_rotate(ell.orientation, nhat_lab)
    scale = torch.sqrt(torch.sum((ell.radii * nb) ** 2, dim=-1))
    xb = (ell.radii ** 2) * nb / torch.clamp(scale, min=_EPS)[..., None]
    return quat_rotate(ell.orientation, xb) + ell.center


def _flat_lanes(t: torch.Tensor, batch: tuple, flat: int) -> torch.Tensor:
    """An ellipsoid field (..., c) broadcast to batch + (c,), one lane a row."""
    return torch.broadcast_to(t, batch + t.shape[-1:]).reshape((flat,) + t.shape[-1:])


def distance_ellipsoid_ellipsoid(e1: Ellipsoid, e2: Ellipsoid,
                                 metric: Optional[Metric] = None,
                                 newton_iters: int = 48, refine: str = "none",
                                 refine_iters: int = 12,
                                 n0: Optional[torch.Tensor] = None) -> SepResult:
    """Shared-normal signed separation between two ellipsoids.

    The reference's in-kernel minimization (distance/EllipsoidEllipsoid.hpp:
    45-152) as the JAX package does it: a trial shared normal n maps to foot
    points on both ellipsoids (outward n on e1, -n on e2), and projected
    gradient descent on the unit sphere of normals minimizes their squared
    distance for `newton_iters` steps (lr 0.5 / (1 + 0.1 k)) from 7 starts:
    the center line and the +-x, +-y, +-z axes. The starts run as one
    batch (the updates are elementwise), and the best is picked in the
    reference's order by strict `<`, renormalized at each pick as there.

    `n0` (..., 3): a temporal warm start. One start from it, no multistart;
    slots whose seed has |n0|^2 <= 0.25 (no stored normal) start from the
    center line.

    `refine="lbfgs"` then polishes the winner with batched L-BFGS
    (math/lbfgs.py, memory 4, `refine_iters` iterations) on the local chart
    n(t) ~ best_n + t0 u + t1 v, (u, v) orthonormal and normal to best_n,
    and keeps the polished normal where its objective is lower."""
    c2 = e2.center + _image_shift(e1.center, e2.center, metric)
    e2 = e2.replace(center=c2)

    def objective(n):
        f1 = _foot_point_from_normal(n, e1)
        f2 = _foot_point_from_normal(-n, e2)
        return torch.sum((f2 - f1) ** 2, dim=-1)

    cdir = _safe_normal(e2.center - e1.center)
    if n0 is not None:
        n0b = torch.broadcast_to(n0, torch.broadcast_shapes(n0.shape, e1.center.shape))
        ok = (torch.sum(n0b * n0b, dim=-1) > 0.25)[..., None]
        starts = normalize(torch.where(ok, n0b, cdir), eps=_EPS)[None]
    else:
        eye = torch.eye(3, dtype=cdir.dtype, device=cdir.device)
        axes = [s * torch.broadcast_to(eye[i], cdir.shape) for i in range(3) for s in (1, -1)]
        starts = torch.stack([cdir] + axes)

    n = starts
    for k in range(newton_iters):
        g = grad_of_sum(objective, n)
        # the gradient projected onto the tangent space of the unit sphere
        g = g - dot(g, n)[..., None] * n
        lr = 0.5 / (1.0 + 0.1 * k)
        n = normalize(n - lr * g, eps=_EPS)
    f = objective(n)

    best_n, best_f = n[0], f[0]
    for i in range(1, n.shape[0]):
        take = (f[i] < best_f)[..., None]
        best_n = normalize(torch.where(take, n[i], best_n), eps=_EPS)
        best_f = torch.minimum(best_f, f[i])

    if refine == "lbfgs":
        # an orthonormal tangent frame (u, v) at best_n: the seed axis least
        # aligned with best_n, Gram-Schmidt
        ex = torch.zeros_like(best_n)
        ex[..., 0] = 1.0
        ey = torch.zeros_like(best_n)
        ey[..., 1] = 1.0
        seed = torch.where(torch.abs(best_n[..., :1]) < 0.9, ex, ey)
        u = normalize(seed - dot(seed, best_n)[..., None] * best_n, eps=_EPS)
        v = cross(best_n, u)

        batch = tuple(best_n.shape[:-1])
        flat = 1
        for s in batch:
            flat *= s
        nn0, uu, vv = (_flat_lanes(x, batch, flat) for x in (best_n, u, v))
        p1 = Ellipsoid(*(_flat_lanes(x, batch, flat)
                         for x in (e1.center, e1.orientation, e1.radii)))
        p2 = Ellipsoid(*(_flat_lanes(x, batch, flat)
                         for x in (e2.center, e2.orientation, e2.radii)))

        def chart_obj(t):
            nn = normalize(nn0 + t[..., 0, None] * uu + t[..., 1, None] * vv, eps=_EPS)
            g1 = _foot_point_from_normal(nn, p1)
            g2 = _foot_point_from_normal(-nn, p2)
            return torch.sum((g2 - g1) ** 2, dim=-1)

        t0 = torch.zeros((flat, 2), dtype=best_n.dtype, device=best_n.device)
        res = minimize_lbfgs(chart_obj, t0, max_iters=refine_iters, memory=4)
        t_ref = res.x.reshape(batch + (2,))
        f_ref = res.f.reshape(batch)
        n_ref = normalize(best_n + t_ref[..., 0, None] * u + t_ref[..., 1, None] * v,
                          eps=_EPS)
        take = (f_ref < best_f)[..., None]
        best_n = normalize(torch.where(take, n_ref, best_n), eps=_EPS)

    f1 = _foot_point_from_normal(best_n, e1)
    f2 = _foot_point_from_normal(-best_n, e2)
    # the signed separation along the shared normal (dot(p2 - p1, n))
    return SepResult(dot(f2 - f1, best_n), f1, f2, best_n)


def distance_segment_ellipsoid(seg: LineSegment, ell: Ellipsoid,
                               metric: Optional[Metric] = None, iters: int = 48) -> SepResult:
    """Golden-section search over the segment parameter (the distance to a
    convex body is convex along a line). ref: distance/LineSegmentEllipsoid.hpp"""
    c = ell.center + _image_shift(0.5 * (seg.start + seg.end), ell.center, metric)
    ell0 = ell.replace(center=c)

    def dist_at(t):
        p = seg.start + t[..., None] * (seg.end - seg.start)
        pb = quat_inverse_rotate(ell0.orientation, p - ell0.center)
        return _point_ellipsoid_body(pb, ell0.radii, newton_iters=48)[1]

    phi = 0.6180339887498949
    lo = torch.zeros(seg.start.shape[:-1], dtype=seg.start.dtype, device=seg.start.device)
    hi = torch.ones_like(lo)
    for _ in range(iters):
        m1 = hi - phi * (hi - lo)
        m2 = lo + phi * (hi - lo)
        take_left = dist_at(m1) < dist_at(m2)
        lo, hi = torch.where(take_left, lo, m1), torch.where(take_left, m2, hi)
    t = 0.5 * (lo + hi)
    p = seg.start + t[..., None] * (seg.end - seg.start)
    r = distance_point_ellipsoid(p, ell0)
    return SepResult(r.dist, p, r.point2, r.normal)


def distance_line_ellipsoid(lp, ld, ell: Ellipsoid, metric: Optional[Metric] = None,
                            iters: int = 48) -> SepResult:
    """Bracket by projecting the center onto the line, then golden-section.
    ref: distance/LineEllipsoid.hpp"""
    c = ell.center + _image_shift(lp, ell.center, metric)
    t0 = dot(c - lp, ld)
    span = torch.amax(ell.radii, dim=-1) + norm(c - lp)
    a = lp + (t0 - span)[..., None] * ld
    b = lp + (t0 + span)[..., None] * ld
    return distance_segment_ellipsoid(LineSegment(a, b), ell.replace(center=c))


def distance_circle3d_circle3d(c1: Circle3D, c2: Circle3D, metric: Optional[Metric] = None,
                               iters: int = 64) -> SepResult:
    """Closest points between two circle rims in 3D by alternating
    projection (no closed form exists). ref: distance/Circle3DCircle3D.hpp"""
    c2 = c2.replace(center=c2.center + _image_shift(c1.center, c2.center, metric))

    def project_to_rim(p, circ: Circle3D):
        pb = quat_inverse_rotate(circ.orientation, p - circ.center)
        inplane = torch.cat([pb[..., :2], torch.zeros_like(pb[..., 2:])], dim=-1)
        rim_b = normalize(inplane, eps=_EPS) * circ.radius[..., None]
        # degenerate: p on the axis -> the body x direction
        degen = (norm(inplane) < _EPS)[..., None]
        fallback = torch.zeros_like(rim_b)
        fallback[..., 0] = 1.0
        rim_b = torch.where(degen, fallback * circ.radius[..., None], rim_b)
        return quat_rotate(circ.orientation, rim_b) + circ.center

    p = project_to_rim(c2.center, c1)
    for _ in range(iters):
        p = project_to_rim(project_to_rim(p, c2), c1)
    q = project_to_rim(p, c2)
    sep = q - p
    return SepResult(norm(sep), p, q, _safe_normal(sep))


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
