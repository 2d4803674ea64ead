"""AABB, OBB and bounding-radius computation per primitive.

Port of mundy_tpu/geom/aabb.py (ref: the `compute_aabb` overloads,
`mundy/geom/src/mundy_geom/compute_aabb.hpp:48-131`, and
`compute_bounding_radius.hpp`). Every function broadcasts over leading
batch axes.
"""

from __future__ import annotations

import torch

from mundy_tpu_torch.geom.primitives import (
    AABB,
    Ellipsoid,
    LineSegment,
    Sphere,
    Spherocylinder,
    SpherocylinderSegment,
    spherocylinder_endpoints,
)
from mundy_tpu_torch.math.quaternion import quat_identity, quat_to_matrix


def compute_aabb_point(p: torch.Tensor) -> AABB:
    return AABB(min=p, max=p)


def compute_aabb_sphere(s: Sphere) -> AABB:
    r = s.radius[..., None]
    return AABB(min=s.center - r, max=s.center + r)


def compute_aabb_segment(seg: LineSegment) -> AABB:
    return AABB(min=torch.minimum(seg.start, seg.end), max=torch.maximum(seg.start, seg.end))


def compute_aabb_scsegment(sc: SpherocylinderSegment) -> AABB:
    r = sc.radius[..., None]
    return AABB(min=torch.minimum(sc.start, sc.end) - r, max=torch.maximum(sc.start, sc.end) + r)


def compute_aabb_spherocylinder(sc: Spherocylinder) -> AABB:
    return compute_aabb_scsegment(spherocylinder_endpoints(sc))


def compute_aabb_ellipsoid(e: Ellipsoid) -> AABB:
    """The tight AABB of a rotated ellipsoid: half-extent_k = ||diag(r) R^T
    e_k|| = sqrt(sum_i (R_ki r_i)^2)."""
    R = quat_to_matrix(e.orientation)
    half = torch.sqrt(torch.sum((R * e.radii[..., None, :]) ** 2, dim=-1))
    return AABB(min=e.center - half, max=e.center + half)


def compute_bounding_radius_sphere(s: Sphere) -> torch.Tensor:
    return s.radius


def compute_bounding_radius_spherocylinder(sc: Spherocylinder) -> torch.Tensor:
    return 0.5 * sc.length + sc.radius


def compute_bounding_radius_ellipsoid(e: Ellipsoid) -> torch.Tensor:
    return torch.amax(e.radii, dim=-1)


def aabb_union(a: AABB, b: AABB) -> AABB:
    return AABB(min=torch.minimum(a.min, b.min), max=torch.maximum(a.max, b.max))


def aabb_inflate(a: AABB, margin) -> AABB:
    """Grow by a skin margin (a scalar, or one per box): the neighbor
    search buffer."""
    m = margin[..., None] if isinstance(margin, torch.Tensor) and margin.ndim else margin
    return AABB(min=a.min - m, max=a.max + m)


# ---------------------------------------------------------------------------
# oriented bounding boxes: (center (..., 3), orientation (..., 4),
# half-extents (..., 3))
# ---------------------------------------------------------------------------
def compute_obb_sphere(s: Sphere):
    """The identity orientation and cubic half-extents."""
    q = quat_identity(s.center.shape[:-1], dtype=s.center.dtype, device=s.center.device)
    return s.center, q, torch.broadcast_to(s.radius[..., None], s.center.shape)


def compute_obb_spherocylinder(sc: Spherocylinder):
    """Aligned with the capsule's axis: half-extents (r, r, L/2 + r)."""
    half = torch.stack([sc.radius, sc.radius, 0.5 * sc.length + sc.radius], dim=-1)
    return sc.center, sc.orientation, half


def compute_obb_ellipsoid(e: Ellipsoid):
    """Aligned with the body axes: the half-extents are the radii."""
    return e.center, e.orientation, e.radii
