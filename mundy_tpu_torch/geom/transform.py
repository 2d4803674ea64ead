"""Rigid transforms of points and primitives.

Port of mundy_tpu/geom/transform.py (ref: the per-primitive overloads of
`transform.hpp:1-420`): a rigid transform is (unit quaternion q,
translation t). Positions map as x' = R(q) x + t, directions and normals
rotate, orientations compose, radii and lengths are invariant.
"""

from __future__ import annotations

import torch

from mundy_tpu_torch.geom import primitives as prim
from mundy_tpu_torch.math.quaternion import (
    quat_conjugate,
    quat_inverse_rotate,
    quat_multiply,
    quat_rotate,
)


def transform_points(q: torch.Tensor, t: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """x' = R(q) x + t."""
    return quat_rotate(q, p) + t


def inverse_transform_points(q: torch.Tensor, t: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """x' = R(q)^T (x - t)."""
    return quat_inverse_rotate(q, p - t)


def _aabb_corners(box: prim.AABB) -> torch.Tensor:
    """(..., 8, 3) corner points."""
    lo, hi = box.min, box.max
    corners = []
    for sx in (0, 1):
        for sy in (0, 1):
            for sz in (0, 1):
                sel = torch.tensor([sx, sy, sz], dtype=lo.dtype, device=lo.device)
                corners.append(lo + sel * (hi - lo))
    return torch.stack(corners, dim=-2)


def transform_primitive(q: torch.Tensor, t: torch.Tensor, obj):
    """Rigidly transform any geom primitive (or a bare (..., 3) point
    tensor). An AABB maps to the AABB of the rotated box (axis alignment
    is not rotation-invariant), as in the reference."""
    pts = lambda p: transform_points(q, t, p)  # noqa: E731
    if isinstance(obj, prim.Sphere):
        return prim.Sphere(center=pts(obj.center), radius=obj.radius)
    if isinstance(obj, prim.Line):
        return prim.Line(point=pts(obj.point), direction=quat_rotate(q, obj.direction))
    if isinstance(obj, prim.LineSegment):
        return prim.LineSegment(start=pts(obj.start), end=pts(obj.end))
    if isinstance(obj, prim.VSegment):
        return prim.VSegment(start=pts(obj.start), middle=pts(obj.middle), end=pts(obj.end))
    if isinstance(obj, prim.Plane):
        return prim.Plane(point=pts(obj.point), normal=quat_rotate(q, obj.normal))
    if isinstance(obj, prim.Circle3D):
        return prim.Circle3D(center=pts(obj.center),
                             orientation=quat_multiply(q, obj.orientation), radius=obj.radius)
    if isinstance(obj, prim.Ring):
        return prim.Ring(center=pts(obj.center), orientation=quat_multiply(q, obj.orientation),
                         major_radius=obj.major_radius, minor_radius=obj.minor_radius)
    if isinstance(obj, prim.Spherocylinder):
        return prim.Spherocylinder(center=pts(obj.center),
                                   orientation=quat_multiply(q, obj.orientation),
                                   radius=obj.radius, length=obj.length)
    if isinstance(obj, prim.SpherocylinderSegment):
        return prim.SpherocylinderSegment(start=pts(obj.start), end=pts(obj.end),
                                          radius=obj.radius)
    if isinstance(obj, prim.Ellipsoid):
        return prim.Ellipsoid(center=pts(obj.center),
                              orientation=quat_multiply(q, obj.orientation), radii=obj.radii)
    if isinstance(obj, prim.AABB):
        corners = transform_points(q[..., None, :] if q.ndim > 1 else q,
                                   t[..., None, :] if t.ndim > 1 else t, _aabb_corners(obj))
        return prim.AABB(min=torch.amin(corners, dim=-2), max=torch.amax(corners, dim=-2))
    if isinstance(obj, torch.Tensor):
        return pts(obj)
    raise TypeError(f"cannot transform {type(obj).__name__}")


def inverse_transform_primitive(q: torch.Tensor, t: torch.Tensor, obj):
    """The inverse rigid transform: into the body frame of (q, t)."""
    return transform_primitive(quat_conjugate(q), -quat_inverse_rotate(q, t), obj)
