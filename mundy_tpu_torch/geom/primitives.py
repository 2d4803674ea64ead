"""Geometric primitives as structure-of-arrays dataclasses.

Port of mundy_tpu/geom/primitives.py (ref: the primitives of
`mundy/geom/src/mundy_geom/primitives/*.hpp`; a Point is a bare (..., 3)
tensor). Each field carries leading batch axes, so one `Sphere` holds N
spheres. The reference's pytree dataclasses become frozen dataclasses of
tensors with a `replace`.

Conventions:
- orientations are unit quaternions, wxyz (see math/quaternion.py)
- a spherocylinder's axis is its body-frame z axis rotated by `orientation`
  (the cylinder spans center +- length/2 axis, capped by hemispheres)
- a plane is (point, unit normal); a Circle3D is the rim of radius `radius`
  in the body xy plane; a Ring is a torus: the Circle3D rim + a tube of
  `minor_radius`
"""

from __future__ import annotations

import torch

from mundy_tpu_torch.core.containers import frozen_dataclass
from mundy_tpu_torch.math.quaternion import quat_rotate


@frozen_dataclass
class Sphere:
    """ref: primitives/Sphere.hpp:41"""

    center: torch.Tensor  # (..., 3)
    radius: torch.Tensor  # (...)


@frozen_dataclass
class Line:
    """Infinite line through `point` with unit `direction`. ref: primitives/Line.hpp"""

    point: torch.Tensor  # (..., 3)
    direction: torch.Tensor  # (..., 3) unit


@frozen_dataclass
class LineSegment:
    """ref: primitives/LineSegment.hpp"""

    start: torch.Tensor  # (..., 3)
    end: torch.Tensor  # (..., 3)


@frozen_dataclass
class VSegment:
    """Two joined segments start-middle-end. ref: primitives/VSegment.hpp:278-280"""

    start: torch.Tensor  # (..., 3)
    middle: torch.Tensor  # (..., 3)
    end: torch.Tensor  # (..., 3)


@frozen_dataclass
class Plane:
    """Infinite plane (point, unit normal)."""

    point: torch.Tensor  # (..., 3)
    normal: torch.Tensor  # (..., 3) unit


@frozen_dataclass
class Circle3D:
    """Circle rim in 3D: the body-frame xy-plane circle of `radius`.
    ref: primitives/Circle3D.hpp:45"""

    center: torch.Tensor  # (..., 3)
    orientation: torch.Tensor  # (..., 4) wxyz
    radius: torch.Tensor  # (...)


@frozen_dataclass
class Ring:
    """Torus: the Circle3D center circle (major_radius) + a tube
    (minor_radius). ref: primitives/Ring.hpp:46"""

    center: torch.Tensor  # (..., 3)
    orientation: torch.Tensor  # (..., 4)
    major_radius: torch.Tensor  # (...)
    minor_radius: torch.Tensor  # (...)


@frozen_dataclass
class Spherocylinder:
    """Capsule by center/orientation/radius/length. ref: primitives/Spherocylinder.hpp:43"""

    center: torch.Tensor  # (..., 3)
    orientation: torch.Tensor  # (..., 4)
    radius: torch.Tensor  # (...)
    length: torch.Tensor  # (...) cylindrical length (between cap centers)


@frozen_dataclass
class SpherocylinderSegment:
    """Capsule by explicit endpoints. ref: primitives/SpherocylinderSegment.hpp"""

    start: torch.Tensor  # (..., 3)
    end: torch.Tensor  # (..., 3)
    radius: torch.Tensor  # (...)


@frozen_dataclass
class Ellipsoid:
    """Triaxial ellipsoid: body-frame semi-axes radii = (r1, r2, r3).
    ref: primitives/Ellipsoid.hpp"""

    center: torch.Tensor  # (..., 3)
    orientation: torch.Tensor  # (..., 4)
    radii: torch.Tensor  # (..., 3)


@frozen_dataclass
class AABB:
    """Axis-aligned bounding box. ref: primitives/AABB.hpp:438"""

    min: torch.Tensor  # (..., 3)
    max: torch.Tensor  # (..., 3)


def spherocylinder_endpoints(sc: Spherocylinder) -> SpherocylinderSegment:
    """Center/orientation form -> endpoint form (along the body z axis)."""
    zhat = torch.zeros_like(sc.center)
    zhat[..., 2] = 1.0
    axis = quat_rotate(sc.orientation, zhat)
    half = 0.5 * sc.length[..., None] * axis
    return SpherocylinderSegment(start=sc.center - half, end=sc.center + half,
                                 radius=sc.radius)
