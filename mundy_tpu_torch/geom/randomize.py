"""Random configuration generation.

Port of mundy_tpu/geom/randomize.py (ref: `randomize.hpp:1-306`, OpenRAND
Philox-driven per-primitive randomization). The draws come from an explicit
torch.Generator, consumed in the order the reference splits its key; they
cannot match `jax.random`'s bits, so parity tests hand the reference's
state across instead.
"""

from __future__ import annotations

import torch

from mundy_tpu_torch.geom.primitives import Ellipsoid, LineSegment, Ring, Sphere, Spherocylinder
from mundy_tpu_torch.math.quaternion import quat_normalize, quat_rotate


def random_points_in_box(gen: torch.Generator, n: int, low, high, dtype=torch.float32,
                         device=None) -> torch.Tensor:
    """(n, 3) uniform points in the box [low, high)."""
    low = torch.as_tensor(low, dtype=dtype, device=device)
    high = torch.as_tensor(high, dtype=dtype, device=device)
    u = torch.rand((n, 3), generator=gen, dtype=dtype, device=device)
    return low + u * (high - low)


def random_unit_quaternions(gen: torch.Generator, n: int, dtype=torch.float32,
                            device=None) -> torch.Tensor:
    """(n, 4) uniform (Haar) random rotations: normalised 4-D Gaussians."""
    q = torch.randn((n, 4), generator=gen, dtype=dtype, device=device)
    return quat_normalize(q)


def _uniform_range(gen: torch.Generator, n: int, rng, dtype, device) -> torch.Tensor:
    """(n,) uniform in [lo, hi) for rng = (lo, hi), or the constant rng."""
    lo, hi = (rng if isinstance(rng, (tuple, list)) else (rng, rng))
    u = torch.rand((n,), generator=gen, dtype=dtype, device=device)
    return float(lo) + u * (float(hi) - float(lo))


def random_spheres(gen: torch.Generator, n: int, low, high, radius=0.5, dtype=torch.float32,
                   device=None) -> Sphere:
    """n spheres: centers in the box, radii in `radius` (a scalar or a (lo,
    hi) range)."""
    return Sphere(center=random_points_in_box(gen, n, low, high, dtype, device),
                  radius=_uniform_range(gen, n, radius, dtype, device))


def random_spherocylinders(gen: torch.Generator, n: int, low, high, radius=0.5, length=2.0,
                           dtype=torch.float32, device=None) -> Spherocylinder:
    """n capsules: centers in the box, Haar orientations, radii and lengths
    in their ranges."""
    return Spherocylinder(center=random_points_in_box(gen, n, low, high, dtype, device),
                          orientation=random_unit_quaternions(gen, n, dtype, device),
                          radius=_uniform_range(gen, n, radius, dtype, device),
                          length=_uniform_range(gen, n, length, dtype, device))


def random_segments(gen: torch.Generator, n: int, low, high, length=1.0, dtype=torch.float32,
                    device=None) -> LineSegment:
    """n segments: the start in the box, a Haar-random direction, the length
    in its range."""
    start = random_points_in_box(gen, n, low, high, dtype, device)
    zhat = torch.tensor([0.0, 0.0, 1.0], dtype=dtype, device=device)
    d = quat_rotate(random_unit_quaternions(gen, n, dtype, device), zhat)
    ln = _uniform_range(gen, n, length, dtype, device)
    return LineSegment(start=start, end=start + ln[:, None] * d)


def random_ellipsoids(gen: torch.Generator, n: int, low, high, radii=(1.0, 0.7, 0.4),
                      dtype=torch.float32, device=None) -> Ellipsoid:
    """n ellipsoids: centers in the box, Haar orientations, each semi-axis in
    its range ((lo, hi) per axis, or a fixed value)."""
    center = random_points_in_box(gen, n, low, high, dtype, device)
    orientation = random_unit_quaternions(gen, n, dtype, device)
    semis = torch.stack([_uniform_range(gen, n, radii[i], dtype, device) for i in range(3)],
                        dim=-1)
    return Ellipsoid(center=center, orientation=orientation, radii=semis)


def random_rings(gen: torch.Generator, n: int, low, high, major_radius=1.0, minor_radius=0.2,
                 dtype=torch.float32, device=None) -> Ring:
    """n tori."""
    return Ring(center=random_points_in_box(gen, n, low, high, dtype, device),
                orientation=random_unit_quaternions(gen, n, dtype, device),
                major_radius=_uniform_range(gen, n, major_radius, dtype, device),
                minor_radius=_uniform_range(gen, n, minor_radius, dtype, device))
