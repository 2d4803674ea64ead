"""Constraint assembly and resolution: LCP non-penetration (BBPGD).

Port of mundy_tpu/constraints (ref: `scrap/lcp_spheres/StkNgpLCP.cpp:705-875`).
"""

from mundy_tpu_torch.constraints.collision import (
    CollisionSetup,
    collision_setup_spheres,
    resolve_collisions,
    collision_forces,
    remap_gamma,
)

__all__ = [
    "CollisionSetup",
    "collision_setup_spheres",
    "resolve_collisions",
    "collision_forces",
    "remap_gamma",
]
