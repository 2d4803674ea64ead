"""Mechanical elements: the centerline-twist Kirchhoff rod and ball joints.

Port of mundy_tpu/mech/ (`mech.rod`, `mech.joints`).
"""

from mundy_tpu_torch.mech.joints import ball_joint_forces
from mundy_tpu_torch.mech.rod import (
    RodState,
    init_rod_edges,
    rod_curvature,
    rod_internal_forces,
    update_rod_edges,
)

__all__ = [
    "RodState",
    "init_rod_edges",
    "update_rod_edges",
    "rod_curvature",
    "rod_internal_forces",
    "ball_joint_forces",
]
