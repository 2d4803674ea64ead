"""Mechanical elements: the centerline-twist Kirchhoff rod.

Port of the rod part of mundy_tpu/mech/ (`mech.rod`); the ball joints of
`mech.joints` wait for their callers.
"""

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
]
