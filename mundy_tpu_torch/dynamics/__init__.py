"""Dynamics: counter-based Brownian noise and explicit integration.

Port of mundy_tpu/dynamics (ref: NodeEuler, ComputeBrownianVelocity).
"""

from mundy_tpu_torch.dynamics.integrators import euler_step, euler_step_rigid
from mundy_tpu_torch.dynamics.brownian import (
    brownian_velocity,
    brownian_velocity_keyed,
    brownian_angular_velocity,
)

__all__ = [
    "euler_step",
    "euler_step_rigid",
    "brownian_velocity",
    "brownian_velocity_keyed",
    "brownian_angular_velocity",
]
