"""Explicit integrators: node Euler and the rigid-body quaternion update.

Port of mundy_tpu/dynamics/integrators.py (ref:
integrate_positions_node_euler, HP1 driver `:1523`). The quaternion update
uses the exact exponential map (math/quaternion.quat_integrate).
"""

from __future__ import annotations

from typing import Optional

import torch

from mundy_tpu_torch.geom.periodicity import Metric
from mundy_tpu_torch.math.quaternion import quat_integrate


def euler_step(pos: torch.Tensor, vel: torch.Tensor, dt,
               metric: Optional[Metric] = None) -> torch.Tensor:
    """x <- x + dt v, wrapped into the periodic cell if a metric is given."""
    out = pos + dt * vel
    return metric.wrap(out) if metric is not None else out


def euler_step_rigid(pos: torch.Tensor, quat: torch.Tensor, vel: torch.Tensor,
                     omega: torch.Tensor, dt, metric: Optional[Metric] = None):
    """Translate and rotate one explicit step; returns (pos, quat)."""
    return euler_step(pos, vel, dt, metric), quat_integrate(quat, omega, dt)
