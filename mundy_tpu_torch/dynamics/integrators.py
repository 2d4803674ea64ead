"""Explicit node Euler integration.

Port of mundy_tpu/dynamics/integrators.py::euler_step (ref:
integrate_positions_node_euler, HP1 driver `:1523`). The rigid-body
quaternion step waits for the rods slice.
"""

from __future__ import annotations

from typing import Optional

import torch

from mundy_tpu_torch.geom.periodicity import Metric


def euler_step(pos: torch.Tensor, vel: torch.Tensor, dt,
               metric: Optional[Metric] = None) -> torch.Tensor:
    """x <- x + dt v, wrapped into the periodic cell if a metric is given."""
    out = pos + dt * vel
    return metric.wrap(out) if metric is not None else out
