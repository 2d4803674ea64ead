"""Local (dry) Stokes drag mobility.

Port of mundy_tpu/mobility/local_drag.py. ref: the self-interaction term
of `compute_the_mobility_problem` (`StkNgpLCP.cpp:620-624`):
U = F / (6 pi mu a), and its rotational counterpart Omega = T / (8 pi mu
a^3).
"""

from __future__ import annotations

import math

import torch


def local_drag_mobility(forces: torch.Tensor, radius, viscosity) -> torch.Tensor:
    """U = F / (6 pi mu a); radius a python scalar or an (N,) tensor."""
    inv = 1.0 / (6.0 * math.pi * viscosity)
    if isinstance(radius, torch.Tensor) and radius.ndim > 0:
        return (inv / radius)[:, None] * forces
    return (inv / float(radius)) * forces


def local_drag_angular_mobility(torques: torch.Tensor, radius, viscosity) -> torch.Tensor:
    """Omega = T / (8 pi mu a^3); radius a python scalar or an (N,) tensor."""
    inv = 1.0 / (8.0 * math.pi * viscosity)
    if isinstance(radius, torch.Tensor) and radius.ndim > 0:
        return (inv / radius ** 3)[:, None] * torques
    return (inv / float(radius) ** 3) * torques
