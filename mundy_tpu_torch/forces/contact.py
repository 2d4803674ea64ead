"""Hertzian contact: the pair law and its effective material constants.

Port of the scalar part of mundy_tpu/forces/contact.py (ref:
SphereSphereHertzianContact.cpp:199-210). The neighbor-matrix contact
functions come with a later slice.
"""

from __future__ import annotations

import torch


def hertzian_pair_force(sep: torch.Tensor, r_eff: torch.Tensor,
                        e_eff: torch.Tensor) -> torch.Tensor:
    """Hertz normal force magnitude F = 4/3 E* sqrt(R*) delta^{3/2}.

    `sep` is the signed surface separation (negative = overlap, delta = -sep);
    `r_eff` and `e_eff` are tensors in sep's dtype, as in the reference.
    """
    delta = torch.clamp(-sep, min=0.0)
    return (4.0 / 3.0) * e_eff * torch.sqrt(r_eff) * delta * torch.sqrt(delta)


def effective_radius(r1, r2):
    return (r1 * r2) / (r1 + r2)


def effective_youngs(e1, e2, nu1, nu2):
    return (e1 * e2) / (e2 - e2 * nu1 * nu1 + e1 - e1 * nu2 * nu2)
