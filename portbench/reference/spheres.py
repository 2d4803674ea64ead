"""Plain reference of the Brownian Hertz spheres (BASELINE config #1).

Each step: every pair of spheres closer than 2r pushes apart with the Hertz
force F = 4/3 E* sqrt(r / 2) delta^(3/2), E* = E / (2 (1 - nu^2)), delta =
2r - d; each sphere moves by dt (F / (6 pi mu r) + sqrt(2 D / dt) z), z its
gid-keyed normals at that step; positions wrap into the periodic box. The
pairs come from a list of all pairs within 2r + SKIN, rebuilt whenever a
sphere has moved SKIN / 2 since the last build, so no contact is missed.
"""

from __future__ import annotations

import math

import torch

from portbench.reference.common import brownian, min_image, pairs_within, wrap

SKIN = 0.6


def hertz_forces(pos, i, j, box: float, radius: float, youngs: float,
                 poisson: float) -> torch.Tensor:
    """(n, 3) Hertz contact forces over the candidate pairs (i, j)."""
    sep = min_image(pos[j] - pos[i], box)
    d = torch.linalg.vector_norm(sep, dim=-1)
    delta = torch.clamp(2.0 * radius - d, min=0.0)
    e_star = youngs / (2.0 * (1.0 - poisson * poisson))
    mag = (4.0 / 3.0) * e_star * math.sqrt(0.5 * radius) * delta * torch.sqrt(delta)
    push = (mag / torch.clamp(d, min=1e-12))[:, None] * sep  # on j, away from i
    f = torch.zeros_like(pos)
    f.index_add_(0, j, push)
    f.index_add_(0, i, -push)
    return f


def follow(params: dict, pos: torch.Tensor, key_words, step0: int, n_steps: int,
           dtype=torch.float64) -> torch.Tensor:
    """Positions after n_steps steps from `pos` (n, 3), body g at row g, the
    first step numbered step0, computed in `dtype`."""
    box = float(params["box_size"])
    r = float(params["radius"])
    n = pos.shape[0]
    inv_drag = 1.0 / (6.0 * math.pi * float(params["viscosity"]) * r)
    dt = float(params["dt"])
    p = pos.to(dtype)
    built = None
    for step in range(step0, step0 + n_steps):
        if built is None or float(
                torch.linalg.vector_norm(min_image(p - built, box), dim=-1).max()) > SKIN / 2:
            i, j = pairs_within(p, box, 2.0 * r + SKIN)
            built = p
        f = hertz_forces(p, i, j, box, r, float(params["youngs_modulus"]),
                         float(params["poissons_ratio"]))
        v = inv_drag * f + brownian(key_words, step, n, float(params["diffusion_coeff"]),
                                    dt, dtype, p.device)
        p = wrap(p + dt * v, box)
    return p
