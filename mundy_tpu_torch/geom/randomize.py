"""Random configuration generation.

Port of `random_unit_quaternions` from mundy_tpu/geom/randomize.py. The
draws come from an explicit torch.Generator; they cannot match
`jax.random`'s bits, so parity tests hand the reference's state across
instead.
"""

from __future__ import annotations

import torch

from mundy_tpu_torch.math.quaternion import quat_normalize


def random_unit_quaternions(gen: torch.Generator, n: int, dtype=torch.float32,
                            device=None) -> torch.Tensor:
    """(n, 4) uniform (Haar) random rotations: normalised 4-D Gaussians."""
    q = torch.randn((n, 4), generator=gen, dtype=dtype, device=device)
    return quat_normalize(q)
