"""Batched small-vector algebra over trailing axes.

Port of the part of mundy_tpu/math/linalg.py that the rods and filaments
paths use: a "Vector3" is any tensor of shape (..., 3) and every operation
broadcasts over leading batch axes. The rest of the module waits for its
callers.
"""

from __future__ import annotations

import torch


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched inner product over the trailing axis: (..., d) x (..., d) -> (...)."""
    return torch.sum(a * b, dim=-1)


def norm(a: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sum(a * a, dim=-1))


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched 3-vector cross product."""
    return torch.stack(
        [
            a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
            a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
            a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0],
        ],
        dim=-1,
    )
