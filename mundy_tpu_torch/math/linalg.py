"""Batched small-vector algebra over trailing axes.

Port of mundy_tpu/math/linalg.py: a "Vector3" is any tensor of shape
(..., 3) and every operation broadcasts over leading batch axes.
"""

from __future__ import annotations

import torch


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched inner product over the trailing axis: (..., d) x (..., d) -> (...)."""
    return torch.sum(a * b, dim=-1)


def norm_sq(a: torch.Tensor) -> torch.Tensor:
    return torch.sum(a * a, dim=-1)


def norm(a: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(norm_sq(a))


def normalize(a: torch.Tensor, eps: float = 0.0) -> torch.Tensor:
    """Unit vector along `a`; with eps > 0 the zero vector (|a| <= eps)
    maps to 0."""
    n = norm(a)
    if eps > 0.0:
        safe = torch.clamp(n, min=eps)
        return torch.where(n[..., None] > eps, a / safe[..., None], 0.0)
    return a / n[..., None]


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


def outer(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched outer product: (..., n) x (..., m) -> (..., n, m)."""
    return a[..., :, None] * b[..., None, :]
