"""Assertions.

Port of mundy_tpu/core/errors.py. PyTorch runs eagerly, so a host-side
`require` covers what the reference splits into `require` (concrete values)
and the in-jit `debug_assert`.
"""

from __future__ import annotations

from typing import Any

import torch


class MundyError(RuntimeError):
    """Framework error with context."""


def require(condition: Any, message: str = "requirement failed") -> None:
    """Host-side requirement (always on). Raises MundyError.

    A tensor condition must hold everywhere; reading it waits for the device.
    """
    ok = bool(condition.all()) if isinstance(condition, torch.Tensor) else bool(condition)
    if not ok:
        raise MundyError(message)
