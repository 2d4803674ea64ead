"""Per-dtype zero tolerances.

Port of mundy_tpu/math/tolerance.py (ref: `mundy/math/src/mundy_math/
Tolerance.hpp`, `get_zero_tolerance` per scalar type): one table of "treat
as zero" thresholds, a few orders of magnitude above machine epsilon, keyed
by torch dtype.
"""

from __future__ import annotations

import torch

_TABLE = {
    torch.float64: 1e-12,
    torch.float32: 1e-5,
    torch.float16: 1e-2,
    torch.bfloat16: 1e-1,
}


def get_zero_tolerance(dtype: torch.dtype) -> float:
    """The "effectively zero" threshold for `dtype` (0 for integers)."""
    if dtype in _TABLE:
        return _TABLE[dtype]
    if not dtype.is_floating_point and not dtype.is_complex and dtype != torch.bool:
        return 0.0
    raise TypeError(f"no zero tolerance for dtype {dtype}")


def get_relative_tolerance(dtype: torch.dtype) -> float:
    """A ~100 ulp relative comparison tolerance for `dtype`."""
    if dtype == torch.bfloat16:
        return 100 * 2.0 ** -8
    return float(100 * torch.finfo(dtype).eps)
