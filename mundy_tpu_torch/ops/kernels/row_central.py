"""Kernel K1: Hertzian central forces on the row layout.

Port of mundy_tpu/ops/pallas/row_central.py::row_hertzian_forces_sym. On a
CUDA tensor the wrapper launches the hand-written kernel of
csrc/row_central.cu (one block per row, the 9 image-shifted candidate rows
staged in shared memory, one-sided register sums; see the note there). On a
CPU tensor it computes the plain version, `row_hertzian_forces_plain`: the
half-stencil pair_accumulate_central_sym with the Hertzian scalar law, the
JAX package's own fallback for this kernel. A CUDA tensor never takes the
plain version: a failed build or launch raises.
"""

from __future__ import annotations

import ctypes
import math

import torch

from mundy_tpu_torch.forces.contact import hertzian_pair_force
from mundy_tpu_torch.neighbor.rows import pair_accumulate_central_sym
from mundy_tpu_torch.ops.kernels import _build

_DTYPES = {torch.float32: "f32", torch.float64: "f64"}


def _check(pos: torch.Tensor, box) -> None:
    if pos.ndim != 4 or pos.shape[-1] != 3:
        raise ValueError(f"pos must be (ny, nz, R, 3), got {tuple(pos.shape)}")
    if pos.dtype not in _DTYPES:
        raise TypeError(f"pos must be float32 or float64, got {pos.dtype}")
    if pos.shape[0] < 5 or pos.shape[1] < 5:
        raise ValueError("row_hertzian_forces_sym needs ny, nz >= 5")
    if len(box) != 3:
        raise ValueError("box must hold the three periodic box lengths")


def _e_eff(youngs: float, poisson: float) -> float:
    return youngs / (2.0 * (1.0 - poisson * poisson))


def row_hertzian_forces_plain(pos: torch.Tensor, box, radius: float,
                              youngs: float, poisson: float) -> torch.Tensor:
    """Plain PyTorch version of K1 (any device): (ny, nz, R, 3) forces."""
    _check(pos, box)
    kw = dict(dtype=pos.dtype, device=pos.device)
    two_r = torch.tensor(2.0 * radius, **kw)
    r_eff = torch.tensor(0.5 * radius, **kw)
    e_eff = torch.tensor(_e_eff(youngs, poisson), **kw)

    def scalar_fn(r2):
        r2 = torch.clamp(r2, min=1e-24)
        rinv = torch.rsqrt(r2)
        mag = hertzian_pair_force(r2 * rinv - two_r, r_eff, e_eff)
        return -mag * rinv

    boxs = (tuple(float(b) for b in box), (True, True, True))
    return pair_accumulate_central_sym(pos, boxs, scalar_fn)


def _launch(pos: torch.Tensor, box, radius, youngs, poisson) -> torch.Tensor:
    lib = _build.load("row_central")
    fn = getattr(lib, f"row_hertzian_forces_{_DTYPES[pos.dtype]}")
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int] + [ctypes.c_double] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    ny, nz, R, _ = pos.shape
    out = torch.empty_like(pos)
    coef = (4.0 / 3.0) * _e_eff(youngs, poisson) * math.sqrt(0.5 * radius)
    with torch.cuda.device(pos.device):
        stream = torch.cuda.current_stream(pos.device).cuda_stream
        err = fn(pos.data_ptr(), out.data_ptr(), ny, nz, R, float(box[0]),
                 float(box[1]), float(box[2]), 2.0 * radius, coef, stream)
    if err != 0:
        raise RuntimeError(f"row_central kernel launch failed: CUDA error {err}")
    return out


def row_hertzian_forces_sym(pos: torch.Tensor, box, radius: float,
                            youngs: float, poisson: float) -> torch.Tensor:
    """Hertzian row forces, (ny, nz, R, 3) in pos's dtype.

    pos: (ny, nz, R, 3) float32/float64 positions from build_rows (sentinel
    invalid slots, ny, nz >= 5); box: the three periodic box lengths;
    E* = youngs / (2 (1 - poisson^2)), R* = radius / 2. A CUDA tensor must be
    contiguous and launches the kernel (counted in `.launches`); a CPU tensor
    computes the plain version."""
    _check(pos, box)
    if pos.device.type == "cpu":
        return row_hertzian_forces_plain(pos, box, radius, youngs, poisson)
    if pos.device.type != "cuda":
        raise ValueError(f"no K1 kernel for device {pos.device}")
    if not pos.is_contiguous():
        raise ValueError("pos must be contiguous")
    out = _launch(pos, box, radius, youngs, poisson)
    row_hertzian_forces_sym.launches += 1
    return out


row_hertzian_forces_sym.launches = 0
