"""Kernel K1: Hertzian central forces on the row layout.

Port of mundy_tpu/ops/pallas/row_central.py::row_hertzian_forces_sym. On a
CUDA tensor the wrapper launches the hand-written kernel of
csrc/row_central.cu (one block per row, the occupied slots of the 9
image-shifted candidate rows packed in shared memory, one-sided register
sums over the chunks within reach in x, pairs out of contact stopped before
their square roots; see the note there). On a CPU tensor it computes the
plain version, `row_hertzian_forces_plain`: the half-stencil
pair_accumulate_central_sym with the Hertzian scalar law, the JAX package's
own fallback for this kernel. A CUDA tensor never takes the plain version:
a failed build or launch raises.
"""

from __future__ import annotations

import ctypes
import math

import torch

from mundy_tpu_torch.forces.contact import hertzian_pair_force
from mundy_tpu_torch.neighbor.rows import pair_accumulate_central_sym
from mundy_tpu_torch.ops.kernels import _build

_DTYPES = {torch.float32: "f32", torch.float64: "f64"}
# the kernel's factor on the squared contact distance of its early stop
# (exact in both dtypes; the note of csrc/row_central.cu shows it covers the
# rounding of a pair)
REACH_MARGIN = 1.0 + 2.0 ** -10


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


def hertz_scalar_fn(radius: float, youngs: float, poisson: float, dtype, device):
    """The plain version's pair law: w(r2) with f_i = sum_j w(r2_ij) sep_ij."""
    kw = dict(dtype=dtype, device=device)
    two_r = torch.tensor(2.0 * radius, **kw)
    r_eff = torch.tensor(0.5 * radius, **kw)
    e_eff = torch.tensor(_e_eff(youngs, poisson), **kw)

    def scalar_fn(r2):
        r2 = torch.clamp(r2, min=1e-24)
        rinv = torch.rsqrt(r2)
        mag = hertzian_pair_force(r2 * rinv - two_r, r_eff, e_eff)
        return -mag * rinv

    return scalar_fn


def contact_reach(r2: torch.Tensor, radius: float) -> torch.Tensor:
    """The kernel's early stop, operation for operation in r2's dtype: True
    where it goes on past a pair's squared separation r2, r2 <= (2 radius)^2
    REACH_MARGIN. A pair it rejects is out of contact, and the plain version
    gives it an exactly zero force."""
    two_r = torch.tensor(2.0 * radius, dtype=r2.dtype, device=r2.device)
    return r2 <= two_r * two_r * REACH_MARGIN


def row_hertzian_forces_plain(pos: torch.Tensor, box, radius: float,
                              youngs: float, poisson: float) -> torch.Tensor:
    """Plain PyTorch version of K1 (any device): (ny, nz, R, 3) forces."""
    _check(pos, box)
    boxs = (tuple(float(b) for b in box), (True, True, True))
    return pair_accumulate_central_sym(
        pos, boxs, hertz_scalar_fn(radius, youngs, poisson, pos.dtype, pos.device))


def _launch(pos: torch.Tensor, valid, box, radius, youngs, poisson) -> torch.Tensor:
    lib = _build.load("row_central")
    fn = getattr(lib, f"row_hertzian_forces_{_DTYPES[pos.dtype]}")
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_double] * 6
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    ny, nz, R, _ = pos.shape
    out = torch.empty_like(pos)
    coef = (4.0 / 3.0) * _e_eff(youngs, poisson) * math.sqrt(0.5 * radius)
    with torch.cuda.device(pos.device):
        stream = torch.cuda.current_stream(pos.device).cuda_stream
        err = fn(pos.data_ptr(), valid.data_ptr(), out.data_ptr(), ny, nz, R, float(box[0]), float(box[1]), float(box[2]),
                 2.0 * radius, coef, REACH_MARGIN, stream)
    if err != 0:
        raise RuntimeError(f"row_central kernel launch failed: CUDA error {err} "
                           f"(R = {R})")
    return out


def row_hertzian_forces_sym(pos: torch.Tensor, box, radius: float,
                            youngs: float, poisson: float,
                            valid: torch.Tensor | None = None) -> torch.Tensor:
    """Hertzian row forces, (ny, nz, R, 3) in pos's dtype.

    pos: (ny, nz, R, 3) float32/float64 positions from build_rows (sentinel
    invalid slots, ny, nz >= 5); box: the three periodic box lengths;
    E* = youngs / (2 (1 - poisson^2)), R* = radius / 2; valid: build_rows'
    (ny, nz, R) bool mask, optional: the kernel skips padded slots (their
    forces are +0, as the sentinels give them), and without it the wrapper
    passes a mask of all ones, which counts every slot as occupied (bit-equal,
    slower: the coincident sentinels of a row are evaluated). A CUDA tensor
    must be contiguous and launches the kernel (counted in `.launches`),
    which needs (36 R + 18 ceil(R / 32)) itemsize + 4 R bytes of shared
    memory per block (largest R 1546 in float32 and 783 in float64 on an
    H100) and raises past the card's opt-in; a CPU tensor computes the plain
    version, which needs no mask."""
    _check(pos, box)
    if valid is not None and (valid.shape != pos.shape[:3] or valid.dtype != torch.bool
                              or valid.device != pos.device):
        raise ValueError(f"valid must be a bool {tuple(pos.shape[:3])} mask on pos's device")
    if pos.device.type == "cpu":
        return row_hertzian_forces_plain(pos, box, radius, youngs, poisson)
    if pos.device.type != "cuda":
        raise ValueError(f"no K1 kernel for device {pos.device}")
    if valid is None:
        valid = torch.ones(pos.shape[:3], dtype=torch.bool, device=pos.device)
    if not (pos.is_contiguous() and valid.is_contiguous()):
        raise ValueError("pos and valid must be contiguous")
    out = _launch(pos, valid, box, radius, youngs, poisson)
    row_hertzian_forces_sym.launches += 1
    return out


row_hertzian_forces_sym.launches = 0
