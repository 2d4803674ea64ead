"""Kernel K6: masked full-stencil Hertzian forces on the row layout.

Port of mundy_tpu/ops/pallas/row_hertz.py::row_hertzian_forces, with the
radius plane that the polydisperse row engine needs. On a CUDA tensor the
wrapper launches the hand-written kernel of csrc/row_hertz.cu (one block per
row, the occupied slots of the 9 candidate rows packed in shared memory, a
group of 8 lanes per own sphere visiting the chunks within reach in x,
pairs out of contact stopped before their square roots; see the note
there); with no radius plane it hands the kernel a constant one, on which
the polydisperse law is the monodisperse law. On a CPU tensor it computes
the plain version, `row_hertzian_forces_plain`:
neighbor/rows.pair_accumulate_central with the Hertzian scalar law, the
JAX package's own non-TPU force for this kernel (its test holds K6 to it
within 5e-5 of max|f|), with the mask riding as a payload plane and, given
a radius plane, the radii too (the reference's polydisperse branch). A CUDA
tensor never takes the plain version: a failed build or launch raises.
"""

from __future__ import annotations

import ctypes

import torch

from mundy_tpu_torch.forces.contact import hertzian_pair_force
from mundy_tpu_torch.neighbor.rows import pair_accumulate_central
from mundy_tpu_torch.ops.kernels import _build

_DTYPES = {torch.float32: "f32", torch.float64: "f64"}
_SMEM_DEFAULT = 48 * 1024  # shared memory a block gets without the opt-in
# the kernel's factor on the squared contact distance of its early stop
# (exact in both dtypes; the note of csrc/row_hertz.cu shows it covers the
# rounding of a pair)
REACH_MARGIN = 1.0 + 2.0 ** -10


def shared_bytes(R: int, itemsize: int) -> int:
    """Dynamic shared memory of one block (csrc/row_hertz.cu): the packed
    x, y, z, radius entries of the 9 candidate rows, the x bounds and
    greatest radius of each chunk of 8 of them, the own slots and the 9
    counts."""
    return (36 * R + 36 * -(-R // 8)) * itemsize + 4 * R + 36


def fits(R: int, itemsize: int, device) -> bool:
    """True when shared_bytes(R, itemsize) lies within the card's opt-in
    shared memory per block (asked of the card only past the 48 KB every
    block gets)."""
    smem = shared_bytes(R, itemsize)
    return smem <= _SMEM_DEFAULT or (
        smem <= torch.cuda.get_device_properties(device).shared_memory_per_block_optin)


def _check(pos, valid, box, radii) -> None:
    if pos.ndim != 4 or pos.shape[-1] != 3:
        raise ValueError(f"pos must be (ny, nz, R, 3), got {tuple(pos.shape)}")
    if pos.dtype not in _DTYPES:
        raise TypeError(f"pos must be float32 or float64, got {pos.dtype}")
    if valid.shape != pos.shape[:3] or valid.dtype != torch.bool:
        raise ValueError(f"valid must be a bool {tuple(pos.shape[:3])} mask")
    if radii is not None and (radii.shape != pos.shape[:3] or radii.dtype != pos.dtype):
        raise ValueError(f"radii must be a {tuple(pos.shape[:3])} plane in pos's dtype")
    if pos.shape[0] < 5 or pos.shape[1] < 5:
        raise ValueError("row_hertzian_forces needs ny, nz >= 5")
    if len(box) != 3:
        raise ValueError("box must hold the three periodic box lengths")


def _e_eff(youngs: float, poisson: float) -> float:
    return youngs / (2.0 * (1.0 - poisson * poisson))


def contact_reach(r2: torch.Tensor, ro: torch.Tensor, rc: torch.Tensor) -> torch.Tensor:
    """The kernel's early stop, operation for operation in r2's dtype: True
    where it goes on past a pair's squared separation r2, r2 <= (ro + rc)^2
    REACH_MARGIN with each operation rounded on its own. A pair it rejects
    is out of contact, and the plain version gives it an exactly zero
    force."""
    s = ro + rc
    return r2 <= s * s * REACH_MARGIN


def hertz_scalar_fn(radius: float, youngs: float, poisson: float, dtype, device):
    """The plain version's pair law: w(r2, own mask, candidate mask[, own
    radius, candidate radius]) with f_i = sum_j w sep_ij; with no radii the
    monodisperse law at `radius`."""
    kw = dict(dtype=dtype, device=device)
    two_r = torch.tensor(2.0 * radius, **kw)
    r_eff = torch.tensor(0.5 * radius, **kw)
    e_eff = torch.tensor(_e_eff(youngs, poisson), **kw)

    def scalar_fn(r2, ov, cv, *rad):
        r2 = torch.clamp(r2, min=1e-24)
        rinv = torch.rsqrt(r2)
        d = r2 * rinv
        if rad:
            ro, rc = rad
            re = (ro * rc) / torch.clamp(ro + rc, min=1e-12)
            mag = hertzian_pair_force(d - (ro + rc), re, e_eff)
        else:
            mag = hertzian_pair_force(d - two_r, r_eff, e_eff)
        return torch.where((ov * cv) > 0.5, -mag * rinv, 0.0)

    return scalar_fn


def row_hertzian_forces_plain(pos: torch.Tensor, valid: torch.Tensor, box,
                              radius: float, youngs: float, poisson: float,
                              radii=None) -> torch.Tensor:
    """Plain PyTorch version of K6 (any device): (ny, nz, R, 3) forces,
    pair_accumulate_central with the mask (and the radii) as payloads: the
    minimum image on all three axes, as K6 takes it."""
    _check(pos, valid, box, radii)
    fields = (valid.to(pos.dtype),) + (() if radii is None else (radii,))
    boxs = (tuple(float(b) for b in box), (True, True, True))
    return pair_accumulate_central(
        pos, boxs, hertz_scalar_fn(radius, youngs, poisson, pos.dtype, pos.device),
        extra_fields=fields)


def _launch(pos, valid, radii, box, youngs, poisson) -> torch.Tensor:
    lib = _build.load("row_hertz")
    fn = getattr(lib, f"row_hertzian_forces_{_DTYPES[pos.dtype]}")
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_double] * 5
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    ny, nz, R, _ = pos.shape
    out = torch.empty_like(pos)
    coef = (4.0 / 3.0) * _e_eff(youngs, poisson)
    with torch.cuda.device(pos.device):
        stream = torch.cuda.current_stream(pos.device).cuda_stream
        err = fn(pos.data_ptr(), valid.data_ptr(), radii.data_ptr(), out.data_ptr(), ny, nz,
                 R, float(box[0]), float(box[1]), float(box[2]), coef, REACH_MARGIN, stream)
    if err != 0:
        raise RuntimeError(f"row_hertz kernel launch failed: CUDA error {err} (R = {R})")
    return out


def row_hertzian_forces(pos: torch.Tensor, valid: torch.Tensor, box, radius: float,
                        youngs: float, poisson: float, radii=None) -> torch.Tensor:
    """Masked Hertzian row forces over the full 9-row stencil, (ny, nz, R, 3)
    in pos's dtype.

    pos: (ny, nz, R, 3) float32/float64 positions in the periodic box
    (ny, nz >= 5); valid: the (ny, nz, R) bool mask; box: the three
    periodic box lengths; E* = youngs / (2 (1 - poisson^2)) and, with no
    `radii`, R* = radius / 2 and contact at 2 radius. `radii`: an optional
    (ny, nz, R) radius plane (zero on invalid slots) for the polydisperse
    law, R* = ro rc / max(ro + rc, 1e-12) and contact at ro + rc. A CUDA
    tensor must be contiguous and launches the kernel (counted in
    `.launches`), with a constant radius plane when `radii` is None; its
    shared memory (`shared_bytes`; largest R 1400 in float32 and 708 in
    float64 on an H100) must lie within the card's opt-in. A CPU tensor
    computes the plain version."""
    _check(pos, valid, box, radii)
    if pos.device.type == "cpu":
        return row_hertzian_forces_plain(pos, valid, box, radius, youngs, poisson, radii)
    if pos.device.type != "cuda":
        raise ValueError(f"no K6 kernel for device {pos.device}")
    if not all(t.is_contiguous() for t in (pos, valid) + (() if radii is None else (radii,))):
        raise ValueError("pos, valid and radii must be contiguous")
    R, itemsize = pos.shape[2], pos.element_size()
    if not fits(R, itemsize, pos.device):
        raise ValueError(
            f"K6 cannot launch at R = {R}: it stages {shared_bytes(R, itemsize)} bytes "
            "of shared memory, which must lie within the card's opt-in")
    if radii is None:  # the monodisperse law: R* = r r / 2r, contact at 2r
        radii = valid.to(pos.dtype) * radius
    out = _launch(pos, valid, radii, box, youngs, poisson)
    row_hertzian_forces.launches += 1
    return out


row_hertzian_forces.launches = 0
