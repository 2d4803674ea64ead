"""Kernel K4: segment-segment contact on the row layout, the rods op.

Port of mundy_tpu/ops/pallas/row_segments.py::row_segment_pairs_sym as the
rods app calls it (force and torque, driver/apps/rods_rows.py). On a CUDA
tensor the wrapper launches the hand-written kernel of
csrc/row_segments.cu (one block per row, the 9 image-shifted candidate rows
staged in shared memory, one-sided register sums up to each row's last
valid slot; see the note there). On
a CPU tensor it computes the plain version, `row_segment_pairs_plain`:
neighbor/rows.pair_accumulate_segments with the rods out_fn, the JAX
package's own path for this kernel off the TPU. A CUDA tensor never takes
the plain version: a failed build or launch raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from mundy_tpu_torch.forces.contact import hertzian_pair_force
from mundy_tpu_torch.neighbor.rows import pair_accumulate_segments
from mundy_tpu_torch.ops.kernels import _build

_DTYPES = {torch.float32: "f32", torch.float64: "f64"}


def _check(mid: torch.Tensor, half_edges: torch.Tensor, box) -> None:
    if mid.ndim != 4 or mid.shape[-1] != 3:
        raise ValueError(f"mid must be (ny, nz, R, 3), got {tuple(mid.shape)}")
    if half_edges.shape != mid.shape:
        raise ValueError(f"half_edges {tuple(half_edges.shape)} must match "
                         f"mid {tuple(mid.shape)}")
    if mid.dtype not in _DTYPES or half_edges.dtype != mid.dtype:
        raise TypeError(f"mid and half_edges must share float32 or float64, got "
                        f"{mid.dtype} and {half_edges.dtype}")
    if half_edges.device != mid.device:
        raise ValueError("mid and half_edges must lie on one device")
    if mid.shape[0] < 5 or mid.shape[1] < 5:
        raise ValueError("row_segment_pairs_sym needs ny, nz >= 5")
    if len(box) != 3:
        raise ValueError("box must hold the three periodic box lengths")


def _consts(radius: float, e_eff: float, dtype, device):
    """2 radius, R* = radius / 2 and E* as 0-d tensors in the working
    dtype."""
    kw = dict(dtype=dtype, device=device)
    r_eff = torch.tensor(0.5 * radius, **kw)
    e = torch.tensor(float(e_eff), **kw)
    return torch.tensor(2.0 * radius, **kw), r_eff, e


@functools.lru_cache(maxsize=None)
def _hertz_coef(radius: float, e_eff: float, dtype) -> float:
    """4/3 E* sqrt(R*) in the working dtype, rounded on the host as
    hertzian_pair_force rounds it (cached: no host work per launch)."""
    _, r_eff, e = _consts(radius, e_eff, dtype, "cpu")
    return float((4.0 / 3.0) * e * torch.sqrt(r_eff))


def row_segment_pairs_plain(mid: torch.Tensor, half_edges: torch.Tensor, box,
                            radius: float, e_eff: float):
    """Plain PyTorch version of K4 (any device): (force, torque), each
    (ny, nz, R, 3), over the full 9-row stencil."""
    _check(mid, half_edges, box)
    two_r, r_eff, e = _consts(radius, e_eff, mid.dtype, mid.device)

    def out_fn(s, t, dx, dy, dz, d2, oex, _cex, oey, _cey, oez, _cez):
        d2c = torch.clamp(d2, min=1e-24)
        rinv = torch.rsqrt(d2c)
        dist = d2c * rinv
        mag = hertzian_pair_force(dist - two_r, r_eff, e)
        w = -(mag * rinv)  # force on the own rod along own -> cand
        fx, fy, fz = w * dx, w * dy, w * dz
        # contact point in the own-center frame: c1 + radius * d_hat with
        # c1 = (2s - 1) * half_edge
        u2 = 2.0 * s - 1.0
        rr = radius * rinv
        px = u2 * oex + rr * dx
        py = u2 * oey + rr * dy
        pz = u2 * oez + rr * dz
        return (fx, fy, fz, py * fz - pz * fy, pz * fx - px * fz, px * fy - py * fx)

    boxs = (tuple(float(b) for b in box), (True, True, True))
    hx, hy, hz = half_edges[..., 0], half_edges[..., 1], half_edges[..., 2]
    fx, fy, fz, tx, ty, tz = pair_accumulate_segments(
        mid, boxs, half_edges, out_fn, extra_fields=(hx, hy, hz))
    return torch.stack([fx, fy, fz], dim=-1), torch.stack([tx, ty, tz], dim=-1)


def _launch(mid, half_edges, valid, box, radius, e_eff):
    lib = _build.load("row_segments")
    fn = getattr(lib, f"row_segment_rods_{_DTYPES[mid.dtype]}")
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
                   + [ctypes.c_double] * 8 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    ny, nz, R, _ = mid.shape
    out = torch.empty((ny, nz, R, 6), dtype=mid.dtype, device=mid.device)
    coef = _hertz_coef(float(radius), float(e_eff), mid.dtype)
    eps = 1e-12 if mid.dtype == torch.float64 else 1e-8
    noise_c = (32.0 * float(torch.finfo(mid.dtype).eps)) ** 2
    with torch.cuda.device(mid.device):
        stream = torch.cuda.current_stream(mid.device).cuda_stream
        err = fn(mid.data_ptr(), half_edges.data_ptr(), valid.data_ptr(),
                 out.data_ptr(), ny, nz, R,
                 float(box[0]), float(box[1]), float(box[2]), 2.0 * radius,
                 float(radius), coef, eps, noise_c, stream)
    if err != 0:
        raise RuntimeError(f"row_segments kernel launch failed: CUDA error {err}")
    return out[..., :3], out[..., 3:]


def row_segment_pairs_sym(mid: torch.Tensor, half_edges: torch.Tensor,
                          valid: torch.Tensor, box, radius: float, e_eff: float):
    """Rods contact force and torque on the row layout: (force, torque),
    each (ny, nz, R, 3) in mid's dtype.

    mid: (ny, nz, R, 3) float32/float64 rod midpoints from build_rows
    (sentinel invalid slots, ny, nz >= 5); half_edges: the same shape, zero
    on invalid slots; valid: the (ny, nz, R) bool mask of build_rows; box:
    the three periodic box lengths; Hertzian contact with R* = radius / 2
    and E* = e_eff between the rods' closest points. CUDA tensors must be
    contiguous and launch the kernel (counted in `.launches`), which stops
    each row's loops at its last valid slot; CPU tensors compute the plain
    version, which visits every slot and needs no mask (invalid slots add
    exact zeros)."""
    _check(mid, half_edges, box)
    if valid.shape != mid.shape[:3] or valid.dtype != torch.bool:
        raise ValueError(f"valid must be a bool {tuple(mid.shape[:3])} mask")
    if valid.device != mid.device:
        raise ValueError("mid and valid must lie on one device")
    if mid.device.type == "cpu":
        return row_segment_pairs_plain(mid, half_edges, box, radius, e_eff)
    if mid.device.type != "cuda":
        raise ValueError(f"no K4 kernel for device {mid.device}")
    if not (mid.is_contiguous() and half_edges.is_contiguous()
            and valid.is_contiguous()):
        raise ValueError("mid, half_edges and valid must be contiguous")
    out = _launch(mid, half_edges, valid, box, radius, e_eff)
    row_segment_pairs_sym.launches += 1
    return out


row_segment_pairs_sym.launches = 0
