"""Kernel K4: segment-segment contact on the row layout, two pair ops.

Port of mundy_tpu/ops/pallas/row_segments.py::row_segment_pairs_sym as its
two apps call it: the rods op (force and torque, driver/apps/rods_rows.py),
`row_segment_pairs_sym`, and the filaments op (the force split to the
segment's two nodes, adjacent segments of one filament excluded by their
gids, driver/apps/filaments.py), `row_segment_filaments_sym`. On a CUDA
tensor each wrapper launches a hand-written kernel of csrc/row_segments.cu
(one-sided sums over the 9 image-shifted candidate rows; see the note
there). Both ops visit only the chunks of a row whose x range comes within
reach of the own segment and evaluate only the pairs that pass
`segment_reach`: the rods op with one block per row and its 9 candidate
rows staged in shared memory, the filaments op with one warp per chunk of
32 own slots over rows packed by a pre-pass. On a CPU tensor a wrapper
computes the plain version, `row_segment_pairs_plain` or
`row_segment_filaments_plain`: neighbor/rows.pair_accumulate_segments with
the app's out_fn, the JAX package's own path for this kernel off the TPU.
A CUDA tensor never takes the plain version: a failed build or launch
raises.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from mundy_tpu_torch.forces.contact import hertzian_pair_force
from mundy_tpu_torch.neighbor.rows import pair_accumulate_segments
from mundy_tpu_torch.ops.kernels import _build

_DTYPES = {torch.float32: "f32", torch.float64: "f64"}
# the rods kernel's factor on the squared reach (exact in both dtypes; the
# note of csrc/row_segments.cu shows it covers the rounding of a pair)
REACH_MARGIN = 1.0 + 2.0 ** -10


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


def rods_out_fn(radius: float, e_eff: float, dtype, device):
    """The rods op's out_fn for pair_accumulate_segments (per-pair planes
    in, the force and torque components on the own rod out)."""
    two_r, r_eff, e = _consts(radius, e_eff, dtype, device)

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

    return out_fn


def row_segment_pairs_plain(mid: torch.Tensor, half_edges: torch.Tensor, box,
                            radius: float, e_eff: float):
    """Plain PyTorch version of K4 (any device): (force, torque), each
    (ny, nz, R, 3), over the full 9-row stencil."""
    _check(mid, half_edges, box)
    boxs = (tuple(float(b) for b in box), (True, True, True))
    hx, hy, hz = half_edges[..., 0], half_edges[..., 1], half_edges[..., 2]
    fx, fy, fz, tx, ty, tz = pair_accumulate_segments(
        mid, boxs, half_edges, rods_out_fn(radius, e_eff, mid.dtype, mid.device),
        extra_fields=(hx, hy, hz))
    return torch.stack([fx, fy, fz], dim=-1), torch.stack([tx, ty, tz], dim=-1)


def half_edge_lengths(half_edges: torch.Tensor) -> torch.Tensor:
    """|e| per slot, rounded as the rods kernel rounds it."""
    hx, hy, hz = half_edges[..., 0], half_edges[..., 1], half_edges[..., 2]
    return torch.sqrt((hx * hx + hy * hy) + hz * hz)


def segment_reach(sx, sy, sz, len_own, len_cand, radius: float) -> torch.Tensor:
    """The rods kernel's reach test, operation for operation in the inputs'
    dtype: True where it evaluates a pair of centre separation (sx, sy, sz)
    (x minimum image taken) and half-edge lengths len_own, len_cand (from
    half_edge_lengths), s2 <= ((len_own + len_cand) + 2 radius)^2
    REACH_MARGIN. A pair it rejects cannot touch, and the plain version
    gives it an exactly zero force and torque."""
    two_r = torch.tensor(2.0 * radius, dtype=sx.dtype, device=sx.device)
    s2 = (sx * sx + sy * sy) + sz * sz
    reach = (len_own + len_cand) + two_r
    return ~(s2 > reach * reach * REACH_MARGIN)


def _scratch(mid):
    """The packed body's scratch: 4 values per slot (midpoint and |e|) and 3
    per chunk of 32 slots of a row (its x range and greatest |e|)."""
    ny, nz, R, _ = mid.shape
    return (torch.empty((ny, nz, R, 4), dtype=mid.dtype, device=mid.device),
            torch.empty((ny, nz, -(-R // 32), 3), dtype=mid.dtype, device=mid.device))


def _launch(op: str, mid, tensors, scalar_types, scalars):
    """Launch row_segment_<op>_<dtype> of csrc/row_segments.cu on the
    tensors (then the (ny, nz, R, 6) output), the row shape, the op's
    scalars and the closest-point constants; returns the output's two
    (ny, nz, R, 3) halves."""
    lib = _build.load("row_segments")
    fn = getattr(lib, f"row_segment_{op}_{_DTYPES[mid.dtype]}")
    fn.argtypes = ([ctypes.c_void_p] * (len(tensors) + 1) + [ctypes.c_int] * 3
                   + list(scalar_types) + [ctypes.c_double] * 2 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    ny, nz, R, _ = mid.shape
    out = torch.empty((ny, nz, R, 6), dtype=mid.dtype, device=mid.device)
    eps = 1e-12 if mid.dtype == torch.float64 else 1e-8
    noise_c = (32.0 * float(torch.finfo(mid.dtype).eps)) ** 2
    with torch.cuda.device(mid.device):
        stream = torch.cuda.current_stream(mid.device).cuda_stream
        err = fn(*(t.data_ptr() for t in tensors), out.data_ptr(), ny, nz, R, *scalars,
                 eps, noise_c, stream)
    if err != 0:
        raise RuntimeError(f"row_segments {op} kernel launch failed: CUDA error {err} "
                           f"(R = {R})")
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
    contiguous and launch the kernel (counted in `.launches`), which
    evaluates only the valid pairs that pass `segment_reach` and raises
    past the card's shared-memory opt-in (R = 826 in float32, 402 in
    float64 on an H100; the note of csrc/row_segments.cu); CPU tensors
    compute the plain version, which visits every slot and needs no mask
    (invalid slots and pairs out of reach add exact zeros)."""
    _check(mid, half_edges, box)
    _check_rows(mid, valid)
    if mid.device.type == "cpu":
        return row_segment_pairs_plain(mid, half_edges, box, radius, e_eff)
    if mid.device.type != "cuda":
        raise ValueError(f"no K4 kernel for device {mid.device}")
    if not (mid.is_contiguous() and half_edges.is_contiguous()
            and valid.is_contiguous()):
        raise ValueError("mid, half_edges and valid must be contiguous")
    coef = _hertz_coef(float(radius), float(e_eff), mid.dtype)
    out = _launch("rods", mid, (mid, half_edges, valid), [ctypes.c_double] * 7,
                  (*(float(b) for b in box), 2.0 * radius, float(radius), coef,
                   REACH_MARGIN))
    row_segment_pairs_sym.launches += 1
    return out


row_segment_pairs_sym.launches = 0


def _check_rows(mid, valid, gid=None) -> None:
    if valid.shape != mid.shape[:3] or valid.dtype != torch.bool:
        raise ValueError(f"valid must be a bool {tuple(mid.shape[:3])} mask")
    if valid.device != mid.device:
        raise ValueError("mid and valid must lie on one device")
    if gid is not None and (gid.shape != mid.shape[:3] or gid.dtype != torch.int32
                            or gid.device != mid.device):
        raise ValueError(f"gid must be an int32 {tuple(mid.shape[:3])} tensor "
                         "on mid's device")


def filaments_hertz_coef(radius: float, e_eff: float) -> float:
    """4/3 E* sqrt(R*) with R* = radius / 2, in float64 on the host: the
    filaments app passes python floats, so the reference rounds this
    product to the working dtype once, as a kernel argument is rounded."""
    return (4.0 / 3.0) * float(e_eff) * math.sqrt(0.5 * float(radius))


def filaments_out_fn(radius: float, e_eff: float, n_edges: int):
    """The filaments op's out_fn for pair_accumulate_segments (per-pair
    planes and the float gid payloads in, the start- and end-node force
    components on the own segment out)."""
    two_r = 2.0 * float(radius)
    coef = filaments_hertz_coef(radius, e_eff)
    E = int(n_edges)

    def out_fn(s, t, dx, dy, dz, d2, own_g, cand_g):
        d2c = torch.clamp(d2, min=1e-24)
        rinv = torch.rsqrt(d2c)
        delta = torch.clamp(-(d2c * rinv - two_r), min=0.0)
        mag = coef * delta * torch.sqrt(delta)
        # exclude same-filament adjacent segments: |dg| == 1 and the lower
        # gid not at a filament's last segment
        dg = cand_g - own_g
        min_g = torch.minimum(own_g, cand_g)
        adjacent = ((torch.abs(torch.abs(dg) - 1.0) < 0.5)
                    & (torch.abs(torch.remainder(min_g, float(E)) - (E - 1)) > 0.5))
        w = torch.where(adjacent, 0.0, -(mag * rinv))
        fx, fy, fz = w * dx, w * dy, w * dz
        ws, we = 1.0 - s, s
        return (ws * fx, ws * fy, ws * fz, we * fx, we * fy, we * fz)

    return out_fn


def row_segment_filaments_plain(mid: torch.Tensor, half_edges: torch.Tensor,
                                valid: torch.Tensor, gid: torch.Tensor, box,
                                radius: float, e_eff: float, n_edges: int):
    """Plain PyTorch version of K4's filaments op (any device): (f_start,
    f_end), each (ny, nz, R, 3), over the full 9-row stencil, with the gid
    riding as a float payload (-10 on invalid slots), as in the reference."""
    _check(mid, half_edges, box)
    _check_rows(mid, valid, gid)
    gid_f = torch.where(valid, gid.to(mid.dtype), -10.0)
    boxs = (tuple(float(b) for b in box), (True, True, True))
    fsx, fsy, fsz, fex, fey, fez = pair_accumulate_segments(
        mid, boxs, half_edges, filaments_out_fn(radius, e_eff, n_edges),
        extra_fields=(gid_f,))
    return torch.stack([fsx, fsy, fsz], dim=-1), torch.stack([fex, fey, fez], dim=-1)


def row_segment_filaments_sym(mid: torch.Tensor, half_edges: torch.Tensor,
                              valid: torch.Tensor, gid: torch.Tensor, box,
                              radius: float, e_eff: float, n_edges: int):
    """Filaments segment contact on the row layout: (f_start, f_end), each
    (ny, nz, R, 3) in mid's dtype, the contact force on each slot's segment
    split to its start and end node by the arc parameter of the contact.

    mid, half_edges, valid: as for row_segment_pairs_sym; gid: the
    (ny, nz, R) int32 segment gids of build_rows; n_edges: segments per
    filament, so gids g and g + 1 belong to one filament (and do not
    interact) unless g mod n_edges == n_edges - 1; Hertzian contact with
    R* = radius / 2 and E* = e_eff. CUDA tensors must be contiguous and
    launch the kernel (counted in `.launches`; a pre-pass packs the rows into
    a scratch of 4 R + 3 ceil(R / 32) values per row, and the pair kernel
    uses a fixed 5 KB of shared memory per block, 8 KB in float64, whatever
    R); CPU tensors compute the plain version."""
    _check(mid, half_edges, box)
    _check_rows(mid, valid, gid)
    if mid.device.type == "cpu":
        return row_segment_filaments_plain(mid, half_edges, valid, gid, box, radius,
                                           e_eff, n_edges)
    if mid.device.type != "cuda":
        raise ValueError(f"no K4 kernel for device {mid.device}")
    if not (mid.is_contiguous() and half_edges.is_contiguous()
            and valid.is_contiguous() and gid.is_contiguous()):
        raise ValueError("mid, half_edges, valid and gid must be contiguous")
    out = _launch("filaments", mid, (mid, half_edges, valid, gid, *_scratch(mid)),
                  [ctypes.c_double] * 5 + [ctypes.c_int, ctypes.c_double],
                  (*(float(b) for b in box), 2.0 * float(radius),
                   filaments_hertz_coef(radius, e_eff), int(n_edges), REACH_MARGIN))
    row_segment_filaments_sym.launches += 1
    return out


row_segment_filaments_sym.launches = 0
