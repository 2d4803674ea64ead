"""Kernels K3 (strided-block segmented sum) and K3t (the fused i-side
Delassus half-apply).

Port of mundy_tpu/ops/pallas/seg_onehot.py::strided_onehot_segment_sum and
::strided_onehot_t. For K3, on a CUDA tensor the wrapper launches the
hand-written kernel of csrc/seg_onehot.cu (one block per body block; a
block whose ids are nondecreasing, as the LCP line's strided layout always
is, marks each segment's run of slots and sums it in slot order, one
thread per segment; any other block scans its slots per segment; see the
note there). On a CPU tensor it computes the plain version,
`strided_segment_sum_plain`: the blocked reduction, each segment summed over
its slots in increasing w order from zero, which is the order the kernel
adds in on both paths, so the two agree bit for bit. The TPU kernel's bf16
one-hot and three-term mantissa split are not carried over. A CUDA tensor never takes
the plain version: a failed build or launch raises.

K3t (`strided_onehot_t`) is K3's sum of -gamma n kept in shared memory and
read back per slot, t = -(n . F[loc]), in the same source and by K3's two
paths (run sums in a sorted block, the scan in any other); its plain
version, `strided_t_plain`, is K3's plain sum followed by the row gather
and the dot in the kernel's order, so the two agree bit for bit.
"""

from __future__ import annotations

import ctypes

import torch

from mundy_tpu_torch.io.telemetry import host_read
from mundy_tpu_torch.ops.kernels import _build

_DTYPES = {torch.float32: "f32", torch.float64: "f64"}


def _check(values: torch.Tensor, loc: torch.Tensor) -> None:
    if values.ndim != 3 or loc.ndim != 2 or values.shape[::2] != loc.shape:
        raise ValueError(f"values must be (nb, D, W) and loc (nb, W), got "
                         f"{tuple(values.shape)} and {tuple(loc.shape)}")
    if values.dtype not in _DTYPES:
        raise TypeError(f"values must be float32 or float64, got {values.dtype}")


def strided_segment_sum_plain(values: torch.Tensor, loc: torch.Tensor,
                              block_segments: int) -> torch.Tensor:
    """Plain PyTorch version of K3 (any device): (nb, D, W) values and
    (nb, W) local ids -> (nb, D, B) per-block segment sums; ids outside
    [0, B) are dropped. Each segment is summed over its slots in increasing
    w from zero: pass k adds, in every block at once, the k-th slot (in w
    order) of each segment, so the passes are as many as the longest
    segment's slots, and no two adds of a pass meet."""
    _check(values, loc)
    nb, D, W = values.shape
    B = block_segments
    dev = values.device
    kept = (loc >= 0) & (loc < B)
    col = torch.where(kept, loc.to(torch.int64), B)  # B: the dropped ids
    # each slot's rank among its segment's slots, in w order
    order = torch.argsort(col, dim=1, stable=True)
    sc = torch.gather(col, 1, order)
    first = torch.ones_like(sc, dtype=torch.bool)
    first[:, 1:] = sc[:, 1:] != sc[:, :-1]
    ar = torch.arange(W, device=dev).expand(nb, W)
    rank_sorted = ar - torch.cummax(torch.where(first, ar, 0), dim=1).values
    rank = torch.empty_like(rank_sorted).scatter_(1, order, rank_sorted)
    rank = torch.where(kept, rank, -1)
    vt = values.transpose(1, 2)  # (nb, W, D)
    out = values.new_zeros((nb, B, D))
    for k in range(host_read("seg_sum.plain", rank.max()) + 1 if rank.numel() else 0):
        b, w = torch.nonzero(rank == k, as_tuple=True)
        c = col[b, w]
        out[b, c] = out[b, c] + vt[b, w]
    return out.permute(0, 2, 1).contiguous()


def _launch(values: torch.Tensor, loc: torch.Tensor, B: int) -> torch.Tensor:
    lib = _build.load("seg_onehot")
    fn = getattr(lib, f"strided_segment_sum_{_DTYPES[values.dtype]}")
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    nb, _, W = values.shape
    out = torch.empty((nb, 3, B), dtype=values.dtype, device=values.device)
    with torch.cuda.device(values.device):
        stream = torch.cuda.current_stream(values.device).cuda_stream
        err = fn(values.data_ptr(), loc.data_ptr(), out.data_ptr(), nb, W, B, stream)
    if err != 0:
        raise RuntimeError(f"seg_onehot kernel launch failed: CUDA error {err}")
    return out


def strided_onehot_segment_sum(values: torch.Tensor, loc: torch.Tensor,
                               block_segments: int) -> torch.Tensor:
    """Per-block segmented reduction -> (nb, D, B) in values' dtype.

    out[b, :, s] = sum over w with loc[b, w] == s of values[b, :, w]; ids
    outside [0, B) are dropped. A CPU tensor computes the plain version. A
    CUDA tensor launches the kernel (counted in `.launches`); it needs
    D = 3, int32 loc and contiguous inputs, or the wrapper raises."""
    _check(values, loc)
    if values.device.type == "cpu":
        return strided_segment_sum_plain(values, loc, block_segments)
    if values.device.type != "cuda":
        raise ValueError(f"no K3 kernel for device {values.device}")
    if values.shape[1] != 3:
        raise ValueError(f"K3 sums 3-vectors, got D = {values.shape[1]}")
    if loc.dtype != torch.int32:
        raise TypeError(f"loc must be int32, got {loc.dtype}")
    if not (values.is_contiguous() and loc.is_contiguous()):
        raise ValueError("values and loc must be contiguous")
    if block_segments < 1:
        raise ValueError("block_segments must be positive")
    if values.shape[0] == 0:
        return values.new_zeros((0, 3, block_segments))
    out = _launch(values, loc, block_segments)
    strided_onehot_segment_sum.launches += 1
    return out


strided_onehot_segment_sum.launches = 0


def _check_t(gamma: torch.Tensor, normals: torch.Tensor, loc: torch.Tensor) -> None:
    if (normals.ndim != 3 or normals.shape[1] != 3 or gamma.shape != loc.shape
            or normals.shape[::2] != loc.shape):
        raise ValueError(f"gamma and loc must be (nb, W) and normals (nb, 3, W), got "
                         f"{tuple(gamma.shape)}, {tuple(loc.shape)} and "
                         f"{tuple(normals.shape)}")
    if normals.dtype not in _DTYPES or gamma.dtype != normals.dtype:
        raise TypeError(f"gamma and normals must share float32 or float64, got "
                        f"{gamma.dtype} and {normals.dtype}")


def strided_t_plain(gamma: torch.Tensor, normals: torch.Tensor, loc: torch.Tensor,
                    block_segments: int) -> torch.Tensor:
    """Plain PyTorch version of K3t (any device): (nb, W) gamma, (nb, 3, W)
    normals and (nb, W) local ids -> (nb, W) t = -(n . F[loc]) with F the
    block's K3 sum of (-gamma) n; ids outside [0, B) give t = 0."""
    _check_t(gamma, normals, loc)
    B = block_segments
    F = strided_segment_sum_plain(-gamma[:, None, :] * normals, loc, B)
    valid = (loc >= 0) & (loc < B)
    lc = torch.where(valid, loc.to(torch.int64), 0)
    fx, fy, fz = (torch.gather(F[:, c], 1, lc) for c in range(3))
    t = -((normals[:, 0] * fx + normals[:, 1] * fy) + normals[:, 2] * fz)
    return torch.where(valid, t, 0.0)


def strided_onehot_t(gamma: torch.Tensor, normals: torch.Tensor, loc: torch.Tensor,
                     block_segments: int) -> torch.Tensor:
    """Fused i-side Delassus half-apply -> (nb, W) t in gamma's dtype.

    t_p = -n_p . F_{i(p)} with F_i = sum over the block's pairs p' of body i
    of -gamma_p' n_p'; ids outside [0, B) give t = 0. A CPU tensor computes
    the plain version. A CUDA tensor launches the kernel (counted in
    `.launches`); it needs int32 loc and contiguous inputs, or the wrapper
    raises."""
    _check_t(gamma, normals, loc)
    if gamma.device.type == "cpu":
        return strided_t_plain(gamma, normals, loc, block_segments)
    if gamma.device.type != "cuda":
        raise ValueError(f"no K3t kernel for device {gamma.device}")
    if loc.dtype != torch.int32:
        raise TypeError(f"loc must be int32, got {loc.dtype}")
    if not (gamma.is_contiguous() and normals.is_contiguous() and loc.is_contiguous()):
        raise ValueError("gamma, normals and loc must be contiguous")
    if block_segments < 1:
        raise ValueError("block_segments must be positive")
    nb, W = gamma.shape
    t = torch.empty_like(gamma)
    if nb == 0:
        return t
    lib = _build.load("seg_onehot")
    fn = getattr(lib, f"strided_t_{_DTYPES[gamma.dtype]}")
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(gamma.device):
        stream = torch.cuda.current_stream(gamma.device).cuda_stream
        err = fn(gamma.data_ptr(), normals.data_ptr(), loc.data_ptr(), t.data_ptr(),
                 nb, W, block_segments, stream)
    if err != 0:
        raise RuntimeError(f"seg_onehot strided_t kernel launch failed: CUDA error {err}")
    strided_onehot_t.launches += 1
    return t


strided_onehot_t.launches = 0
