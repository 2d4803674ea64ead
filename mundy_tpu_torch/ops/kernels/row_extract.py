"""Kernel K2: K nearest in-cutoff neighbors per row slot.

Port of mundy_tpu/ops/pallas/row_extract.py::row_neighbor_extract. On a
CUDA tensor the wrapper launches the hand-written kernel of
csrc/row_extract.cu (one block per row, the occupied slots of the 9
image-shifted candidate rows packed in shared memory, each warp testing
chunks of CHUNK packed candidates against the x interval of its
OWN_GROUP own slots and visiting those within the cut in x with 8 lanes
per own slot, each own slot keeping a sorted top-K list; see the note
there). On a CPU tensor it computes the plain version,
`row_neighbor_extract_plain`: the XLA extraction branch of the
reference's neighbor_matrix_rows, K argmin passes over the (R, 9R)
candidate blocks. Both order a slot's neighbors by (r2, candidate lane),
which is argmin's first-index rule, and compute r2 with the same operations
in the same order (no fused multiply-add), so ids, order and counts agree
bit for bit. `chunk_visit` is the kernel's chunk test, operation for
operation, so the CPU tests can hold the plain version to no hit in any
chunk that the kernel skips. A CUDA tensor never takes the plain version:
a failed build or launch raises.

With a per-slot search-radius plane (`radii`, the polydisperse broad phase)
the pair cutoff is s_own + s_cand, tested as r2 < (s_own + s_cand)^2 in the
working dtype by both versions; the kernel stages the plane beside the
positions (a compile-time variant), and its launches count in
`.radius_launches`.
"""

from __future__ import annotations

import ctypes

import torch

from mundy_tpu_torch.ops.kernels import _build

_DTYPES = {torch.float32: "f32", torch.float64: "f64"}
K_MAX = 512  # the kernel's largest top-K list (csrc/row_extract.cu)
_SMEM_DEFAULT = 48 * 1024  # shared memory a block gets without the opt-in


CHUNK = 8  # packed candidates per chunk of the kernel's x window
OWN_GROUP = 4  # own slots per warp, tested together against each chunk


def shared_bytes(R: int, itemsize: int, radii: bool = False) -> int:
    """Dynamic shared memory of one block (csrc/row_extract.cu): the packed
    positions (and search radii in the radius variant) and 16-bit slot
    indices of the 9 candidate rows, each chunk's float x bounds (and
    greatest |search radius|), the 9 counts and the 9 row indices."""
    nc = -(-R // CHUNK)
    return (9 * R * ((4 if radii else 3) * itemsize + 2)
            + 9 * nc * (3 if radii else 2) * 4 + 18 * 4)


def fits(R: int, K: int, itemsize: int, device, radii: bool = False) -> bool:
    """True when the kernel can launch at row capacity R with K neighbors
    per slot on the CUDA `device`: K <= K_MAX, and shared_bytes(R,
    itemsize, radii) within the card's opt-in shared memory per block
    (asked of the card only past the 48 KB every block gets)."""
    if K > K_MAX:
        return False
    smem = shared_bytes(R, itemsize, radii)
    return smem <= _SMEM_DEFAULT or (
        smem <= torch.cuda.get_device_properties(device).shared_memory_per_block_optin)


def _check(pos, gid, valid, box, max_neighbors, radii=None) -> None:
    if pos.ndim != 4 or pos.shape[-1] != 3:
        raise ValueError(f"pos must be (ny, nz, R, 3), got {tuple(pos.shape)}")
    if pos.dtype not in _DTYPES:
        raise TypeError(f"pos must be float32 or float64, got {pos.dtype}")
    if gid.shape != pos.shape[:3] or valid.shape != pos.shape[:3]:
        raise ValueError("gid and valid must be (ny, nz, R)")
    if len(box) != 2 or len(box[0]) != 3 or len(box[1]) != 3:
        raise ValueError("box must be ((lx, ly, lz), (px, py, pz))")
    if max_neighbors < 1:
        raise ValueError("max_neighbors must be positive")
    if radii is not None and (radii.shape != pos.shape[:3] or radii.dtype != pos.dtype):
        raise ValueError(f"radii must be a {tuple(pos.shape[:3])} plane in pos's dtype")


def chunk_visit(lo: torch.Tensor, hi: torch.Tensor, ox_lo: torch.Tensor,
                ox_hi: torch.Tensor, cut2, lx: float) -> torch.Tensor:
    """The kernel's chunk test, operation for operation in ox_lo's dtype:
    True where a chunk whose candidates have x in [lo, hi] (lo > hi when it
    is empty) can hold a pair within cut2 of an own slot with x in [ox_lo,
    ox_hi], the interval of one warp's own slots (OWN_GROUP of them). The x
    separation is taken as the pair arithmetic takes it, RN(d - RN(lx k))
    with d = RN(x - ox) and k = rint(RN(d / lx)), monotonic in x and ox for
    one image k; a chunk it rejects holds no hit of the plain version (the
    proof is in csrc/row_extract.cu). In the radius variant cut2 is
    `chunk_cut2`. Inputs are finite."""
    da = lo - ox_hi
    db = hi - ox_lo
    ka = torch.round(da * (1.0 / lx))
    kb = torch.round(db * (1.0 / lx))
    sa = da - lx * ka
    sb = db - lx * kb
    zero = torch.zeros_like(sa)
    one = torch.maximum(sa, torch.maximum(-sb, zero))
    flip = torch.minimum(torch.maximum(sa, zero), torch.maximum(-sb, zero))
    m = torch.where(ka == kb, one, torch.where(kb == ka + 1, flip, zero))
    return (lo <= hi) & (m * m < cut2)


def chunk_cut2(s_own: torch.Tensor, s_max: torch.Tensor) -> torch.Tensor:
    """The radius variant's cut for a chunk, RN(C^2) with C = RN(s_own +
    s_max): s_own >= the |search radius| of each of the warp's own slots,
    s_max >= that of every candidate in the chunk. It is at least every
    such pair's RN((s_own + s_cand)^2)."""
    c = s_own + s_max
    return c * c


def _pair_hits(cx, cy_, cz, cgid, ox, oy, oz, gid_f, lx, px, cut2, radii, csr):
    """(r2, hit) of every own slot (..., R) against its 9R candidates, with
    the plain version's operations: r2 = (dx^2 + dy^2) + dz^2, the minimum
    image on x when periodic, hit = r2 < cut2 (or (s_own + s_cand)^2) with
    a different gid."""
    DX = cx[..., None, :] - ox[..., :, None]
    if px:
        DX = DX - lx * torch.round(DX * (1.0 / lx))
    DY = cy_[..., None, :] - oy[..., :, None]
    DZ = cz[..., None, :] - oz[..., :, None]
    r2 = DX * DX + DY * DY + DZ * DZ
    del DX, DY, DZ
    if radii is None:
        pair_cut2 = cut2
    else:
        cut = radii[..., :, None] + csr[..., None, :]
        pair_cut2 = cut * cut
    return r2, (r2 < pair_cut2) & (cgid[..., None, :] != gid_f[..., :, None])


def row_neighbor_extract_plain(pos: torch.Tensor, gid: torch.Tensor,
                               valid: torch.Tensor, box, cutoff: float,
                               max_neighbors: int, n: int,
                               hbm_budget_bytes: float = 2.5e9, radii=None):
    """Plain PyTorch version of K2 (any device).

    pos/gid/valid: (ny, nz, R) row layout from build_rows, whose invalid
    slots hold its sentinel (no candidate mask is read here; the kernel
    packs the valid slots, which is the same); box: ((lx, ly, lz), (px,
    py, pz)); radii: an optional (ny, nz, R) search-radius plane (zero on
    invalid slots) whose per-pair sum replaces `cutoff`. Returns (ids (ny,
    nz, R, K) int32 neighbor gids in (r2, lane) order padded with n, count
    (ny, nz, R) int32 in-cutoff hits, zero on invalid slots). The (R, 9R)
    blocks run in y-slabs whose ~4 live blocks stay within
    `hbm_budget_bytes`."""
    from mundy_tpu_torch.neighbor.rows import _candidate_planes

    _check(pos, gid, valid, box, max_neighbors, radii)
    ny, nz, R, _ = pos.shape
    k_out = max_neighbors
    dtype, dev = pos.dtype, pos.device
    lengths, flags = box
    gid_f = gid.to(dtype)  # gid rides the plane machinery as a float
    fields = (gid_f,) if radii is None else (gid_f, radii)
    cx, cy_, cz, (cgid, *csr) = _candidate_planes(pos, box, fields)
    ox, oy, oz = pos[..., 0], pos[..., 1], pos[..., 2]
    lx, px = lengths[0], flags[0]
    cut2 = torch.tensor(cutoff * cutoff, dtype=dtype, device=dev)

    def extract(sl):
        r2, hit = _pair_hits(cx[sl], cy_[sl], cz[sl], cgid[sl], ox[sl], oy[sl], oz[sl],
                             gid_f[sl], lx, px, cut2,
                             None if radii is None else radii[sl],
                             None if radii is None else csr[0][sl])
        count = hit.sum(-1, dtype=torch.int32)
        r2m = torch.where(hit, r2, torch.inf)
        del r2, hit
        ovc = valid[sl]
        cg = cgid[sl][..., None, :].expand(r2m.shape)
        ids = []
        for _ in range(k_out):
            amin = torch.argmin(r2m, dim=-1, keepdim=True)
            v = torch.gather(r2m, -1, amin)[..., 0]
            g = torch.gather(cg, -1, amin)[..., 0]
            ids.append(torch.where(torch.isfinite(v) & ovc, g.to(torch.int32), n))
            r2m.scatter_(-1, amin, torch.inf)
        return torch.stack(ids, dim=-1), torch.where(ovc, count, 0)

    bytes_per_row = 4 * nz * R * 9 * R * pos.element_size()
    chunk_y = int(hbm_budget_bytes // max(bytes_per_row, 1))
    if chunk_y < 1:
        raise ValueError(
            f"neighbor_matrix_rows: one y-plane of the extraction graph needs "
            f"{bytes_per_row / 1e9:.1f} GB (> budget {hbm_budget_bytes / 1e9:.1f} "
            f"GB) at R={R}, nz={nz}; the distribution is too clustered for the "
            "row layout; use the cell-list builder (neighbor_matrix)")
    parts = [extract(slice(y0, y0 + chunk_y)) for y0 in range(0, ny, chunk_y)]
    return (torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts]))


def _launch(pos, gid, valid, box, cutoff, max_neighbors, n, radii):
    lib = _build.load("row_extract")
    variant = "" if radii is None else "radii_"
    fn = getattr(lib, f"row_neighbor_extract_{variant}{_DTYPES[pos.dtype]}")
    n_ptr = 5 if radii is None else 6
    fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 5
                   + [ctypes.c_double] * 4 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    ny, nz, R, _ = pos.shape
    ids = torch.empty((ny, nz, R, max_neighbors), dtype=torch.int32, device=pos.device)
    count = torch.empty((ny, nz, R), dtype=torch.int32, device=pos.device)
    planes = (pos, gid, valid) if radii is None else (pos, gid, valid, radii)
    (lx, ly, lz), _flags = box
    with torch.cuda.device(pos.device):
        stream = torch.cuda.current_stream(pos.device).cuda_stream
        err = fn(*(t.data_ptr() for t in planes), ids.data_ptr(), count.data_ptr(),
                 ny, nz, R, max_neighbors, n, float(lx), float(ly), float(lz),
                 float(cutoff) * float(cutoff), stream)
    if err != 0:
        raise RuntimeError(f"row_extract kernel launch failed: CUDA error {err}")
    return ids, count


def row_neighbor_extract(pos: torch.Tensor, gid: torch.Tensor, valid: torch.Tensor,
                         box, cutoff: float, max_neighbors: int, n: int,
                         hbm_budget_bytes: float = 2.5e9, radii=None):
    """K nearest in-cutoff neighbor gids per row slot, plus hit counts.

    Arguments and results as row_neighbor_extract_plain. A CPU tensor
    computes the plain version. A CUDA tensor launches the kernel (counted
    in `.launches`, or in `.radius_launches` with a radius plane); it must
    be contiguous, with int32 gid, bool valid, all three axes periodic,
    ny, nz >= 5 and a shape that `fits`, or the wrapper raises."""
    _check(pos, gid, valid, box, max_neighbors, radii)
    if pos.device.type == "cpu":
        return row_neighbor_extract_plain(pos, gid, valid, box, cutoff,
                                          max_neighbors, n, hbm_budget_bytes, radii)
    if pos.device.type != "cuda":
        raise ValueError(f"no K2 kernel for device {pos.device}")
    if not all(box[1]):
        raise NotImplementedError("K2 needs all three axes periodic")
    if pos.shape[0] < 5 or pos.shape[1] < 5:
        raise ValueError("K2 needs ny, nz >= 5")
    R, itemsize = pos.shape[2], pos.element_size()
    if not fits(R, max_neighbors, itemsize, pos.device, radii is not None):
        raise ValueError(
            f"K2 cannot launch at R = {R}, K = {max_neighbors}: it keeps at most "
            f"{K_MAX} neighbors and stages "
            f"{shared_bytes(R, itemsize, radii is not None)} bytes of shared memory, "
            "which must lie within the card's opt-in")
    if gid.dtype != torch.int32 or valid.dtype != torch.bool:
        raise TypeError("gid must be int32 and valid bool")
    planes = (pos, gid, valid) if radii is None else (pos, gid, valid, radii)
    if not all(t.is_contiguous() for t in planes):
        raise ValueError("pos, gid, valid and radii must be contiguous")
    out = _launch(pos, gid, valid, box, cutoff, max_neighbors, n, radii)
    if radii is None:
        row_neighbor_extract.launches += 1
    else:
        row_neighbor_extract.radius_launches += 1
    return out


row_neighbor_extract.launches = 0
row_neighbor_extract.radius_launches = 0
