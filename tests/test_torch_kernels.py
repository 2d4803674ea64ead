"""The CUDA kernels of the torch port vs their plain PyTorch versions.

These need an NVIDIA GPU with nvcc and skip without one. The file imports
no JAX, so it runs on a machine with the card alone:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py

Bounds for K1: float32 within 2e-5 max(max|f|, 1), the bound of
tests/test_pallas_row_central.py (rsqrt approximations and summation
order); float64 within 1e-12 max(max|f|, 1) (summation order only). K2 and
K3 compute what their plain versions compute in the same order, so they
are held to bit equality. K4 rounds every pair quantity as its plain
version does (no FMA contraction) and sums in another order: float32
within 1e-5 of max|force| and of max|torque| (the rods op) or of max|f| of
each node (the filaments op), float64 within 1e-12 of each. K5s and K5i
round each window product as their plain versions do and sum in another
order: float32 within 1e-5, float64 within 1e-12 of max|grid| and max|u|,
at P = 6 and at the free-space path's P = 10, m = 12 with slots below 0.
K3t sums, gathers and dots in its plain version's order: bit-equal. K6
(with a radius plane, or the constant plane it builds without one) sums in
another order than its plain version, with rsqrt approximations in
float32: float32 within 5e-5 of max|f|, the bound of
tests/test_pallas_row_hertz.py, float64 within 1e-12. K2's radius variant
tests the plain version's per-pair cutoff in its order: bit-equal.
"""

import numpy as np
import pytest
import torch

from mundy_tpu_torch.neighbor import rows as tr
from mundy_tpu_torch.ops.kernels import row_central as k1
from mundy_tpu_torch.ops.kernels import row_extract as k2
from mundy_tpu_torch.ops.kernels import row_hertz as k6
from mundy_tpu_torch.ops.kernels import row_segments as k4
from mundy_tpu_torch.ops.kernels import se_grid as k5
from mundy_tpu_torch.ops.kernels import seg_onehot as k3

_DT = {"float32": torch.float32, "float64": torch.float64}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("n,box,cutoff,align", [(4000, 12.0, 1.4, 8),
                                                 (3000, 13.0, 1.4, 1),
                                                 (80000, 40.0, 1.4, 8)])
def test_k1_kernel_matches_plain(cuda_device, dtype, n, box, cutoff, align):
    """align=1 gives nz = 9, which the TPU kernel refused; n=80000 gives
    R = 288: rows longer than one 256-thread pass, and in float64 more
    than 48 KB of shared memory."""
    td = _DT[dtype]
    rng = np.random.default_rng(11)
    grid = tr.make_row_grid([0, 0, 0], [box] * 3, cutoff, n, dtype=td,
                            align=align, device=cuda_device)
    ts = tr.build_rows(torch.as_tensor(rng.uniform(0, box, (n, 3)), dtype=td,
                                       device=cuda_device),
                       torch.arange(n, dtype=torch.int32, device=cuda_device),
                       grid)
    before = k1.row_hertzian_forces_sym.launches
    got = k1.row_hertzian_forces_sym(ts.pos, (box,) * 3, 0.5, 1000.0, 0.3)
    torch.cuda.synchronize()
    assert k1.row_hertzian_forces_sym.launches == before + 1
    ref = k1.row_hertzian_forces_plain(ts.pos, (box,) * 3, 0.5, 1000.0, 0.3)
    m = ts.valid
    assert bool(torch.isfinite(got).all())
    err = (got[m] - ref[m]).abs().max().item()
    fmax = ref[m].abs().max().item()
    assert fmax > 0
    assert err <= (1e-12 if dtype == "float64" else 2e-5) * max(fmax, 1.0)


def _k1_digest(dtype, n, box, cutoff, align, dev):
    """sha256 (first 16 hex digits) of K1's output bytes, every slot, on
    test_k1_kernel_matches_plain's inputs."""
    import hashlib

    ts = _rows(n, box, cutoff, align, _DT[dtype], dev)
    got = k1.row_hertzian_forces_sym(ts.pos, (box,) * 3, 0.5, 1000.0, 0.3, valid=ts.valid)
    no_mask = k1.row_hertzian_forces_sym(ts.pos, (box,) * 3, 0.5, 1000.0, 0.3)
    assert torch.equal(got, no_mask)  # the reference's signature, every slot occupied
    return hashlib.sha256(got.cpu().numpy().tobytes()).hexdigest()[:16]


# _k1_digest from K1's first design, which summed every one of the 9 R
# candidates of every slot (NVIDIA H100 80GB HBM3)
_K1_SHA = {
    ("float32", 4000): "e861999d92032719", ("float32", 3000): "be044a99534f04b6",
    ("float32", 80000): "c09bff87aaf0730d", ("float64", 4000): "15984f9ba777b605",
    ("float64", 3000): "bce1caaf3b3830e6", ("float64", 80000): "84835b2365211d89",
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("n,box,cutoff,align", [(4000, 12.0, 1.4, 8),
                                                 (3000, 13.0, 1.4, 1),
                                                 (80000, 40.0, 1.4, 8)])
def test_k1_outputs_unchanged(cuda_device, dtype, n, box, cutoff, align):
    """K1 leaves out padded slots, chunks out of reach in x and pairs out of
    contact, whose terms are exact zeros, and keeps the full scan's order:
    its outputs, padded slots included, stay bit for bit the full scan's."""
    assert _k1_digest(dtype, n, box, cutoff, align, cuda_device) == _K1_SHA[(dtype, n)]


def _check_k1(pos, valid, box, dtype):
    """K1 with the mask against its plain version (the bounds of
    test_k1_kernel_matches_plain) and against itself without the mask and on
    a second launch, bit for bit."""
    args = ((box,) * 3, 0.5, 1000.0, 0.3)
    before = k1.row_hertzian_forces_sym.launches
    got = k1.row_hertzian_forces_sym(pos, *args, valid=valid)
    again = k1.row_hertzian_forces_sym(pos, *args, valid=valid)
    no_mask = k1.row_hertzian_forces_sym(pos, *args)
    torch.cuda.synchronize()
    assert k1.row_hertzian_forces_sym.launches == before + 3
    assert torch.equal(got, again) and torch.equal(got, no_mask)
    ref = k1.row_hertzian_forces_plain(pos, *args)
    assert bool(torch.isfinite(got).all())
    assert bool((got[~valid] == 0).all())
    fmax = ref[valid].abs().max().item()
    assert fmax > 0
    err = (got[valid] - ref[valid]).abs().max().item()
    assert err <= (1e-12 if dtype == "float64" else 2e-5) * max(fmax, 1.0)
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("n,box", [(4000, 12.0), (80000, 40.0)])
def test_k1_rows_moved_since_the_rebuild(cuda_device, dtype, n, box):
    """Spheres moved along x after build_rows (up to 1.2 contact distances,
    wrapped into the box) and the slots of every row permuted (holes before
    occupied slots): the rows are no longer sorted in x, and the x window
    bounds each chunk by its current positions. n = 80000 fills rows of R =
    288 with ~140 spheres, several warps of own slots per row."""
    td = _DT[dtype]
    ts = _rows(n, box, 1.4, 8, td, cuda_device)
    rng = np.random.default_rng(37)
    shift = torch.as_tensor(rng.uniform(-1.2, 1.2, ts.valid.shape), dtype=td,
                            device=cuda_device)
    pos = ts.pos.clone()
    pos[..., 0] = torch.where(ts.valid, torch.remainder(pos[..., 0] + shift, box), pos[..., 0])
    perm = torch.as_tensor(rng.permutation(pos.shape[2]), device=cuda_device)
    pos, valid = pos[:, :, perm].contiguous(), ts.valid[:, :, perm].contiguous()
    x = torch.where(valid, pos[..., 0], float("nan"))
    assert bool((x[..., 1:] < x[..., :-1]).any())  # no longer sorted
    assert bool((~valid[..., :-1] & valid[..., 1:]).any())  # a hole before a sphere
    if n == 80000:
        assert int(valid.sum(-1).max()) > 128
    _check_k1(pos, valid, box, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_k1_contact_margin_and_x_wrap(cuda_device, dtype):
    """Pairs along x just inside contact (2r = 1), just inside the early
    stop's margin and just outside it, the same across the x wrap, and a
    coincident pair, among random spheres: the kernel matches the plain
    version and pushes exactly the pairs in contact."""
    n, box, td = 1500, 12.0, _DT[dtype]
    rng = np.random.default_rng(43)
    pos = rng.uniform(0, box, (4 * n, 3))
    d = np.abs(pos[:, 1] - pos[:, 2])
    pos = pos[np.minimum(d, box - d) > 1.5][:n]  # no random sphere reaches y = z
    placed = [(2.0, 2.0 + (1 - 1e-3), 1.0, True),
              (2.0, 2.0 + (1 + 2e-4), 2.5, False),
              (2.0, 2.0 + (1 + 2e-3), 4.0, False),
              (0.05, 0.05 - (1 - 1e-3) + box, 5.5, True),
              (0.05, 0.05 - (1 + 2e-4) + box, 7.0, False),
              (0.05, 0.05 - (1 + 2e-3) + box, 8.5, False),
              (9.0, 9.0, 10.0, False)]  # coincident
    for i, (xo, xc, yz, _) in enumerate(placed):
        pos[2 * i], pos[2 * i + 1] = [xo, yz, yz], [xc, yz, yz]
    grid = tr.make_row_grid([0, 0, 0], [box] * 3, 1.4, n, dtype=td, align=8,
                            device=cuda_device)
    ts = tr.build_rows(torch.as_tensor(pos, dtype=td, device=cuda_device),
                       torch.arange(n, dtype=torch.int32, device=cuda_device), grid)
    force = _check_k1(ts.pos, ts.valid, box, dtype)
    flat = tr.rows_to_flat(ts.replace(pos=force), n)
    for i, (_, _, _, touch) in enumerate(placed):
        assert bool(flat[2 * i].abs().max() > 0) == touch
        assert bool(flat[2 * i + 1].abs().max() > 0) == touch


@pytest.mark.cuda
def test_k1_past_shared_memory_raises(cuda_device):
    """float64 at R = 800 needs (36 R + 18 ceil(R / 32)) 8 + 4 R = 237,200
    bytes of shared memory, past the H100's 232,448-byte opt-in (the largest
    float64 row is R = 783): the launch fails and the wrapper raises, with
    no plain fallback and no launch counted; float32 at the same R launches
    and matches the plain version."""
    ts = _rows(4000, 12.0, 1.4, 8, torch.float64, cuda_device)
    R = 800
    pad = R - ts.pos.shape[2]
    optin = torch.cuda.get_device_properties(cuda_device).shared_memory_per_block_optin

    def smem(R, itemsize):
        return (36 * R + 18 * -(-R // 32)) * itemsize + 4 * R

    assert smem(R, 8) > optin >= smem(783, 8)
    assert smem(R, 4) <= optin

    def widen(t, fill):
        return torch.cat([t, t.new_full(t.shape[:2] + (pad,) + t.shape[3:], fill)],
                         dim=2).contiguous()

    pos, valid = widen(ts.pos, -1e6), widen(ts.valid, False)
    before = k1.row_hertzian_forces_sym.launches
    with pytest.raises(RuntimeError, match="CUDA error"):
        k1.row_hertzian_forces_sym(pos, (12.0,) * 3, 0.5, 1000.0, 0.3, valid=valid)
    assert k1.row_hertzian_forces_sym.launches == before
    _check_k1(pos.float(), valid, 12.0, "float32")


def _rows(n, box, cutoff, align, td, dev, seed=11):
    rng = np.random.default_rng(seed)
    grid = tr.make_row_grid([0, 0, 0], [box] * 3, cutoff, n, dtype=td,
                            align=align, device=dev)
    return tr.build_rows(torch.as_tensor(rng.uniform(0, box, (n, 3)), dtype=td,
                                         device=dev),
                         torch.arange(n, dtype=torch.int32, device=dev), grid)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("n,box,align,K", [(6000, 14.5, 8, 20),
                                           (4000, 13.05, 1, 12),
                                           (80000, 40.0, 8, 24),
                                           (3000, 13.0, 8, k2.K_MAX)])
def test_k2_kernel_matches_plain(cuda_device, dtype, n, box, align, K):
    """K2 ids, order and counts are bit-equal to the plain version. align=1
    gives nz = 9 (not a multiple of 8); n = 80000 gives R > 256, rows longer
    than one thread pass; K = K_MAX is the regrow ceiling."""
    ts = _rows(n, box, 1.45, align, _DT[dtype], cuda_device)
    args = (ts.pos, ts.gid, ts.valid, ((box,) * 3, (True,) * 3), 1.45, K, n)
    if n == 80000:
        assert ts.pos.shape[2] > 256
    if align == 1:
        assert ts.pos.shape[1] % 8 != 0
    before = k2.row_neighbor_extract.launches
    ids, cnt = k2.row_neighbor_extract(*args)
    torch.cuda.synchronize()
    assert k2.row_neighbor_extract.launches == before + 1
    ids_p, cnt_p = k2.row_neighbor_extract_plain(*args)
    assert int(cnt_p.max()) > 0
    assert torch.equal(cnt, cnt_p)
    assert torch.equal(ids, ids_p)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("nb,W,B,sort", [(7, 640, 1024, True),
                                         (5, 2600, 1024, False),
                                         (3, 300, 200, False)])
def test_k3_kernel_matches_plain(cuda_device, dtype, nb, W, B, sort):
    """K3 sums each segment in slot order, as the plain version does, so the
    two are bit-equal. W = 2600 spans more than one shared-memory tile; the
    unsorted cases scatter ids over [-B/4, 5B/4), some outside [0, B)."""
    rng = np.random.default_rng(5)
    loc = rng.integers(-B // 4, B + B // 4, (nb, W))
    if sort:
        loc = np.sort(loc, axis=1)
    values = torch.as_tensor(rng.normal(size=(nb, 3, W)), dtype=_DT[dtype],
                             device=cuda_device)
    loc = torch.as_tensor(loc, dtype=torch.int32, device=cuda_device)
    before = k3.strided_onehot_segment_sum.launches
    got = k3.strided_onehot_segment_sum(values, loc, B)
    torch.cuda.synchronize()
    assert k3.strided_onehot_segment_sum.launches == before + 1
    ref = k3.strided_segment_sum_plain(values, loc, B)
    assert got.shape == (nb, 3, B)
    assert torch.equal(got, ref)


@pytest.mark.cuda
def test_k2_refuses_cpu_only_branches(cuda_device):
    """Non-periodic axes run only in the plain version, and K3 takes int32
    ids only: on a CUDA tensor the wrappers raise instead."""
    ts = _rows(4000, 13.0, 1.45, 8, torch.float32, cuda_device)
    box = ((13.0,) * 3, (True,) * 3)
    before = k2.row_neighbor_extract.launches
    with pytest.raises(NotImplementedError, match="periodic"):
        k2.row_neighbor_extract(ts.pos, ts.gid, ts.valid, ((13.0,) * 3, (True, False, True)),
                                1.45, 12, 4000)
    with pytest.raises(TypeError, match="int32"):
        k3.strided_onehot_segment_sum(torch.zeros((2, 3, 8), device=cuda_device),
                                      torch.zeros((2, 8), dtype=torch.int64,
                                                  device=cuda_device), 16)
    assert k2.row_neighbor_extract.launches == before


def _random_rods(n, box, seed):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0, box, (n, 3))
    axes = rng.normal(size=(n, 3))
    axes /= np.linalg.norm(axes, axis=1, keepdims=True)
    return pos, axes, rng


def _rods_rows(pos, axes, box, td, dev, align=8):
    """Rows of rods of half-length 0.4 (cutoff 1.6) and their half-edges."""
    n = pos.shape[0]
    grid = tr.make_row_grid([0, 0, 0], [box] * 3, 1.6, n, dtype=td, align=align, device=dev)
    ts = tr.build_rows(torch.as_tensor(pos, dtype=td, device=dev),
                       torch.arange(n, dtype=torch.int32, device=dev), grid)
    gid = ts.gid.long().clamp(max=n - 1)
    hedges = torch.where(ts.valid[..., None],
                         0.4 * torch.as_tensor(axes, dtype=td, device=dev)[gid], 0.0)
    return ts, hedges.contiguous()


def _check_rods(mid, hedges, valid, box, dtype):
    """The rods kernel against its plain version (float32 within 1e-5,
    float64 within 1e-12 of max|force| and of max|torque|), and a second
    launch bit-equal to the first."""
    args = ((box,) * 3, 0.2, 109.89)
    before = k4.row_segment_pairs_sym.launches
    got = k4.row_segment_pairs_sym(mid, hedges, valid, *args)
    again = k4.row_segment_pairs_sym(mid, hedges, valid, *args)
    torch.cuda.synchronize()
    assert k4.row_segment_pairs_sym.launches == before + 2
    ref = k4.row_segment_pairs_plain(mid, hedges, *args)
    for g, a, r in zip(got, again, ref):
        assert torch.equal(g, a)
        assert bool(torch.isfinite(g).all())
        scale = r.abs().max().item()
        assert scale > 0
        assert (g - r).abs().max().item() <= (1e-12 if dtype == "float64" else 1e-5) * scale
    return got


def _matches_plain_rows(n, box, align, td, dev):
    """test_k4_kernel_matches_plain's rods: rods 0 and 1 coincide."""
    pos, axes, _ = _random_rods(n, box, 13)
    pos[1], axes[1] = pos[0], axes[0]
    return _rods_rows(pos, axes, box, td, dev, align=align)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("n,box,align", [(600, 12.8, 8), (1500, 14.5, 1),
                                         (4000, 8.5, 8)])
def test_k4_kernel_matches_plain(cuda_device, dtype, n, box, align):
    """Rods force and torque, every slot (invalid ones included), and a
    repeat bit-equal. align=1 gives nz = 9; n = 4000 in a 5 x 5 row grid
    gives R = 312: rows longer than 256 threads, and more than 48 KB of
    shared memory in both dtypes. Rods 0 and 1 coincide (one midpoint, one
    axis)."""
    ts, hedges = _matches_plain_rows(n, box, align, _DT[dtype], cuda_device)
    if align == 1:
        assert ts.pos.shape[1] == 9
    if n == 4000:
        assert ts.pos.shape[2] > 256
    _check_rods(ts.pos, hedges, ts.valid, box, dtype)


@pytest.mark.cuda
def test_k4_rows_with_holes(cuda_device):
    """With the slots of every row permuted (holes before valid slots) the
    kernel still matches the plain version on the same layout, float64
    within 1e-12 of max|out|."""
    n, box = 600, 12.8
    pos, axes, rng = _random_rods(n, box, 17)
    ts, hedges = _rods_rows(pos, axes, box, torch.float64, cuda_device)
    perm = torch.as_tensor(rng.permutation(ts.pos.shape[2]), device=cuda_device)
    valid = ts.valid[:, :, perm].contiguous()
    assert bool((~valid[..., :-1] & valid[..., 1:]).any())  # a hole before a rod
    _check_rods(ts.pos[:, :, perm].contiguous(), hedges[:, :, perm].contiguous(), valid, box,
                "float64")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("n,box", [(600, 12.8), (4000, 20.0)])
def test_k4_rods_rows_moved_since_the_rebuild(cuda_device, dtype, n, box):
    """Rods moved along x after build_rows (up to 2.5 reaches, wrapped into
    the box), so the rows are no longer sorted in x and some chunks span the
    box: the x window bounds each chunk by its current positions and still
    matches the plain version."""
    td = _DT[dtype]
    pos, axes, rng = _random_rods(n, box, 29)
    ts, hedges = _rods_rows(pos, axes, box, td, cuda_device)
    shift = torch.as_tensor(rng.uniform(-3.0, 3.0, ts.valid.shape), dtype=td,
                            device=cuda_device)
    mid = ts.pos.clone()
    mid[..., 0] = torch.where(ts.valid, torch.remainder(mid[..., 0] + shift, box), mid[..., 0])
    x = torch.where(ts.valid, mid[..., 0], float("nan"))
    assert bool((x[..., 1:] < x[..., :-1]).any())  # no longer sorted
    _check_rods(mid.contiguous(), hedges, ts.valid, box, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_k4_rods_reach_margin_and_x_wrap(cuda_device, dtype):
    """Collinear pairs (reach 2 |e| + 2r = 1.2) just inside contact, just
    inside the reach margin and just outside it, the same across the x
    wrap, and a coincident pair, among random rods: the kernel matches the
    plain version and pushes exactly the pairs in contact."""
    n, box, td = 600, 12.8, _DT[dtype]
    rng = np.random.default_rng(23)
    pos = rng.uniform(0, box, (4 * n, 3))
    d = np.abs(pos[:, 1] - pos[:, 2])
    pos = pos[np.minimum(d, box - d) > 2.5][:n]  # no random rod reaches y = z
    axes = rng.normal(size=(n, 3))
    axes /= np.linalg.norm(axes, axis=1, keepdims=True)
    reach = 1.2
    placed = [(2.0, 2.0 + reach * (1 - 1e-3), 1.0, True),
              (2.0, 2.0 + reach * (1 + 2e-4), 2.6, False),
              (2.0, 2.0 + reach * (1 + 2e-3), 4.2, False),
              (0.05, 0.05 - reach * (1 - 1e-3) + box, 5.8, True),
              (0.05, 0.05 - reach * (1 + 2e-4) + box, 7.4, False),
              (0.05, 0.05 - reach * (1 + 2e-3) + box, 9.0, False),
              (9.0, 9.0, 10.6, False)]  # coincident
    for i, (xo, xc, yz, _) in enumerate(placed):
        pos[2 * i], pos[2 * i + 1] = [xo, yz, yz], [xc, yz, yz]
        axes[2 * i] = axes[2 * i + 1] = [1.0, 0.0, 0.0]
    ts, hedges = _rods_rows(pos, axes, box, td, cuda_device)
    force, _ = _check_rods(ts.pos, hedges, ts.valid, box, dtype)
    flat = tr.rows_to_flat(ts.replace(pos=force), n)
    for i, (_, _, _, touch) in enumerate(placed):
        assert bool((flat[2 * i].abs().max() > 0)) == touch
        assert bool((flat[2 * i + 1].abs().max() > 0)) == touch


def _rods_smem(R, itemsize):
    """The rods kernel's shared memory per block (rods_smem of
    csrc/row_segments.cu): seven planes of 9 R slots, three per chunk of
    32, each warp's 32 drained outputs and 64-entry ring, one byte per own
    slot."""
    nc = -(-R // 32)
    nw = min(nc, 16)
    return (63 * R + 27 * nc + 192 * nw) * itemsize + 512 * nw + R


@pytest.mark.cuda
def test_k4_rods_past_shared_memory_raises(cuda_device):
    """float64 at R = 416 needs 239,512 bytes of shared memory, past the
    H100's 232,448-byte opt-in (the largest float64 row is R = 402): the
    launch fails and the wrapper raises, with no plain fallback and no
    launch counted; float32 at the same R launches and matches the plain
    version."""
    n, box = 600, 12.8
    pos, axes, _ = _random_rods(n, box, 31)
    ts, hedges = _rods_rows(pos, axes, box, torch.float64, cuda_device)
    R = 416
    pad = R - ts.pos.shape[2]
    optin = torch.cuda.get_device_properties(cuda_device).shared_memory_per_block_optin
    assert _rods_smem(R, 8) > optin >= _rods_smem(402, 8)
    assert _rods_smem(R, 4) <= optin

    def widen(t, fill):
        return torch.cat([t, t.new_full(t.shape[:2] + (pad,) + t.shape[3:], fill)],
                         dim=2).contiguous()

    mid, he, valid = widen(ts.pos, -1e6), widen(hedges, 0.0), widen(ts.valid, False)
    before = k4.row_segment_pairs_sym.launches
    with pytest.raises(RuntimeError, match="CUDA error"):
        k4.row_segment_pairs_sym(mid, he, valid, (box,) * 3, 0.2, 109.89)
    assert k4.row_segment_pairs_sym.launches == before
    _check_rods(mid.float(), he.float(), valid, box, "float32")


# sha256 (first 16 hex digits) of the rods op's force then torque bytes on
# test_k4_kernel_matches_plain's inputs, from the full-scan rods kernel as
# built before the filaments op joined its source (NVIDIA H100 80GB HBM3)
_RODS_SHA = {
    ("float32", 600): "bbe0c18a1ff39a11", ("float32", 1500): "07339bbab57b29e4",
    ("float32", 4000): "be679653b566ad0b", ("float64", 600): "fa29f8dfb359b71b",
    ("float64", 1500): "99f9b2dded6cb7e0", ("float64", 4000): "a1f43ce1c5693484",
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("n,box,align", [(600, 12.8, 8), (1500, 14.5, 1),
                                         (4000, 8.5, 8)])
def test_k4_rods_op_outputs_unchanged(cuda_device, dtype, n, box, align):
    """The rods kernel leaves out only pairs out of reach, whose terms are
    exact zeros, and keeps the full scan's order: its outputs stay bit for
    bit the full scan's."""
    import hashlib

    ts, hedges = _matches_plain_rows(n, box, align, _DT[dtype], cuda_device)
    out = k4.row_segment_pairs_sym(ts.pos, hedges, ts.valid, (box,) * 3, 0.2, 109.89)
    digest = hashlib.sha256(b"".join(t.contiguous().cpu().numpy().tobytes()
                                     for t in out)).hexdigest()[:16]
    assert digest == _RODS_SHA[(dtype, n)]


def _filament_rows(F, M, box, td, dev, seed=19, cutoff=1.8, align=8):
    """Rows of F random chains of M nodes (unit edges): midpoints,
    half-edges and gids g = f (M - 1) + k in build_rows' layout."""
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(F, 1, 3)) + 0.3 * rng.normal(size=(F, M - 1, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    start = rng.uniform(0, box, (F, 1, 3))
    pos = np.concatenate([start, start + np.cumsum(d, axis=1)], axis=1)
    a, b = pos[:, :-1].reshape(-1, 3), pos[:, 1:].reshape(-1, 3)
    mid, e = np.mod(0.5 * (a + b), box), 0.5 * (b - a)
    S = F * (M - 1)
    grid = tr.make_row_grid([0, 0, 0], [box] * 3, cutoff, S, dtype=td, align=align, device=dev)
    rows = tr.build_rows(torch.as_tensor(mid, dtype=td, device=dev),
                         torch.arange(S, dtype=torch.int32, device=dev), grid)
    gid = rows.gid.long().clamp(max=S - 1)
    he = torch.where(rows.valid[..., None], torch.as_tensor(e, dtype=td, device=dev)[gid], 0.0)
    return rows, he.contiguous()


def _filaments_digest(dtype, F, M, box, align, dev):
    """sha256 (first 16 hex digits) of the filaments op's f_start then f_end
    bytes on test_k4_filaments_kernel_matches_plain's inputs."""
    import hashlib

    rows, he = _filament_rows(F, M, box, _DT[dtype], dev, align=align)
    out = k4.row_segment_filaments_sym(rows.pos, he, rows.valid, rows.gid, (box,) * 3, 0.25,
                                       274.725, M - 1)
    return hashlib.sha256(b"".join(t.contiguous().cpu().numpy().tobytes()
                                   for t in out)).hexdigest()[:16]


# _filaments_digest from the filaments op's full scan, as built before the
# rods op took its own kernel body (NVIDIA H100 80GB HBM3)
_FIL_SHA = {
    ("float32", 60): "255f0a5e0a1b53f6", ("float32", 120): "5fe88a0aad12d308",
    ("float32", 600): "229268dc501838c8", ("float64", 60): "df30ad7fe768cacb",
    ("float64", 120): "4a47d8f3d4c25244", ("float64", 600): "88d60c882229d788",
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("F,M,box,align", [(60, 6, 9.5, 8), (120, 7, 16.5, 1),
                                           (600, 9, 9.5, 8)])
def test_k4_filaments_op_outputs_unchanged(cuda_device, dtype, F, M, box, align):
    """The filaments op leaves out only chunks and pairs out of reach, whose
    terms are exact zeros, and keeps the full scan's order: its outputs stay
    bit for bit the full scan's."""
    assert _filaments_digest(dtype, F, M, box, align, cuda_device) == _FIL_SHA[(dtype, F)]


def _check_filaments(rows_pos, he, valid, gid, box, E, dtype):
    args = ((box,) * 3, 0.25, 274.725, E)
    before = k4.row_segment_filaments_sym.launches
    got = k4.row_segment_filaments_sym(rows_pos, he, valid, gid, *args)
    again = k4.row_segment_filaments_sym(rows_pos, he, valid, gid, *args)
    torch.cuda.synchronize()
    assert k4.row_segment_filaments_sym.launches == before + 2
    ref = k4.row_segment_filaments_plain(rows_pos, he, valid, gid, *args)
    for g, a, r in zip(got, again, ref):
        assert torch.equal(g, a)
        assert bool(torch.isfinite(g).all())
        scale = r.abs().max().item()
        assert scale > 0
        assert (g - r).abs().max().item() <= (1e-12 if dtype == "float64" else 1e-5) * scale
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("F,M,box,align", [(60, 6, 9.5, 8), (120, 7, 16.5, 1),
                                           (600, 9, 9.5, 8)])
def test_k4_filaments_kernel_matches_plain(cuda_device, dtype, F, M, box, align):
    """The filaments op, every slot: align=1 gives nz = 9; F = 600 chains of
    8 segments in a 5 x 5 row grid give R = 392 > 256, rows longer than one
    256-thread pass (and past 48 KB of shared memory in both dtypes). Then
    the last segment is moved onto the first (coincident segments)."""
    td = _DT[dtype]
    rows, he = _filament_rows(F, M, box, td, cuda_device, align=align)
    if F == 600:
        assert rows.pos.shape[2] > 256
    if align == 1:
        assert rows.pos.shape[1] == 9
    _check_filaments(rows.pos, he, rows.valid, rows.gid, box, M - 1, dtype)
    # two coincident segments of different filaments
    S = F * (M - 1)
    pos, he2 = rows.pos.clone(), he.clone()
    a = (rows.gid == 0) & rows.valid
    b = (rows.gid == S - 1) & rows.valid
    if bool(a.any()) and bool(b.any()):
        pos[b], he2[b] = pos[a], he2[a]
        _check_filaments(pos, he2, rows.valid, rows.gid, box, M - 1, dtype)


@pytest.mark.cuda
def test_k4_filaments_rows_with_holes(cuda_device):
    """Slots permuted within rows (holes before valid slots): the kernel
    still matches the plain version on the same layout, float64 within
    1e-12."""
    rows, he = _filament_rows(60, 6, 9.5, torch.float64, cuda_device)
    perm = torch.as_tensor(np.random.default_rng(3).permutation(rows.pos.shape[2]),
                           device=cuda_device)
    valid = rows.valid[:, :, perm].contiguous()
    assert bool((~valid[..., :-1] & valid[..., 1:]).any())
    _check_filaments(rows.pos[:, :, perm].contiguous(), he[:, :, perm].contiguous(), valid,
                     rows.gid[:, :, perm].contiguous(), 9.5, 5, "float64")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_k4_filaments_adjacency(cuda_device, dtype):
    """Two touching segments with gids g and g + 1: no force inside one
    filament (g mod E != E - 1), a push across a filament boundary."""
    td, box, E = _DT[dtype], 12.0, 4
    mid = np.array([[6.0, 6.0, 6.0], [6.0, 6.2, 6.0]] + [[1.0 + i, 1.0, 1.0] for i in range(6)])
    grid = tr.make_row_grid([0, 0, 0], [box] * 3, 1.8, 8, dtype=td, align=1, device=cuda_device)
    for g0, interacts in ((1, False), (3, True)):
        gid = torch.tensor([g0, g0 + 1] + [10 + 2 * i for i in range(6)], dtype=torch.int32,
                           device=cuda_device)
        rows = tr.build_rows(torch.as_tensor(mid, dtype=td, device=cuda_device), gid, grid)
        he = torch.where(rows.valid[..., None],
                         torch.tensor([0.5, 0.0, 0.0], dtype=td, device=cuda_device), 0.0)
        fs, fe = k4.row_segment_filaments_sym(rows.pos, he.contiguous(), rows.valid, rows.gid,
                                              (box,) * 3, 0.25, 274.725, E)
        ref = k4.row_segment_filaments_plain(rows.pos, he, rows.valid, rows.gid, (box,) * 3,
                                             0.25, 274.725, E)
        sel = (rows.gid == g0) & rows.valid
        f = (fs[sel] + fe[sel]).reshape(3)
        assert (float(f[1]) < -1.0) if interacts else float(f.abs().max()) == 0.0
        assert torch.equal(fs == 0, ref[0] == 0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_k4_filaments_rows_moved_since_the_rebuild(cuda_device, dtype):
    """Segments moved along x after build_rows (up to 2.5 reaches, wrapped
    into the box), so the rows are no longer sorted in x and chunks span the
    box; F = 600 chains in a 5 x 5 row grid fill rows of R = 392 with up to
    ~190 segments, several warps of own slots per row."""
    td = _DT[dtype]
    rows, he = _filament_rows(600, 9, 9.5, td, cuda_device)
    shift = torch.as_tensor(np.random.default_rng(47).uniform(-3.75, 3.75, rows.valid.shape),
                            dtype=td, device=cuda_device)
    mid = rows.pos.clone()
    mid[..., 0] = torch.where(rows.valid, torch.remainder(mid[..., 0] + shift, 9.5), mid[..., 0])
    x = torch.where(rows.valid, mid[..., 0], float("nan"))
    assert bool((x[..., 1:] < x[..., :-1]).any())
    assert int(rows.valid.sum(-1).max()) > 128
    _check_filaments(mid.contiguous(), he, rows.valid, rows.gid, 9.5, 8, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_k4_filaments_full_row_and_x_wrap(cuda_device, dtype):
    """Straight chains along x in one row (as config #4 lays them), so one
    row holds ~5 warps of own segments beside rows of a few, and collinear
    pairs of segments of two filaments (reach 2 |e| + 2r = 1.5) just inside
    contact, just inside the reach margin and just outside it, the same
    across the x wrap: the kernel matches the plain version and pushes
    exactly the pairs in contact."""
    td, box, E = _DT[dtype], 30.0, 10
    rng = np.random.default_rng(53)
    mid, he = [], []
    for f in range(16):  # 16 straight chains along x at y, z in one row cell
        y0, z0 = 10.0 + 0.1 * (f % 4), 10.0 + 0.1 * (f // 4)
        x0 = rng.uniform(0, box)
        for k in range(E):
            mid.append([(x0 + k + 0.5) % box, y0, z0])
            he.append([0.5, 0.0, 0.0])
    reach = 1.5
    placed = [(2.0, 2.0 + reach * (1 - 1e-3), 2.0, True),
              (2.0, 2.0 + reach * (1 + 2e-4), 4.5, False),
              (2.0, 2.0 + reach * (1 + 2e-3), 7.0, False),
              (0.05, 0.05 - reach * (1 - 1e-3) + box, 14.5, True),
              (0.05, 0.05 - reach * (1 + 2e-4) + box, 17.0, False),
              (0.05, 0.05 - reach * (1 + 2e-3) + box, 19.5, False)]
    lines = np.asarray([[yz, yz + 3.0] for _, _, yz, _ in placed])
    while len(mid) < 16 * E + 30 * E:  # random chains away from the placed pieces
        start = rng.uniform(0, box, 3)
        d = rng.normal(size=3)
        d /= np.linalg.norm(d)
        chain = np.mod(start + (np.arange(E)[:, None] + 0.5) * d, box)
        gap = np.abs(chain[:, None, 1:] - lines[None])
        if (np.linalg.norm(np.minimum(gap, box - gap), axis=-1) < 2.5).any():
            continue
        mid.extend(chain)
        he.extend([0.5 * d] * E)
    first = len(mid)
    for xo, xc, yz, _ in placed:  # one-segment pieces of two filaments
        for x in (xo, xc):
            mid.append([x, yz, yz + 3.0])
            he.append([0.5, 0.0, 0.0])
    mid, he = np.asarray(mid), np.asarray(he)
    S = mid.shape[0]
    grid = tr.make_row_grid([0, 0, 0], [box] * 3, 1.8, S, dtype=td, align=8, device=cuda_device)
    grid = grid.replace(row_capacity=192)
    rows = tr.build_rows(torch.as_tensor(mid, dtype=td, device=cuda_device),
                         torch.arange(S, dtype=torch.int32, device=cuda_device), grid)
    gid = rows.gid.long().clamp(max=S - 1)
    he_rows = torch.where(rows.valid[..., None],
                          torch.as_tensor(he, dtype=td, device=cuda_device)[gid], 0.0)
    assert int(rows.valid.sum()) == S and int(rows.valid.sum(-1).max()) > 128
    # the placed pieces' gids first + 2i and first + 2i + 1 would be one
    # filament's neighbours: move the first of each past S
    gid_map = torch.arange(S, dtype=torch.int32, device=cuda_device)
    gid_map[first::2] += S  # placed pieces: no two gids one apart
    new_gid = torch.where(rows.valid, gid_map[gid], rows.gid).contiguous()
    fs, fe = _check_filaments(rows.pos, he_rows.contiguous(), rows.valid, new_gid, box, E,
                              dtype)
    f = tr.rows_to_flat(rows.replace(pos=fs + fe), S)
    for i, (_, _, _, touch) in enumerate(placed):
        assert bool(f[first + 2 * i].abs().max() > 0) == touch
        assert bool(f[first + 2 * i + 1].abs().max() > 0) == touch


@pytest.mark.cuda
def test_k4_filaments_past_shared_memory_raises(cuda_device):
    """The first design needed 9 R (6 x 8 + 4) bytes of shared memory and
    raised past the opt-in (R = 504 in float64). The kernel reads packed
    rows and keeps a fixed 8 KB per block in float64, so a row of R = 1504
    (271 KB of the old staging) launches: its valid slots get bit for bit
    the outputs of the narrow rows, its padding +0."""
    rows, he = _filament_rows(60, 6, 9.5, torch.float64, cuda_device)
    ny, nz, R, _ = rows.pos.shape
    pad = 1504 - R

    def widen(t, fill):
        return torch.cat([t, t.new_full(t.shape[:2] + (pad,) + t.shape[3:], fill)],
                         dim=2).contiguous()

    optin = torch.cuda.get_device_properties(cuda_device).shared_memory_per_block_optin
    assert 9 * 1504 * 52 > optin
    narrow = _check_filaments(rows.pos, he, rows.valid, rows.gid, 9.5, 5, "float64")
    before = k4.row_segment_filaments_sym.launches
    wide = k4.row_segment_filaments_sym(widen(rows.pos, -1e6), widen(he, 0.0),
                                        widen(rows.valid, False), widen(rows.gid, 0),
                                        (9.5,) * 3, 0.25, 274.725, 5)
    torch.cuda.synchronize()
    assert k4.row_segment_filaments_sym.launches == before + 1
    for n_out, w_out in zip(narrow, wide):
        assert torch.equal(w_out[:, :, :R], n_out)
        assert bool((w_out[:, :, R:] == 0).all())


def _se_geom(G, P, m, n, kind, slack=1.5, R=None):
    """A tile geometry at box 24 (ES beta as build_spectral_ewald sets it
    at sigma = 1.5; the Gaussian at xi = 0.87, eta = 0.5)."""
    geom = k5.make_se_grid_tiles(G, P, 24.0, 0.87, 0.5, n, capacity_slack=slack, min_m=m,
                                 kind=kind, beta=0.97 * np.pi * P * (1.0 - 1.0 / 3.0))
    assert geom.m == m
    return geom if R is None else geom._replace(R=R)


def _se_pieces(geom, n, td, dev, clustered=False, seed=7):
    rng = np.random.default_rng(seed)
    if clustered:  # four tight blobs across the periodic faces: full tiles, overflow
        centers = rng.uniform(0, 24.0, (4, 3))
        centers[0] = 0.05
        pos = np.mod(centers[rng.integers(0, 4, n)] + rng.normal(scale=1.2, size=(n, 3)), 24.0)
    else:
        pos = rng.uniform(0, 24.0, (n, 3))
    pieces = k5.se_bin_tiles(geom, torch.as_tensor(pos, dtype=td, device=dev), td)
    forces = torch.as_tensor(rng.normal(size=(n, 3)), dtype=td, device=dev)
    return pieces, forces


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("G,P,m,n,kind,clustered,R", [
    (64, 6, 8, 3000, "es", False, None),
    (64, 6, 8, 4000, "es", True, None),
    (48, 6, 16, 3000, "gaussian", False, None),
    (32, 8, 16, 800, "es", False, None),
    (16, 6, 16, 300, "es", False, None),
    (40, 6, 10, 2500, "es", False, None),
    (64, 6, 8, 6000, "es", True, 520),
], ids=["uniform", "clustered-overflow", "gaussian-3-tiles", "2-tiles-P8", "1-tile",
        "m10-two-point-passes", "R520-two-slot-passes"])
def test_k5_kernels_match_plain(cuda_device, dtype, G, P, m, n, kind, clustered, R):
    """K5s and K5i against their plain versions on the same binned pieces:
    every slot's window products round as the plain version's do (no FMA
    contraction), the sums run in another order, so float32 within 1e-5 and
    float64 within 1e-12 of max|grid| and of max|u|. The cases reach fewer
    than three tiles per axis (a neighbour tile visited once), m^3 > 512
    (two point passes per block), R > 512 (two slot passes per neighbour
    tile) and tiles that overflow (dropped slots gridded by neither)."""
    td = _DT[dtype]
    tol = 1e-12 if dtype == "float64" else 1e-5
    geom = _se_geom(G, P, m, n, kind, R=R)
    pieces, forces = _se_pieces(geom, n, td, cuda_device, clustered)
    if clustered and R is None:
        assert bool(pieces[1])
    before = (k5.se_spread.launches, k5.se_interp.launches)
    grid = k5.se_spread(geom, pieces, forces)
    ref = k5.se_spread_plain(geom, pieces, forces)
    u = k5.se_interp(geom, pieces, _planar(ref))
    u_ref = k5.se_interp_plain(geom, pieces, _planar(ref))
    torch.cuda.synchronize()
    assert (k5.se_spread.launches, k5.se_interp.launches) == (before[0] + 1, before[1] + 1)
    assert grid.shape == (G, G, G, 3) and u.shape == (n, 3)
    for got, want in ((grid, ref), (u, u_ref)):
        assert bool(torch.isfinite(got).all())
        scale = want.abs().max().item()
        assert scale > 0
        assert (got - want).abs().max().item() <= tol * scale
    dropped = pieces[4] >= pieces[0].numel()
    assert bool((u[dropped] == 0).all())


@pytest.mark.cuda
def test_k5s_repeats_bit_for_bit(cuda_device):
    """K5s sums each grid point over the same slots in the same order on
    every launch (no float atomics): two launches are bit-equal."""
    geom = _se_geom(64, 6, 8, 4000, "es")
    pieces, forces = _se_pieces(geom, 4000, torch.float32, cuda_device, clustered=True)
    assert torch.equal(k5.se_spread(geom, pieces, forces), k5.se_spread(geom, pieces, forces))


def _planar(grid):
    """The grid as three (G, G, G) planes, the channel axis outermost: the
    strides of the inverse FFT's output in mobility/spectral._k_apply."""
    return grid.permute(3, 0, 1, 2).contiguous().permute(1, 2, 3, 0)


_K5I_CASES = {"uniform": (64, 6, 8, 3000, "es", False),
              "clustered-overflow": (64, 6, 8, 4000, "es", True)}


def _k5i_inputs(dtype, case, dev):
    G, P, m, n, kind, clustered = _K5I_CASES[case]
    td = _DT[dtype]
    geom = _se_geom(G, P, m, n, kind)
    pieces, _ = _se_pieces(geom, n, td, dev, clustered)
    grid = torch.as_tensor(np.random.default_rng(41).normal(size=(G, G, G, 3)), dtype=td,
                           device=dev)
    return geom, pieces, _planar(grid)


def _k5i_digest(dtype, case, dev):
    """sha256 (first 16 hex digits) of K5i's output bytes on a seeded grid,
    at two cases of test_k5_kernels_match_plain. The first design read the
    same values in C order."""
    import hashlib

    geom, pieces, grid = _k5i_inputs(dtype, case, dev)
    return hashlib.sha256(k5.se_interp(geom, pieces, grid).cpu().numpy().tobytes()).hexdigest()[:16]


# _k5i_digest from K5i's first design, one thread per particle in gid
# order (NVIDIA H100 80GB HBM3)
_K5I_SHA = {
    ("float32", "uniform"): "007ea10fe7ad0bf4", ("float32", "clustered-overflow"): "ae2a49195784cdf0",
    ("float64", "uniform"): "be0f879d8efddafc", ("float64", "clustered-overflow"): "9772a276383d67ad",
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("case", ["uniform", "clustered-overflow"])
def test_k5i_outputs_unchanged(cuda_device, dtype, case):
    """K5i stages each tile's box of the grid and gives each (slot,
    channel) one thread that sums the reference's terms in its order (a, b,
    c nested, no FMA): its outputs stay bit for bit the first design's."""
    assert _k5i_digest(dtype, case, cuda_device) == _K5I_SHA[(dtype, case)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("case", ["uniform", "clustered-overflow"])
def test_k5i_reads_the_planar_layout(cuda_device, dtype, case):
    """The inverse FFT's layout (three planes, the channel axis outermost,
    as the wave apply passes it) against the plain version on the same
    grid (within 1e-5 of max|u| in float32, 1e-12 in float64); any other
    strides, C order among them, raise, with no launch counted."""
    geom, pieces, grid = _k5i_inputs(dtype, case, cuda_device)
    assert grid.stride() == (64 * 64, 64, 1, 64 ** 3)
    before = k5.se_interp.launches
    u = k5.se_interp(geom, pieces, grid)
    torch.cuda.synchronize()
    assert k5.se_interp.launches == before + 1
    u_ref = k5.se_interp_plain(geom, pieces, grid)
    scale = u_ref.abs().max().item()
    assert scale > 0
    assert (u - u_ref).abs().max().item() <= (1e-12 if dtype == "float64" else 1e-5) * scale
    for other in (grid.contiguous(), grid.transpose(0, 1)):
        with pytest.raises(ValueError, match="strides"):
            k5.se_interp(geom, pieces, other)
    assert k5.se_interp.launches == before + 1


def _free_space_pieces(dtype, dev, n=1000, seed=12):
    """The free-space operator's gridding at HP1's spacing h = 116.15 / 384
    on a G = 96 padded grid (box 29.0375): P = 10 (the ES default + 4), m =
    12 (the slab rule's edge at G = 384), R sized from the measured
    occupancy as the app sizes it. Ten random-walk chains of unit steps
    cluster within 6 of a point in the padded box's first half; 40 beads lie up to
    0.4 below 0 on each axis in turn, as the soft wall lets beads poke out
    of the domain, so floor(u) < 0 and their windows wrap across the faces
    of the padded grid."""
    td = _DT[dtype]
    rng = np.random.default_rng(seed)
    steps = rng.normal(size=(n, 3))
    steps /= np.linalg.norm(steps, axis=1, keepdims=True)
    pos = np.cumsum(steps, axis=0).reshape(10, n // 10, 3)
    pos -= pos.mean(axis=1, keepdims=True)
    pos = 6.2 + 6.0 * pos / np.abs(pos).max(axis=(1, 2), keepdims=True)
    pos = pos.reshape(n, 3)
    for a in range(3):
        pos[40 * a:40 * (a + 1), a] = -rng.uniform(0.0, 0.4, 40)
    G, P, m, box = 96, 10, 12, 116.15 / 4
    geom = k5.make_se_grid_tiles(G, P, box, 1.0, 0.0, n, capacity_slack=3.0, min_m=m,
                                 kind="es", beta=0.97 * np.pi * P * (1.0 - 1.0 / 3.0))
    assert geom.m == m
    it = np.clip((pos / (m * box / G)).astype(int), 0, G // m - 1)
    occ = np.bincount((it[:, 0] * (G // m) + it[:, 1]) * (G // m) + it[:, 2]).max()
    geom = geom._replace(R=((int(occ * 1.5) + 8 + 7) // 8) * 8)
    pieces = k5.se_bin_tiles(geom, torch.as_tensor(pos, dtype=td, device=dev), td)
    forces = torch.as_tensor(rng.normal(size=(n, 3)), dtype=td, device=dev)
    return geom, pieces, forces


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_k5_kernels_match_plain_free_space(cuda_device, dtype):
    """K5s and K5i at the free-space path's support and tile edge, P = 10
    and m = 12 (a runtime-P instantiation of K5i), on a clustered binning
    with slots below 0: within 1e-5 (float32) and 1e-12 (float64) of
    max|grid| and max|u| of their plain versions, no slot dropped."""
    geom, pieces, forces = _free_space_pieces(dtype, cuda_device)
    perm, ovf, u, valid, _slot_of = pieces
    assert not bool(ovf) and int(valid.sum()) == forces.shape[0]
    assert bool((u[valid] < 0).any(dim=0).all())  # negative u on every axis
    tol = 1e-12 if dtype == "float64" else 1e-5
    before = (k5.se_spread.launches, k5.se_interp.launches)
    grid = k5.se_spread(geom, pieces, forces)
    ref = k5.se_spread_plain(geom, pieces, forces)
    out = k5.se_interp(geom, pieces, _planar(ref))
    out_ref = k5.se_interp_plain(geom, pieces, _planar(ref))
    torch.cuda.synchronize()
    assert (k5.se_spread.launches, k5.se_interp.launches) == (before[0] + 1, before[1] + 1)
    for got, want in ((grid, ref), (out, out_ref)):
        scale = want.abs().max().item()
        assert scale > 0 and bool(torch.isfinite(got).all())
        assert (got - want).abs().max().item() <= tol * scale
    # the wrapped mass lands on the far faces of the padded grid
    assert ref[-1].abs().max().item() > 0 and ref[:, -1].abs().max().item() > 0


@pytest.mark.cuda
def test_surface_densities_refuse_tf32(cuda_device, monkeypatch):
    """The periphery densities need full float32 products: with TF32
    allowed a float32 call on the card raises; float64 runs."""
    from mundy_tpu_torch.mobility import periphery

    per = periphery.build_sphere_periphery(4, 1.0, device=cuda_device)
    u = torch.ones(per.points.shape, device=cuda_device)
    q = periphery.surface_densities(per, u)
    assert bool(torch.isfinite(q).all())
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    with pytest.raises(RuntimeError, match="allow_tf32"):
        periphery.surface_densities(per, u)
    per64 = periphery.build_sphere_periphery(4, 1.0, dtype=torch.float64, device=cuda_device)
    periphery.surface_densities(per64, u.double())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_k5i_slots_far_from_their_tiles(cuda_device, dtype):
    """Slots of every 7th tile moved 20 and 27.5 grid points from it in x
    and y (the binning never gives that; a caller may): a block whose box of
    supports would not fit its buffer or offset tables redoes its slots one
    by one. Against the plain version (1e-5 of max|u| in float32, 1e-12 in
    float64) and bit-equal on a second launch."""
    geom, (perm, ovf, u, valid, slot_of), grid = _k5i_inputs(dtype, "uniform", cuda_device)
    far = torch.zeros(perm.shape[0], dtype=torch.bool, device=cuda_device)
    far[::7] = True
    far = far[:, None] & valid
    u = u.clone()
    for axis, shift in ((0, 20.0), (1, 27.5)):
        u[..., axis] = torch.where(far, torch.remainder(u[..., axis] + shift, geom.G),
                                   u[..., axis])
    pieces = (perm, ovf, u.contiguous(), valid, slot_of)
    got = k5.se_interp(geom, pieces, grid)
    ref = k5.se_interp_plain(geom, pieces, grid)
    scale = ref.abs().max().item()
    assert scale > 0
    assert (got - ref).abs().max().item() <= (1e-12 if dtype == "float64" else 1e-5) * scale
    assert torch.equal(got, k5.se_interp(geom, pieces, grid))


@pytest.mark.cuda
def test_k5i_repeats_bit_for_bit(cuda_device):
    """Each velocity is one thread's sum in a fixed order (no float
    atomics): two launches are bit-equal, dropped particles zero."""
    geom, pieces, grid = _k5i_inputs("float32", "clustered-overflow", cuda_device)
    u = k5.se_interp(geom, pieces, grid)
    assert torch.equal(u, k5.se_interp(geom, pieces, grid))
    dropped = pieces[4] >= pieces[0].numel()
    assert bool(dropped.any()) and bool((u[dropped] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_k5s_full_tiles_beside_empty_ones(cuda_device, dtype):
    """Tiles in a checkerboard: every even tile full (count = R = 16, three
    beads more in one, which overflow), every odd tile empty, so each walk
    meets extents R and 0 side by side. Within 1e-5 (float32) or 1e-12
    (float64) of max|grid|, and a second launch bit-equal."""
    td, R, nt1, edge = _DT[dtype], 16, 8, 3.0  # box 24, G = 64, m = 8
    rng = np.random.default_rng(31)
    t = np.stack(np.meshgrid(*(np.arange(nt1),) * 3, indexing="ij"), -1).reshape(-1, 3)
    even = t[t.sum(1) % 2 == 0]
    corners = np.concatenate([np.repeat(even, R, 0), np.zeros((3, 3))]) * edge
    pos = corners + rng.uniform(0.0, edge, corners.shape)
    geom = _se_geom(64, 6, 8, pos.shape[0], "es", R=R)
    pieces = k5.se_bin_tiles(geom, torch.as_tensor(pos, dtype=td, device=cuda_device), td)
    forces = torch.as_tensor(rng.normal(size=pos.shape), dtype=td, device=cuda_device)
    count = pieces[3].sum(1).cpu().numpy()
    assert bool(pieces[1]) and set(count.tolist()) == {0, R}
    grid = k5.se_spread(geom, pieces, forces)
    ref = k5.se_spread_plain(geom, pieces, forces)
    assert torch.equal(grid, k5.se_spread(geom, pieces, forces))
    scale = ref.abs().max().item()
    assert scale > 0
    tol = 1e-12 if dtype == "float64" else 1e-5
    assert (grid - ref).abs().max().item() <= tol * scale


@pytest.mark.cuda
def test_k5_refuses_outside_its_envelope(cuda_device):
    """A tile edge below P/2 + 1 would let a window reach past the
    neighbouring tiles, a window wider than the grid would meet a point
    twice, and int64 ids or mixed dtypes are not the kernels' inputs: the
    wrappers raise before any launch, no plain fallback."""
    geom = _se_geom(64, 6, 8, 1000, "es")
    pieces, forces = _se_pieces(geom, 1000, torch.float32, cuda_device)
    before = (k5.se_spread.launches, k5.se_interp.launches)
    with pytest.raises(ValueError, match="tile edge"):
        k5.se_spread(geom._replace(P=16), pieces, forces)
    with pytest.raises(TypeError, match="int32"):
        k5.se_spread(geom, (pieces[0].long(),) + tuple(pieces[1:]), forces)
    with pytest.raises(TypeError, match="dtype"):
        k5.se_spread(geom, pieces, forces.double())
    with pytest.raises(TypeError, match="int32"):
        k5.se_interp(geom, tuple(pieces[:4]) + (pieces[4].long(),),
                     _planar(torch.zeros((64, 64, 64, 3), device=cuda_device)))
    narrow = _se_geom(10, 12, 10, 200, "es")  # P > G: a window wraps onto itself
    npieces, nforces = _se_pieces(narrow, 200, torch.float32, cuda_device)
    with pytest.raises(ValueError, match="wider than the grid"):
        k5.se_spread(narrow, npieces, nforces)
    assert (k5.se_spread.launches, k5.se_interp.launches) == before


def _k3t_inputs(dtype, nb, W, B, sort, dev):
    """(gamma, normals, loc) with ids over [-B/4, 5B/4), some outside [0, B):
    every block sorted (sort True), none (False) or the blocks listed."""
    rng = np.random.default_rng(6)
    loc = rng.integers(-B // 4, B + B // 4, (nb, W))
    if sort is True:
        loc = np.sort(loc, axis=1)
    elif sort:
        for b in sort:
            loc[b] = np.sort(loc[b])
    td = _DT[dtype]
    normals = rng.normal(size=(nb, 3, W))
    normals /= np.linalg.norm(normals, axis=1, keepdims=True)
    normals = torch.as_tensor(normals, dtype=td, device=dev)
    gamma = torch.as_tensor(rng.normal(size=(nb, W)), dtype=td, device=dev)
    return gamma, normals, torch.as_tensor(loc, dtype=torch.int32, device=dev)


# (nb, W, B, sorted blocks): W = 2600 spans several scan tiles; (0, 2) mixes
# sorted blocks and unsorted ones (1, 3) in one launch; B = 1500 takes two
# passes of the run bounds
_K3T_CASES = [(7, 640, 1024, True), (5, 2600, 1024, False), (3, 300, 200, False),
              (4, 640, 1024, (0, 2)), (2, 700, 1500, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("nb,W,B,sort", _K3T_CASES)
def test_k3t_kernel_matches_plain(cuda_device, dtype, nb, W, B, sort):
    """K3t is bit-equal to its plain version, on the run-sum path (sorted
    blocks), the scan (unsorted ones) and both in one launch; a slot whose
    id lies outside [0, B) gets t = 0."""
    gamma, normals, loc = _k3t_inputs(dtype, nb, W, B, sort, cuda_device)
    before = k3.strided_onehot_t.launches
    got = k3.strided_onehot_t(gamma, normals, loc, B)
    torch.cuda.synchronize()
    assert k3.strided_onehot_t.launches == before + 1
    ref = k3.strided_t_plain(gamma, normals, loc, B)
    assert got.shape == (nb, W) and ref.abs().max().item() > 0.5
    assert torch.equal(got, ref)
    assert bool((got[(loc < 0) | (loc >= B)] == 0).all())


def _poly_radii(ts, n, rng, td, dev):
    r = torch.as_tensor(0.5 * (1.0 + 0.4 * rng.uniform(-1, 1, n)), dtype=td, device=dev)
    return torch.where(ts.valid, r[ts.gid.long().clamp(max=n - 1)], 0.0).contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("radii", [False, True])
@pytest.mark.parametrize("n,box,cutoff,align", [(4000, 12.0, 1.4, 8),
                                                 (3000, 13.0, 1.8, 1),
                                                 (80000, 40.0, 1.8, 8)])
def test_k6_kernel_matches_plain(cuda_device, dtype, radii, n, box, cutoff, align):
    """With and without a radius plane, against the plain version (without
    one, the plain version's monodisperse law). align=1 gives nz = 7;
    n = 80000 gives R > 256: rows longer than one 256-thread pass, and in
    float64 more than 48 KB of shared memory."""
    td = _DT[dtype]
    rng = np.random.default_rng(12)
    ts = _rows(n, box, cutoff, align, td, cuda_device, seed=12)
    if n == 80000:
        assert ts.pos.shape[2] > 256
    r = _poly_radii(ts, n, rng, td, cuda_device) if radii else None
    args = (ts.pos, ts.valid, (box,) * 3, 0.5, 1000.0, 0.3)
    before = k6.row_hertzian_forces.launches
    got = k6.row_hertzian_forces(*args, radii=r)
    torch.cuda.synchronize()
    assert k6.row_hertzian_forces.launches == before + 1
    ref = k6.row_hertzian_forces_plain(*args, radii=r)
    assert bool(torch.isfinite(got).all())
    assert bool((got[~ts.valid] == 0).all())
    fmax = ref.abs().max().item()
    assert fmax > 1.0
    err = (got - ref).abs().max().item()
    assert err <= (1e-12 if dtype == "float64" else 5e-5) * fmax
    if not radii:  # the same forces as K1's half stencil on these rows
        f1 = k1.row_hertzian_forces_sym(ts.pos, (box,) * 3, 0.5, 1000.0, 0.3)
        m = ts.valid
        assert (got[m] - f1[m]).abs().max().item() <= (
            1e-12 if dtype == "float64" else 5e-5) * fmax


@pytest.mark.cuda
@pytest.mark.parametrize("radii", [False, True])
def test_k6_rows_moved_since_the_rebuild(cuda_device, radii):
    """Every sphere moved by (0.3, 0.3, 0.3) and wrapped, with no rebuild:
    slots stay in their rows while many positions cross a periodic y or z
    face. The kernel and its plain version both take the minimum image on
    all three axes: float64 within 1e-12 of max|f|."""
    n, box, td = 4000, 12.0, torch.float64
    rng = np.random.default_rng(15)
    ts = _rows(n, box, 1.8, 8, td, cuda_device, seed=15)
    moved = torch.remainder(ts.pos + 0.3, box)
    pos = torch.where(ts.valid[..., None], moved, ts.pos).contiguous()
    r = _poly_radii(ts, n, rng, td, cuda_device) if radii else None
    args = (pos, ts.valid, (box,) * 3, 0.5, 1000.0, 0.3)
    got = k6.row_hertzian_forces(*args, radii=r)
    ref = k6.row_hertzian_forces_plain(*args, radii=r)
    fmax = ref.abs().max().item()
    assert fmax > 1.0
    assert (got - ref).abs().max().item() <= 1e-12 * fmax


_K6_SHAPES = [(4000, 12.0, 1.4, 8), (3000, 13.0, 1.8, 1), (80000, 40.0, 1.8, 8)]


def _k6_inputs(dtype, radii, n, box, cutoff, align, dev):
    """test_k6_kernel_matches_plain's inputs."""
    td = _DT[dtype]
    rng = np.random.default_rng(12)
    ts = _rows(n, box, cutoff, align, td, dev, seed=12)
    r = _poly_radii(ts, n, rng, td, dev) if radii else None
    return (ts.pos, ts.valid, (box,) * 3, 0.5, 1000.0, 0.3), r


def _k6_digest(dtype, radii, n, box, cutoff, align, dev):
    """sha256 (first 16 hex digits) of K6's output bytes, every slot, on
    test_k6_kernel_matches_plain's inputs."""
    import hashlib

    args, r = _k6_inputs(dtype, radii, n, box, cutoff, align, dev)
    got = k6.row_hertzian_forces(*args, radii=r)
    return hashlib.sha256(got.cpu().numpy().tobytes()).hexdigest()[:16]


# _k6_digest from K6's first design, which gave every slot a thread that
# walked all 9 R staged candidates (NVIDIA H100 80GB HBM3)
_K6_SHA = {
    ("float32", False, 4000): "2e95f9e0212fb82e", ("float32", False, 3000): "a1a03e672d852432",
    ("float32", False, 80000): "ffbb4317e47d6a17", ("float32", True, 4000): "576ba24850b903a5",
    ("float32", True, 3000): "14ac089f9abbe23f", ("float32", True, 80000): "7ef1864f50786ad0",
    ("float64", False, 4000): "f70ca0a0e46329e8", ("float64", False, 3000): "954b0b81586f5b75",
    ("float64", False, 80000): "00cb0e4f43a81c30", ("float64", True, 4000): "dea547a7a7efbab6",
    ("float64", True, 3000): "7faee236af29cfd1", ("float64", True, 80000): "d229d4014c219fc6",
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("radii", [False, True])
@pytest.mark.parametrize("n,box,cutoff,align", _K6_SHAPES)
def test_k6_outputs_unchanged(cuda_device, dtype, radii, n, box, cutoff, align):
    """K6 leaves out padded slots, chunks out of reach in x and pairs
    stopped before their rsqrt, all of which the first design skipped too,
    and keeps its order of terms: its outputs, padded slots included, stay
    bit for bit the first design's."""
    got = _k6_digest(dtype, radii, n, box, cutoff, align, cuda_device)
    assert got == _K6_SHA[(dtype, radii, n)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("radii", [False, True])
def test_k6_repeats_bit_for_bit(cuda_device, dtype, radii):
    """Each own sphere's terms are added in one order by one group of
    lanes, with no atomics: a second launch gives the same bits."""
    args, r = _k6_inputs(dtype, radii, 80000, 40.0, 1.8, 8, cuda_device)
    got = k6.row_hertzian_forces(*args, radii=r)
    assert torch.equal(got, k6.row_hertzian_forces(*args, radii=r))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_k6_spheres_at_one_x_visit_every_chunk(cuda_device, dtype):
    """Every sphere at x = 3, spread in y and z: every chunk's x range is
    one point within reach of every own sphere, so the window visits all of
    them, and the early stop alone sorts the pairs. Against the plain
    version (5e-5 of max|f| in float32, 1e-12 in float64) and bit-equal on
    a second launch."""
    n, box, td = 3000, 12.0, _DT[dtype]
    rng = np.random.default_rng(47)
    pos = np.column_stack([np.full(n, 3.0), rng.uniform(0, box, (n, 2))])
    ts = tr.build_rows(torch.as_tensor(pos, dtype=td, device=cuda_device),
                       torch.arange(n, dtype=torch.int32, device=cuda_device),
                       tr.make_row_grid([0, 0, 0], [box] * 3, 1.8, n, dtype=td, align=8,
                                        device=cuda_device))
    assert int(ts.valid.sum(-1).max()) > 8  # rows of several chunks
    r = _poly_radii(ts, n, rng, td, cuda_device)
    args = (ts.pos, ts.valid, (box,) * 3, 0.5, 1000.0, 0.3)
    got = k6.row_hertzian_forces(*args, radii=r)
    ref = k6.row_hertzian_forces_plain(*args, radii=r)
    fmax = ref.abs().max().item()
    assert fmax > 1.0
    assert (got - ref).abs().max().item() <= (1e-12 if dtype == "float64" else 5e-5) * fmax
    assert torch.equal(got, k6.row_hertzian_forces(*args, radii=r))


@pytest.mark.cuda
def test_k6_past_shared_memory_raises(cuda_device):
    """float64 at R = 709 stages (36 R + 36 ceil(R / 8)) 8 + 4 R + 36 =
    232,696 bytes, past the H100's 232,448-byte opt-in (the largest
    float64 row is R = 708, 1400 in float32): the wrapper raises before any
    launch, with no plain fallback; float32 at the same R launches."""
    R = 709
    optin = torch.cuda.get_device_properties(cuda_device).shared_memory_per_block_optin
    assert k6.shared_bytes(R, 8) > optin >= k6.shared_bytes(R - 1, 8)
    assert k6.shared_bytes(R, 4) <= optin
    pos = torch.full((5, 5, R, 3), 1.0, dtype=torch.float64, device=cuda_device)
    pos[..., 1] = -1e6
    valid = torch.zeros((5, 5, R), dtype=torch.bool, device=cuda_device)
    radii = torch.zeros((5, 5, R), dtype=torch.float64, device=cuda_device)
    before = k6.row_hertzian_forces.launches
    with pytest.raises(ValueError, match="shared memory"):
        k6.row_hertzian_forces(pos, valid, (10.0,) * 3, 0.5, 1000.0, 0.3, radii=radii)
    assert k6.row_hertzian_forces.launches == before
    out = k6.row_hertzian_forces(pos.float(), valid, (10.0,) * 3, 0.5, 1000.0, 0.3,
                                 radii=radii.float())
    torch.cuda.synchronize()
    assert k6.row_hertzian_forces.launches == before + 1
    assert bool((out == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("n,box,align,K", [(6000, 14.5, 8, 20),
                                           (4000, 13.05, 1, 12),
                                           (80000, 40.0, 8, 24),
                                           (3000, 13.0, 8, k2.K_MAX)])
def test_k2_radius_variant_matches_plain(cuda_device, dtype, n, box, align, K):
    """With a per-slot search-radius plane (zero on invalid slots) the
    pair cutoff is s_own + s_cand: ids, order and counts bit-equal to the
    plain version, and counted as radius launches. n = 80000 gives R > 128
    threads per block; K = K_MAX is the regrow ceiling."""
    td = _DT[dtype]
    ts = _rows(n, box, 1.8, align, td, cuda_device, seed=14)
    planes = _search_radii(ts, n, 14, td, cuda_device)
    args = (ts.pos, ts.gid, ts.valid, ((box,) * 3, (True,) * 3), 1.8, K, n)
    before = (k2.row_neighbor_extract.launches, k2.row_neighbor_extract.radius_launches)
    ids, cnt = k2.row_neighbor_extract(*args, radii=planes)
    torch.cuda.synchronize()
    assert (k2.row_neighbor_extract.launches,
            k2.row_neighbor_extract.radius_launches) == (before[0], before[1] + 1)
    ids_p, cnt_p = k2.row_neighbor_extract_plain(*args, radii=planes)
    assert int(cnt_p.max()) > 0
    assert torch.equal(cnt, cnt_p)
    assert torch.equal(ids, ids_p)
    # the radii change the pair set: a uniform cutoff finds another one
    _, cnt_u = k2.row_neighbor_extract(*args)
    assert not torch.equal(cnt_u, cnt)


def _k2_check(pos, ts, box, cutoff, K, n, radii=None):
    """K2 (or its radius variant) against the plain version, ids and counts
    bit-equal, and a second launch bit-equal; returns the counts."""
    args = (pos, ts.gid, ts.valid, ((box,) * 3, (True,) * 3), cutoff, K, n)
    ids, cnt = k2.row_neighbor_extract(*args, radii=radii)
    ids_p, cnt_p = k2.row_neighbor_extract_plain(*args, radii=radii)
    assert int(cnt_p.max()) > 0
    assert torch.equal(cnt, cnt_p)
    assert torch.equal(ids, ids_p)
    ids2, cnt2 = k2.row_neighbor_extract(*args, radii=radii)
    assert torch.equal(ids2, ids) and torch.equal(cnt2, cnt)
    return cnt


def _search_radii(ts, n, seed, td, dev):
    s = torch.as_tensor(np.random.default_rng(seed).uniform(0.3, 0.9, n), dtype=td,
                        device=dev)
    return torch.where(ts.valid, s[ts.gid.long().clamp(max=n - 1)], 0.0).contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("radii", [False, True])
def test_k2_spheres_at_one_x_visit_every_chunk(cuda_device, dtype, radii):
    """Every sphere at x = 3, spread in y and z: every chunk's x range is
    one point within the cut of every own sphere, so the window visits all
    of them and the pair test alone sorts the hits; many hits tie in x."""
    n, box, td = 3000, 12.0, _DT[dtype]
    rng = np.random.default_rng(51)
    pos = np.column_stack([np.full(n, 3.0), rng.uniform(0, box, (n, 2))])
    cutoff = 1.8 if radii else 1.45
    ts = tr.build_rows(torch.as_tensor(pos, dtype=td, device=cuda_device),
                       torch.arange(n, dtype=torch.int32, device=cuda_device),
                       tr.make_row_grid([0, 0, 0], [box] * 3, cutoff, n, dtype=td, align=8,
                                        device=cuda_device))
    assert int(ts.valid.sum(-1).max()) > 3 * k2.CHUNK  # rows of several chunks
    sr = _search_radii(ts, n, 52, td, cuda_device) if radii else None
    _k2_check(ts.pos, ts, box, cutoff, 16, n, sr)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("radii", [False, True])
def test_k2_pairs_across_the_x_face(cuda_device, dtype, radii):
    """Half the spheres within the cut of the x face: many pairs and chunks
    wrap, and the kernel's window takes the minimum image as its pairs do.
    Some neighbor lies across the face."""
    n, box, td = 6000, 14.5, _DT[dtype]
    rng = np.random.default_rng(53)
    p = rng.uniform(0, box, (n, 3))
    p[::2, 0] = np.mod(rng.uniform(-0.8, 0.8, p[::2].shape[0]), box)
    cutoff = 1.8 if radii else 1.45
    ts = tr.build_rows(torch.as_tensor(p, dtype=td, device=cuda_device),
                       torch.arange(n, dtype=torch.int32, device=cuda_device),
                       tr.make_row_grid([0, 0, 0], [box] * 3, cutoff, n, dtype=td, align=8,
                                        device=cuda_device))
    sr = _search_radii(ts, n, 54, td, cuda_device) if radii else None
    K = 20
    _k2_check(ts.pos, ts, box, cutoff, K, n, sr)
    ids, _ = k2.row_neighbor_extract(ts.pos, ts.gid, ts.valid, ((box,) * 3, (True,) * 3),
                                     cutoff, K, n, radii=sr)
    x = torch.as_tensor(p[:, 0], dtype=td, device=cuda_device)
    own = torch.where(ts.valid, ts.gid, 0).long()[..., None].expand(ids.shape)
    got = ids < n
    across = (x[own] - x[torch.where(got, ids, 0).long()]).abs() > box / 2
    assert bool((got & across).any())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("radii", [False, True])
def test_k2_rows_moved_since_the_rebuild(cuda_device, dtype, radii):
    """Every sphere moved by a normal step (sd 0.4) and wrapped, with no
    rebuild: slots stay in their rows, rows lose their x order, and chunk
    bounds come from the current positions."""
    n, box, td = 6000, 14.5, _DT[dtype]
    cutoff = 1.8 if radii else 1.45
    ts = _rows(n, box, cutoff, 8, td, cuda_device, seed=55)
    step = torch.as_tensor(np.random.default_rng(56).normal(0, 0.4, ts.pos.shape), dtype=td,
                           device=cuda_device)
    pos = torch.where(ts.valid[..., None], torch.remainder(ts.pos + step, box),
                      ts.pos).contiguous()
    x = pos[..., 0]
    assert bool(((x[..., 1:] < x[..., :-1]) & ts.valid[..., 1:]).any())  # stale x order
    sr = _search_radii(ts, n, 57, td, cuda_device) if radii else None
    _k2_check(pos, ts, box, cutoff, 20, n, sr)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("radii", [False, True])
def test_k2_lattice_ties_beyond_k(cuda_device, dtype, radii):
    """A simple cubic lattice of unit spacing at half-integer coordinates:
    every separation is exact, each sphere has 6 hits at r2 = 1 and 12 at
    r2 = 2 within the cut 1.6, and K = 12 keeps 6 of the 12 exact ties, so
    the candidate lane order alone decides which."""
    m, td = 16, _DT[dtype]
    g = np.arange(m) + 0.5
    p = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)
    n, box, cutoff = p.shape[0], float(m), 1.6
    ts = tr.build_rows(torch.as_tensor(p, dtype=td, device=cuda_device),
                       torch.arange(n, dtype=torch.int32, device=cuda_device),
                       tr.make_row_grid([0, 0, 0], [box] * 3, cutoff, n, dtype=td, align=8,
                                        device=cuda_device))
    sr = torch.where(ts.valid, 0.8, 0.0).to(td).contiguous() if radii else None
    cnt = _k2_check(ts.pos, ts, box, cutoff, 12, n, sr)
    assert bool((cnt[ts.valid] == 18).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("radii", [False, True])
def test_k2_repeats_bit_for_bit(cuda_device, dtype, radii):
    """Each slot's hits are counted and kept by one group of lanes in
    candidate order, with no atomics: two launches at R > 128 give the same
    bits, equal to the plain version's."""
    td = _DT[dtype]
    ts = _rows(80000, 40.0, 1.8 if radii else 1.45, 8, td, cuda_device, seed=58)
    assert ts.pos.shape[2] > 128
    sr = _search_radii(ts, 80000, 59, td, cuda_device) if radii else None
    _k2_check(ts.pos, ts, 40.0, 1.8 if radii else 1.45, 24, 80000, sr)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("radii", [False, True])
def test_k2_past_shared_memory_raises(cuda_device, dtype, radii):
    """At the largest R whose staged rows fit the card's opt-in shared
    memory (row_extract.shared_bytes) the kernel launches, which shows the
    formula is the kernel's request; one slot more raises before any launch,
    with no plain fallback."""
    td = _DT[dtype]
    itemsize = torch.tensor([], dtype=td).element_size()
    optin = torch.cuda.get_device_properties(cuda_device).shared_memory_per_block_optin
    R = 1
    while k2.shared_bytes(R + 1, itemsize, radii) <= optin:
        R += 1

    def planes(R):  # 3 spheres per row at one point, the rest build_rows' sentinel
        valid = torch.zeros((5, 5, R), dtype=torch.bool, device=cuda_device)
        valid[..., :3] = True
        pos = torch.full((5, 5, R, 3), 1.0, dtype=td, device=cuda_device)
        pos[..., 1] = torch.where(valid, 1.0, -1e6)
        gid = torch.arange(5 * 5 * R, dtype=torch.int32, device=cuda_device).reshape(5, 5, R)
        sr = torch.where(valid, 0.5, 0.0).to(td) if radii else None
        return pos, gid, valid, sr

    box = ((10.0,) * 3, (True,) * 3)
    pos, gid, valid, sr = planes(R)
    ids, cnt = k2.row_neighbor_extract(pos, gid, valid, box, 1.0, 12, 10 ** 6, radii=sr)
    torch.cuda.synchronize()
    ids_p, cnt_p = k2.row_neighbor_extract_plain(pos, gid, valid, box, 1.0, 12, 10 ** 6,
                                                 radii=sr)
    assert torch.equal(ids, ids_p) and torch.equal(cnt, cnt_p)
    pos, gid, valid, sr = planes(R + 1)
    before = (k2.row_neighbor_extract.launches, k2.row_neighbor_extract.radius_launches)
    with pytest.raises(ValueError, match="shared memory"):
        k2.row_neighbor_extract(pos, gid, valid, box, 1.0, 12, 10 ** 6, radii=sr)
    assert (k2.row_neighbor_extract.launches,
            k2.row_neighbor_extract.radius_launches) == before


def _k3_inputs(nb, W, B, td, dev, seed, sorted_blocks, lo=None, hi=None):
    """(nb, 3, W) values and (nb, W) int32 ids drawn from [lo, hi) (default
    [-B/4, 5B/4)), the blocks in `sorted_blocks` sorted."""
    rng = np.random.default_rng(seed)
    lo = -B // 4 if lo is None else lo
    hi = B + B // 4 if hi is None else hi
    loc = rng.integers(lo, hi, (nb, W), dtype=np.int64)
    for b in sorted_blocks:
        loc[b] = np.sort(loc[b])
    values = torch.as_tensor(rng.normal(size=(nb, 3, W)), dtype=td, device=dev)
    return values, torch.as_tensor(loc.astype(np.int32), device=dev)


def _k3_check(values, loc, B):
    got = k3.strided_onehot_segment_sum(values, loc, B)
    ref = k3.strided_segment_sum_plain(values, loc, B)
    assert torch.equal(got, ref)
    assert torch.equal(k3.strided_onehot_segment_sum(values, loc, B), got)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_k3_sorted_and_unsorted_blocks_in_one_launch(cuda_device, dtype):
    """Blocks 0 and 2 sorted, 1 and 3 not, in one launch: each block takes
    its own path, both bit-equal to the plain version and on a second
    launch."""
    values, loc = _k3_inputs(4, 640, 1024, _DT[dtype], cuda_device, 61, (0, 2))
    down = (loc[:, 1:] < loc[:, :-1]).any(1).tolist()
    assert down == [False, True, False, True]
    _k3_check(values, loc, 1024)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("B", [200, 1500])
def test_k3_sorted_runs_of_ids_outside_the_block(cuda_device, dtype, B):
    """Sorted blocks whose runs include negative ids, ids >= B and the int32
    extremes (compared as raw ints, and dropped), with B not a multiple of
    32; B = 1500 takes two passes of the run bounds. Long runs of one id."""
    nb, W = 3, 700
    values, loc = _k3_inputs(nb, W, B, _DT[dtype], cuda_device, 62, range(nb),
                             lo=-B // 3, hi=B + B // 3)
    loc[:, :5] = torch.iinfo(torch.int32).min
    loc[:, -5:] = torch.iinfo(torch.int32).max
    loc[1, 100:300] = loc[1, 100]  # a long run, kept sorted
    loc = torch.sort(loc, dim=1).values.contiguous()
    assert bool((loc[:, 1:] >= loc[:, :-1]).all())
    assert bool((loc < 0).any()) and bool((loc >= B).any())
    _k3_check(values, loc, B)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_k3_on_the_lcp_strided_layout(cuda_device, dtype):
    """The strided layout of a small LCPSpheresSim run on the CPU (2000
    spheres, 2 body blocks, pads of id N inside the last block's range),
    moved to the card: every block is sorted, and K3 is bit-equal to the
    plain version."""
    from mundy_tpu_torch.constraints.collision import (active_pair_subset_strided,
                                                       collision_setup_spheres)
    from mundy_tpu_torch.driver.apps.lcp_spheres import LCPSpheresConfig, LCPSpheresSim

    td = _DT[dtype]
    sim = LCPSpheresSim(LCPSpheresConfig(num_spheres=2000, box_size=20.0, radius=0.5,
                                         dt=1e-3, diffusion_coeff=0.01,
                                         constraint_buffer=0.45, dtype=dtype), device="cpu")
    st = sim.init()
    for _ in range(6):
        st = sim.run_block(st, 1, resize=False)
    setup = collision_setup_spheres(st.pos, sim._radius(), st.pairs, sim.metric)
    act = active_pair_subset_strided(setup, sim._dyn_margin(setup), 2000, sim.seg_block,
                                     sim.act_window, st.seg_starts)
    nb, W, B = sim.nb_blocks, sim.act_window, sim.seg_block
    gam = torch.rand(act.setup.pairs.i.shape, generator=torch.Generator().manual_seed(3),
                     dtype=td)
    gn = -(torch.where(act.setup.pairs.mask, gam, 0.0)[:, None] * act.setup.normals)
    values = gn.reshape(nb, W, 3).transpose(1, 2).contiguous().to(cuda_device)
    blk = torch.arange(nb, dtype=torch.int32)[:, None] * B
    loc = (act.setup.pairs.i.reshape(nb, W) - blk).contiguous().to(cuda_device)
    assert nb == 2 and bool((loc[:, 1:] >= loc[:, :-1]).all())
    assert int(act.setup.pairs.mask.sum()) > 100
    _k3_check(values, loc, B)


def _k3t_digest(dtype, nb, W, B, sort, dev, fn=k3.strided_onehot_t):
    """sha256 (first 16 hex digits) of fn's output bytes on
    test_k3t_kernel_matches_plain's inputs."""
    import hashlib

    got = fn(*_k3t_inputs(dtype, nb, W, B, sort, dev), B)
    return hashlib.sha256(got.cpu().numpy().tobytes()).hexdigest()[:16]


# _k3t_digest of K3t's first design, which scanned every block (NVIDIA H100
# 80GB HBM3); the cases nb = 4 and 2 are the plain version's on the CPU,
# which gives the first design's bits on the other three
_K3T_SHA = {
    ("float32", 7): "523673516c2e91e8", ("float32", 5): "34b41eb2cf3c7ed2",
    ("float32", 3): "1e42a16f6d835907", ("float32", 4): "36ea4b41a89be849",
    ("float64", 7): "8a86056a74a31697", ("float64", 5): "02ee71c9fef99b49",
    ("float64", 3): "a2c82fa7bb028a1f", ("float64", 4): "11ff608ebab518ed",
    ("float32", 2): "edcd9cc99ad12a47", ("float64", 2): "1cd0e93c766a2ea2",
}


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("nb,W,B,sort", _K3T_CASES)
def test_k3t_plain_gives_the_pinned_bits(dtype, nb, W, B, sort):
    """On the CPU the plain version gives the bits that _K3T_SHA pins for
    the card's kernel: the first design's on every case it ran."""
    assert _k3t_digest(dtype, nb, W, B, sort, "cpu", k3.strided_t_plain) \
        == _K3T_SHA[(dtype, nb)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("nb,W,B,sort", _K3T_CASES)
def test_k3t_outputs_unchanged(cuda_device, dtype, nb, W, B, sort):
    """K3t's redesign (run sums in sorted blocks) keeps the first design's
    outputs bit for bit."""
    assert _k3t_digest(dtype, nb, W, B, sort, cuda_device) == _K3T_SHA[(dtype, nb)]


def _rows_geom(G, P, n, kind, slack=1.15, min_m=8):
    """A row geometry at box 24 (the ES beta of build_spectral_ewald at
    sigma = 1.5; the Gaussian at xi = 0.87, eta = 0.5)."""
    return k5.make_se_grid_rows(G, P, 24.0, 0.87, 0.5, n, capacity_slack=slack, min_m=min_m,
                                kind=kind, beta=0.97 * np.pi * P * (1.0 - 1.0 / 3.0))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("G,P,min_m,n,kind,clustered", [
    (64, 6, 8, 3000, "es", False),
    (64, 6, 8, 4000, "es", True),
    (48, 6, 8, 2500, "gaussian", False),
    (32, 8, 16, 800, "es", False),
    (16, 6, 8, 300, "es", False),
    (72, 10, 8, 3000, "es", False),
])
def test_k5_rows_kernels_match_plain(cuda_device, dtype, G, P, min_m, n, kind, clustered):
    """K5s-rows and K5i-rows against their plain versions on the same
    pieces (se_bin_and_windows): float32 within 1e-5 and float64 within
    1e-12 of max|grid| and of max|u|. The cases reach two rows per axis
    (each neighbour row visited once), m = 16, P = 10 and rows that
    overflow (dropped particles gridded by neither, interpolated to 0);
    two launches of each are bit-equal."""
    td = _DT[dtype]
    tol = 1e-12 if dtype == "float64" else 1e-5
    geom = _rows_geom(G, P, n, kind, min_m=min_m)
    rng = np.random.default_rng(13)
    pos = rng.uniform(0, 24.0, (n, 3))
    if clustered:
        pos[: n // 2] = np.mod(rng.normal(scale=1.0, size=(n // 2, 3)) + 3.0, 24.0)
    pieces = k5.se_bin_and_windows(geom, torch.as_tensor(pos, dtype=td, device=cuda_device),
                                   td)
    assert bool(pieces[1]) == clustered
    forces = torch.as_tensor(rng.normal(size=(n, 3)), dtype=td, device=cuda_device)
    before = (k5.se_spread_rows_pre.launches, k5.se_interp_rows_pre.launches)
    grid = k5.se_spread_rows_pre(geom, pieces, forces)
    ref = k5.se_spread_rows_plain(geom, pieces, forces)
    u = k5.se_interp_rows_pre(geom, pieces, n, _planar(ref))
    u_ref = k5.se_interp_rows_plain(geom, pieces, n, _planar(ref))
    torch.cuda.synchronize()
    assert (k5.se_spread_rows_pre.launches,
            k5.se_interp_rows_pre.launches) == (before[0] + 1, before[1] + 1)
    for got, want in ((grid, ref), (u, u_ref)):
        scale = want.abs().max().item()
        assert scale > 0 and (got - want).abs().max().item() <= tol * scale
    assert torch.equal(grid, k5.se_spread_rows_pre(geom, pieces, forces))
    assert torch.equal(u, k5.se_interp_rows_pre(geom, pieces, n, _planar(ref)))
    dropped = ~torch.isin(torch.arange(n, device=cuda_device), pieces[0].reshape(-1).long())
    assert bool(dropped.any()) == clustered
    assert not bool(u[dropped].any())


@pytest.mark.cuda
def test_k5_rows_refuse_off_the_envelope(cuda_device):
    """A row edge below P/2 + 1 and a slab wider than the grid raise
    before any launch."""
    geom = _rows_geom(48, 10, 500, "es", min_m=4)
    assert geom.m == 4
    pos = torch.rand((500, 3), device=cuda_device) * 24.0
    pieces = k5.se_bin_and_windows(geom, pos, torch.float32)
    forces = torch.zeros((500, 3), device=cuda_device)
    with pytest.raises(ValueError, match="row edge"):
        k5.se_spread_rows_pre(geom, pieces, forces)
    narrow = _rows_geom(8, 6, 50, "es")
    npieces = k5.se_bin_and_windows(narrow, pos[:50], torch.float32)
    with pytest.raises(ValueError, match="wider than the grid"):
        k5.se_spread_rows_pre(narrow, npieces, forces[:50])


_K5_ROWS_CASES = {  # the cases of test_k5_rows_kernels_match_plain
    "G64": (64, 6, 8, 3000, "es", False),
    "G64-clustered": (64, 6, 8, 4000, "es", True),
    "G48-gaussian": (48, 6, 8, 2500, "gaussian", False),
    "G32-m16": (32, 8, 16, 800, "es", False),
    "G16": (16, 6, 8, 300, "es", False),
    "G72-P10": (72, 10, 8, 3000, "es", False),
}
_K5_ROWS_STRESS = ("one-x", "x-wrap", "full-row")


def _row_of(geom, pos):
    """(iy, iz) of each position, as _bin_rows bins it."""
    h = geom.box / geom.G
    nyz = geom.G // geom.m
    iyz = np.clip((pos[:, 1:] / (geom.m * h)).astype(np.int32), 0, nyz - 1)
    return iyz[:, 0], iyz[:, 1]


def _k5_rows_case(case, td, dev):
    """(geom, pieces, forces, n) of a rows-kernel case: those of
    test_k5_rows_kernels_match_plain, and three that stress the x-run
    lists. one-x: the 30-odd beads of row (2, 5) at one x, their supports
    across the edge x = 32 of two runs (two lists hold the whole row).
    x-wrap: G 72 (runs of 32, 32 and 8 points), P 10, half the beads within
    half a unit of x = 0, so supports wrap across x = 0 and some meet three
    runs. full-row: row (1, 1) filled to exactly R slots, all at one x
    across x = 32, its lists at the scratch's R max_runs entries and K5i-rows'
    chunk loop taken three times."""
    rng = np.random.default_rng(13)
    if case in _K5_ROWS_CASES:
        G, P, min_m, n, kind, clustered = _K5_ROWS_CASES[case]
        geom = _rows_geom(G, P, n, kind, min_m=min_m)
        pos = rng.uniform(0, 24.0, (n, 3))
        if clustered:
            pos[: n // 2] = np.mod(rng.normal(scale=1.0, size=(n // 2, 3)) + 3.0, 24.0)
    elif case == "one-x":
        n = 2000
        geom = _rows_geom(64, 6, n, "es")
        pos = rng.uniform(0, 24.0, (n, 3))
        iy, iz = _row_of(geom, pos)
        pos[(iy == 2) & (iz == 5), 0] = 31.5 * geom.box / geom.G
    elif case == "x-wrap":
        n = 3000
        geom = _rows_geom(72, 10, n, "es")
        pos = rng.uniform(0, 24.0, (n, 3))
        pos[: n // 2, 0] = np.mod(rng.uniform(-0.5, 0.5, n // 2), 24.0)
    elif case == "full-row":
        n0 = 2500
        geom = _rows_geom(48, 6, n0, "gaussian")
        h = geom.box / geom.G
        pos = rng.uniform(0, 24.0, (n0, 3))
        iy, iz = _row_of(geom, pos)
        k = geom.R - int(((iy == 1) & (iz == 1)).sum())
        lo, hi = geom.m * h + 1e-3, 2 * geom.m * h - 1e-3
        extra = np.stack([np.zeros(k), rng.uniform(lo, hi, k), rng.uniform(lo, hi, k)], 1)
        pos = np.concatenate([pos, extra])
        iy, iz = _row_of(geom, pos)
        pos[(iy == 1) & (iz == 1), 0] = 31.5 * h
        n = pos.shape[0]
    else:
        raise KeyError(case)
    pieces = k5.se_bin_and_windows(geom, torch.as_tensor(pos, dtype=td, device=dev), td)
    forces = torch.as_tensor(rng.normal(size=(n, 3)), dtype=td, device=dev)
    return geom, pieces, forces, n


def _k5_rows_grid(geom, td, dev):
    """K5i-rows' input for the digests: a seeded normal grid, planar."""
    g = np.random.default_rng(17).normal(size=(geom.G,) * 3 + (3,))
    return _planar(torch.as_tensor(g, dtype=td, device=dev))


def _k5_rows_digests(dtype, case, dev):
    """sha256 (first 16 hex digits) of K5s-rows' grid and of K5i-rows' u
    (on _k5_rows_grid) for a case of _k5_rows_case."""
    import hashlib

    td = _DT[dtype]
    geom, pieces, forces, n = _k5_rows_case(case, td, dev)
    grid = k5.se_spread_rows_pre(geom, pieces, forces)
    u = k5.se_interp_rows_pre(geom, pieces, n, _k5_rows_grid(geom, td, dev))
    return tuple(hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()[:16] for t in (grid, u))


# _k5_rows_digests of the rows kernels' first design, which scanned every
# occupied slot of the 9 rows around each (row cell, x-run) and gave each
# slot's interpolation half a warp of L2 gathers (NVIDIA H100 80GB HBM3)
_K5_ROWS_SHA = {
    ("float32", "G64"): ("3a351b9d78edcd12", "0f44124f99001c72"),
    ("float64", "G64"): ("fbac9b42716832d0", "15e3262e31b7b133"),
    ("float32", "G64-clustered"): ("533bc0974938d27e", "2101b81f3b4dfb22"),
    ("float64", "G64-clustered"): ("651e81d2f9aca4fd", "af0145b1ebb12acb"),
    ("float32", "G48-gaussian"): ("95e130e34e998997", "aa1a56a91f8c8d9e"),
    ("float64", "G48-gaussian"): ("032bee9720f67975", "9e379961b0932562"),
    ("float32", "G32-m16"): ("31b2810cc262f19d", "7bc1c76b2d744f68"),
    ("float64", "G32-m16"): ("24c55581e4debc9e", "57f063f0e97d3405"),
    ("float32", "G16"): ("67adc47b80af9b45", "efaac33ad547a7c6"),
    ("float64", "G16"): ("47ea8cc2ace18141", "a69afa442c26b3b8"),
    ("float32", "G72-P10"): ("87fd682b0c7cfe49", "a4f8b92fd7ebd49a"),
    ("float64", "G72-P10"): ("373307316041a487", "e922717fca4ecdfb"),
    ("float32", "one-x"): ("9adf8766f7436e1e", "a18ccd0c4d2ecd74"),
    ("float64", "one-x"): ("3eaec1b30e6b456a", "a1ba46ca76518453"),
    ("float32", "x-wrap"): ("d95fd32edac4e87a", "19b84cfadda86473"),
    ("float64", "x-wrap"): ("d75bf9eeb02fedf7", "cedf6abf1fc46cbe"),
    ("float32", "full-row"): ("84b61fe49aaa171e", "088625d1283c25a4"),
    ("float64", "full-row"): ("777767d0d52f8ae7", "19dbdd8614d9733a"),
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("case", list(_K5_ROWS_CASES) + list(_K5_ROWS_STRESS))
def test_k5_rows_outputs_unchanged(cuda_device, dtype, case):
    """The rows kernels' redesign (x-run lists, zero segments skipped, the
    interpolation box staged in shared memory) keeps the first design's
    grid and u bit for bit."""
    assert _k5_rows_digests(dtype, case, cuda_device) == _K5_ROWS_SHA[(dtype, case)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("case", _K5_ROWS_STRESS)
def test_k5_rows_lists_stress(cuda_device, dtype, case):
    """The cases that stress the x-run lists (_k5_rows_case) against the
    plain versions, at the bounds of test_k5_rows_kernels_match_plain, one
    launch a call, two launches bit-equal."""
    td = _DT[dtype]
    tol = 1e-12 if dtype == "float64" else 1e-5
    geom, pieces, forces, n = _k5_rows_case(case, td, cuda_device)
    perm = pieces[0]
    occ = (perm < n).sum(1)
    plan = k5.rows_plan(geom, forces.element_size())
    assert not bool(pieces[1]) and int(occ.sum()) == n
    if case == "full-row":
        assert int(occ.max()) == geom.R and plan.spread_lcap == 2 * geom.R
    if case == "x-wrap":
        assert plan.nxr == 3 and plan.max_runs == 3
    grid_in = _k5_rows_grid(geom, td, cuda_device)
    before = (k5.se_spread_rows_pre.launches, k5.se_interp_rows_pre.launches)
    grid = k5.se_spread_rows_pre(geom, pieces, forces)
    u = k5.se_interp_rows_pre(geom, pieces, n, grid_in)
    torch.cuda.synchronize()
    assert (k5.se_spread_rows_pre.launches,
            k5.se_interp_rows_pre.launches) == (before[0] + 1, before[1] + 1)
    for got, want in ((grid, k5.se_spread_rows_plain(geom, pieces, forces)),
                      (u, k5.se_interp_rows_plain(geom, pieces, n, grid_in))):
        scale = want.abs().max().item()
        assert scale > 0 and (got - want).abs().max().item() <= tol * scale
    assert torch.equal(grid, k5.se_spread_rows_pre(geom, pieces, forces))
    assert torch.equal(u, k5.se_interp_rows_pre(geom, pieces, n, grid_in))


@pytest.mark.cuda
def test_k5_rows_refuse_past_their_runs(cuda_device):
    """A grid of more than MAX_RUNS runs of RUN_X points along x raises
    before any launch (rows_plan, which both wrappers call)."""
    G = (k5.MAX_RUNS + 1) * k5.RUN_X
    geom = _rows_geom(G, 6, 200, "es")
    pos = torch.rand((200, 3), device=cuda_device) * 24.0
    pieces = k5.se_bin_and_windows(geom, pos, torch.float32)
    before = k5.se_spread_rows_pre.launches
    with pytest.raises(ValueError, match="runs of"):
        k5.se_spread_rows_pre(geom, pieces, torch.zeros((200, 3), device=cuda_device))
    assert k5.se_spread_rows_pre.launches == before
