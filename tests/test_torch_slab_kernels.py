"""K6 and K4's rods op on the slab engines' halo-extended blocks, on the card.

The z-slab engines (parallel/slab_rows.py, parallel/slab_segments.py) hand
each kernel a rank's own planes between one halo plane below and one above,
padded with empty, invalid planes up to 5, and keep the own planes' outputs.
Here a slab of nzl = 1, 2 and 3 planes is cut from a row layout built on the
card, its halo planes taken from the neighbouring planes (the lower one
across the box's z face, shifted by -L as the edge rank's halo is), and the
kernel is held on the own planes against its plain version on the same
block: K6 within 5e-5 of max|f| (spheres_block adds the y wrap as two halo
rows and gives K6 the lengths (L, 4L, 4L)), K4 within 1e-5 of each max.
These need an NVIDIA GPU with nvcc and skip without one; the file imports no
JAX, so on the card:

    python -m pytest --noconftest -m cuda tests/test_torch_slab_kernels.py
"""

import pytest
import torch

from mundy_tpu_torch.math.quaternion import quat_rotate
from mundy_tpu_torch.neighbor.rows import build_rows, make_row_grid
from mundy_tpu_torch.ops.kernels import row_hertz as k6
from mundy_tpu_torch.ops.kernels import row_segments as k4
from mundy_tpu_torch.parallel.slab_rows import empty_slot, spheres_block
from mundy_tpu_torch.parallel.slab_segments import rods_block


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _slab(packed, nzl, box):
    """(lo, own, hi) planes of the slab starting at plane 0: the lower halo
    is the last plane across the z face (shifted by -L in z)."""
    lo = packed[:, -1:].clone()
    lo[..., 2] = lo[..., 2] + (-box)
    return lo, packed[:, :nzl].contiguous(), packed[:, nzl:nzl + 1].contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("nzl", [1, 2, 3])
def test_k6_on_extended_block(cuda_device, dtype, nzl):
    n, box = 6000, 24.0
    pos = torch.rand((n, 3), dtype=dtype, device=cuda_device,
                     generator=torch.Generator(cuda_device).manual_seed(nzl)) * box
    grid = make_row_grid([0, 0, 0], [box] * 3, 1.4, n, dtype=dtype, device=cuda_device)
    rows = build_rows(pos, torch.arange(n, dtype=torch.int32, device=cuda_device), grid)
    packed = torch.cat([rows.pos, rows.valid[..., None].to(dtype)], dim=-1)
    lo, own, hi = _slab(packed, nzl, box)
    pe, ve, lengths = spheres_block(lo, own, hi, box, empty_slot(grid, 4, dtype, cuda_device))
    assert pe.shape[1] == max(nzl + 2, 5)
    ny = rows.pos.shape[0]
    args = (lengths, 0.5, 1000.0, 0.3)
    got = k6.row_hertzian_forces(pe, ve, *args)[1:1 + ny, 1:1 + nzl]
    want = k6.row_hertzian_forces_plain(pe, ve, *args)[1:1 + ny, 1:1 + nzl]
    m = rows.valid[:, :nzl]
    fmax = want[m].abs().max().item()
    assert fmax > 0
    assert (got[m] - want[m]).abs().max().item() <= 5e-5 * fmax


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("nzl", [1, 2, 3])
def test_k4_rods_on_extended_block(cuda_device, dtype, nzl):
    n, box, radius = 4000, 30.0, 0.25
    gen = torch.Generator(cuda_device).manual_seed(10 + nzl)
    pos = torch.rand((n, 3), dtype=dtype, device=cuda_device, generator=gen) * box
    quat = torch.nn.functional.normalize(
        torch.randn((n, 4), dtype=dtype, device=cuda_device, generator=gen), dim=1)
    grid = make_row_grid([0, 0, 0], [box] * 3, 2.9, n, dtype=dtype, device=cuda_device)
    rows = build_rows(pos, torch.arange(n, dtype=torch.int32, device=cuda_device), grid)
    q = quat[torch.clamp(rows.gid.long(), max=n - 1)]
    axes = quat_rotate(q, torch.tensor([0.0, 0.0, 1.0], dtype=dtype, device=cuda_device))
    hedges = 1.0 * torch.where(rows.valid[..., None], axes, 0.0)
    packed = torch.cat([rows.pos, hedges, rows.valid[..., None].to(dtype)], dim=-1)
    lo, own, hi = _slab(packed, nzl, box)
    mid, he, ve, lengths = rods_block(lo, own, hi, box, empty_slot(grid, 7, dtype, cuda_device))
    assert mid.shape[1] == max(nzl + 2, 5)
    e_eff = 1000.0 / (2.0 * (1.0 - 0.09))
    fk, tk = (x[:, 1:1 + nzl] for x in k4.row_segment_pairs_sym(mid, he, ve, lengths, radius,
                                                                 e_eff))
    fp, tp = (x[:, 1:1 + nzl] for x in k4.row_segment_pairs_plain(mid, he, lengths, radius,
                                                                   e_eff))
    m = rows.valid[:, :nzl]
    for got, want in ((fk, fp), (tk, tp)):
        vmax = want[m].abs().max().item()
        assert vmax > 0
        assert (got[m] - want[m]).abs().max().item() <= 1e-5 * vmax
