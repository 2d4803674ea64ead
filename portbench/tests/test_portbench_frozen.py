"""The frozen copies in portbench give the smoke script's numbers."""

import importlib.util
import os

import pytest
import torch

from portbench import bounds, devtrace

from .conftest import ROOT


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _layout(seed: int, ny=6, nz=6, R=16, box=9.0, fill=0.6):
    """A synthetic (ny, nz, R) rows layout of a periodic box: random
    occupancy, positions inside each slot's row."""
    g = torch.Generator().manual_seed(seed)
    valid = torch.rand((ny, nz, R), generator=g) < fill
    u = torch.rand((ny, nz, R, 3), generator=g)
    iy = torch.arange(ny)[:, None, None]
    iz = torch.arange(nz)[None, :, None]
    pos = torch.stack([u[..., 0] * box, (iy + u[..., 1]) * box / ny,
                       (iz + u[..., 2]) * box / nz], dim=-1)
    return pos.to(torch.float32), valid, (box, box, box)


@pytest.mark.parametrize("seed", [1, 2])
def test_counts_equal_the_smoke_script(smoke, seed):
    pos, valid, box = _layout(seed)
    radii = valid.to(pos.dtype) * 0.5
    assert bounds.stencil_work(valid) == smoke.stencil_work(valid, torch)
    assert bounds.contact_pairs(pos, valid, box, radii) == smoke.contact_pairs(
        pos, valid, box, radii, torch)
    reach = bounds.k1_reach(0.5)
    assert bounds.cut_pairs_in_x(pos, valid, box, radii, reach) == smoke.cut_pairs_in_x(
        pos, valid, box, radii, reach, torch)
    rs = type("Rows", (), {"pos": pos, "valid": valid})
    new, pairs, _ = smoke.k2_bound(rs, box, 1.45, 12, None, torch)
    assert bounds.k2_bound(pos, valid, box, 1.45, 12) == new + (pairs,)


def test_constants_and_bound_equal_the_smoke_script(smoke):
    assert (bounds.K1_PAIR_OPS, bounds.K1_CONTACT_OPS) == (smoke.K1_PAIR_OPS, smoke.K1_CONTACT_OPS)
    assert bounds.PEAK_FLOPS[torch.float32] == smoke.PEAK_FP32
    assert bounds.PEAK_BYTES == smoke.PEAK_BYTES
    for flops, nbytes in ((1e9, 1e6), (1e6, 1e9)):
        assert bounds.bound(flops, nbytes) == smoke.bound(flops, nbytes)


def test_k1_and_k3_bounds_follow_the_smoke_formulas(smoke):
    pos, valid, box = _layout(3)
    m = valid
    in_x = smoke.cut_pairs_in_x(pos, m, box, m.to(pos.dtype) * 0.5,
                                lambda dx2, ro, rc: dx2 <= 1.0 * (1.0 + 2.0 ** -10), torch)
    contacts = smoke.contact_pairs(pos, m, box, m.to(pos.dtype) * 0.5, torch)
    flops = in_x * smoke.K1_PAIR_OPS + contacts * smoke.K1_CONTACT_OPS
    nbytes = m.numel() * (1 + 12) + int(m.sum()) * 12  # as chip_smoke.py's [2]
    assert bounds.k1_bound(pos, valid, box, 0.5) == smoke.bound(flops, nbytes) + (flops, nbytes)
    nb, W, B, n_act = 977, 640, 1024, 123456
    values, loc, sums = nb * 3 * W, nb * W, nb * 3 * B  # [8]'s elements, 4 bytes each
    assert bounds.k3_bound(nb, W, B, n_act) == smoke.bound(3.0 * n_act, (values + loc + sums) * 4)


def test_row_layout_matches_the_grid_rule():
    g = torch.Generator().manual_seed(5)
    box, cutoff, slack, n = 40.0, 1.45, 1.3, 4000
    pos = torch.rand((n, 3), generator=g, dtype=torch.float64) * box
    rpos, valid = bounds.row_layout(pos, box, cutoff, slack)
    ny = (int(box // cutoff) // 8) * 8
    cap = -(-int(n / ny ** 2 * slack + 8 + 0.999999) // 8) * 8
    assert valid.shape == (ny, ny, cap) and int(valid.sum()) == n
    got = torch.sort(rpos[valid][:, 0]).values
    assert torch.equal(got, torch.sort(pos[:, 0]).values)


class _Ev:
    def __init__(self, name, a, b, dev):
        self.name = name
        self.time_range = type("T", (), {"start": a, "end": b})
        self.device_type = dev


def test_trace_reading_counts_like_profile_window():
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    ev = [_Ev("aten::_local_scalar_dense", 0, 5, cpu), _Ev("cudaLaunchKernel", 1, 2, cpu),
          _Ev("cudaLaunchKernel", 10, 11, cpu), _Ev("aten::_local_scalar_dense", 30, 40, cpu),
          _Ev("k_a", 2, 6, cuda), _Ev("k_b", 5, 9, cuda), _Ev("k_a", 20, 25, cuda)]
    t = devtrace.Trace(ev, 50e-6, steps=2)
    assert t.per_step(devtrace.HOST_READS) == 1.0 and t.per_step(devtrace.LAUNCHES) == 1.0
    assert t.kernel("k_a") == (2, pytest.approx(9e-6))
    assert t.busy_s == pytest.approx(12e-6)  # [2, 9] and [20, 25]
    gaps = dict(t.idle_by_host)
    assert gaps["aten::_local_scalar_dense"] == pytest.approx(15e-6)  # [25, 40]
    assert gaps["cudaLaunchKernel"] == pytest.approx(2e-6)  # [0, 2]: the innermost event
    assert gaps["host"] == pytest.approx(11e-6)  # [9, 20]: no event covers its middle
