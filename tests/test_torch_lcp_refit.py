"""The LCP refit's row occupancy (`lcp_spheres.row_occupancy`), counted on
the positions' device, against the numpy chain it replaced: `np.mod` of the
positions, floor division of y and z by the row cell edges, `np.bincount`.
The counts are equal element for element, with positions below 0, at and
above the box and on the row cell edges; an app whose refit counts with the
numpy chain makes the same decisions (`rows_slack`, `rows_k`) and the same
trajectory bit for bit; a block's refits copy nothing to the host and read
one scalar each. The refit keeps two spare neighbor slots above the max
it reads.

The file imports no JAX, so its card case runs on a machine with the card
alone:

    python -m pytest --noconftest -m cuda tests/test_torch_lcp_refit.py
"""

import math
import types

import numpy as np
import pytest
import torch

from mundy_tpu_torch.driver.apps.lcp_spheres import (LCPSpheresConfig, LCPSpheresSim,
                                                     row_occupancy)
from mundy_tpu_torch.driver.regrow import run_blocks
from mundy_tpu_torch.io import telemetry
from mundy_tpu_torch.neighbor.rows import make_row_grid

_DT = {"float32": torch.float32, "float64": torch.float64}


def _numpy_occupancy(p: np.ndarray, box_size: float, grid) -> np.ndarray:
    """The refit's occupancy as the host computed it before it moved to the
    device: the oracle."""
    cell_y, cell_z = grid.cell_yz.tolist()
    p = np.mod(p, box_size)
    iy = np.minimum((p[:, 1] // cell_y).astype(np.int64), grid.ny - 1)
    iz = np.minimum((p[:, 2] // cell_z).astype(np.int64), grid.nz - 1)
    return np.bincount(iy * grid.nz + iz, minlength=grid.ny * grid.nz)


def _numpy_refit_rows_slack(self, pos) -> bool:
    """LCPSpheresSim._refit_rows_slack with the oracle's host count."""
    c = self.config
    if self._n_cells() < 5:
        return False
    g = make_row_grid([0, 0, 0], [c.box_size] * 3, 2 * self.search_radius, c.num_spheres,
                      capacity_slack=self.rows_slack, dtype=self.dtype, align=8)
    occ = _numpy_occupancy(pos.cpu().numpy(), c.box_size, g)
    mean = c.num_spheres / (g.ny * g.nz)
    target_cap = ((int(occ.max() * 1.12) + 6 + 7) // 8) * 8
    slack = max(1.15, (target_cap - 8) / mean)
    if abs(slack - self.rows_slack) / self.rows_slack < 0.05:
        return False
    self.rows_slack = slack
    return True


def _grid(n: int, box: float, dtype):
    """The row grid the app's refit builds (radius 0.5, buffer 0.45)."""
    return make_row_grid([0, 0, 0], [box] * 3, 2 * (0.5 + 0.5 * 0.45), n,
                         capacity_slack=1.9, dtype=dtype, align=8)


def _edge_positions(n: int, box: float, grid, dtype, gen, device="cpu") -> torch.Tensor:
    """n positions: uniform over [-box, 2 box), then, in y and z, every
    multiple of the row cell edge from -2 to 2 cells past the box and its
    two float neighbours, the box's own edge and its neighbours, and -0."""
    pos = (torch.rand((n, 3), generator=gen, dtype=dtype, device=device) * 3 - 1) * box
    cell_y, cell_z = grid.cell_yz.tolist()
    for col, cell, cells in ((1, cell_y, grid.ny), (2, cell_z, grid.nz)):
        k = torch.arange(-2 * cells, 2 * cells + 3, dtype=dtype, device=device)
        edges = torch.cat([k * cell, torch.tensor([box, -box, 2 * box, -0.0, 0.0],
                                                  dtype=dtype, device=device)])
        edges = torch.cat([edges, torch.nextafter(edges, edges + 1),
                           torch.nextafter(edges, edges - 1)])
        assert edges.numel() <= n // 2
        pos[: edges.numel(), col] = edges
        pos[n // 2: n // 2 + edges.numel(), col] = edges.flip(0)
    return pos


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("n,box", [(3000, 30.0), (2048, 27.8128)])
def test_row_occupancy_equals_the_numpy_chain(dtype, n, box):
    td = _DT[dtype]
    grid = _grid(n, box, td)
    pos = _edge_positions(n, box, grid, td, torch.Generator().manual_seed(n))
    got = row_occupancy(pos, box, grid)
    assert got.dtype == torch.int32 and got.shape == (grid.ny * grid.nz,)
    want = _numpy_occupancy(pos.numpy(), box, grid)
    np.testing.assert_array_equal(got.numpy(), want)
    assert int(got.sum()) == n


def _box(n: int) -> float:
    """The periodic box of n spheres of radius 0.5 at volume fraction 0.05."""
    return (n * 4.0 / 3.0 * math.pi * 0.125 / 0.05) ** (1 / 3)


def _sim(n: int = 2048, oracle: bool = False) -> LCPSpheresSim:
    sim = LCPSpheresSim(LCPSpheresConfig(num_spheres=n, box_size=_box(n),
                                         diffusion_coeff=0.1, constraint_buffer=0.45,
                                         dtype="float32", seed=5), device="cpu")
    if oracle:
        sim._refit_rows_slack = types.MethodType(_numpy_refit_rows_slack, sim)
    return sim


def test_rows_slack_after_init_and_refits_is_the_oracles():
    """init's right-sizing and a run of blocks with refits: the app and a
    copy of it whose refit counts with the numpy chain agree on every
    capacity after each block and on the positions bit for bit."""
    torch.manual_seed(0)
    new, old = _sim(), _sim(oracle=True)
    assert new._n_cells() >= 5  # the rows broad phase, so the refit counts
    s_new, s_old = new.init(), old.init()
    assert new.rows_slack == old.rows_slack != 1.9  # init moved the slack
    for _ in range(4):
        s_new = new.run_block(s_new, 2)
        s_old = old.run_block(s_old, 2)
        for name in ("rows_slack", "rows_k", "pair_capacity", "act_window"):
            assert getattr(new, name) == getattr(old, name), name
        assert int(s_new.rebuild_count) == int(s_old.rebuild_count)
        assert torch.equal(s_new.pos, s_old.pos)


def test_a_block_of_refits_copies_nothing_and_reads_one_scalar_each():
    sim = _sim()
    state = sim.init()
    copies = dict(telemetry.copies)
    occ0, kmax0 = telemetry.reads["refit.occ_max"], telemetry.reads["refit.kmax"]
    run_blocks(sim, state, 3, 3, log=lambda s: None)
    assert dict(telemetry.copies) == copies
    refits = telemetry.reads["refit.kmax"] - kmax0  # each refit that reached the count
    assert refits >= 1
    assert telemetry.reads["refit.occ_max"] - occ0 == refits


@pytest.mark.parametrize("kmax,want", [(7, 12), (6, 8), (2, 4)])
def test_the_refit_keeps_two_spare_neighbor_slots(kmax, want):
    """Two refits that read the same max neighbor count shrink rows_k to a
    multiple of 4 at least two above it; a reading of 7 keeps 12, where one
    spare slot (8) overflowed once a sphere reached 9 neighbors."""
    sim = _sim()
    state = sim.init()
    mask = torch.zeros_like(state.nmat.mask)
    assert mask.shape[1] >= kmax
    mask[0, :kmax] = True
    state = state.replace(nmat=state.nmat._replace(mask=mask))
    sim.rows_k = 16
    sim._refit_broad(state)  # the first demand waits a block
    assert sim.rows_k == 16
    sim._refit_broad(state)
    assert sim.rows_k == want


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the count is checked where the benchmark runs it)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_row_occupancy_on_the_card_equals_the_numpy_chain(cuda_device, dtype):
    """At the benchmark's 4,194,304 spheres and box, against numpy of the
    copied positions; the count makes no host sync of its own."""
    n, box, td = 4_194_304, 352.8278358533799, _DT[dtype]
    grid = _grid(n, box, td)
    pos = _edge_positions(n, box, grid, td,
                          torch.Generator(device=cuda_device).manual_seed(7), cuda_device)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = row_occupancy(pos, box, grid)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    want = _numpy_occupancy(pos.cpu().numpy(), box, grid)
    np.testing.assert_array_equal(got.cpu().numpy(), want)
    assert int(got.sum()) == n
