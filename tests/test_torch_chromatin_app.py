"""Config #5 end to end: the torch ChromatinSim vs the JAX ChromatinSim with
the periodic spectral-Ewald RPY mobility (`hydro="rpy_spectral"`).

Both apps build and initialise from one config (2 chains x 64 beads, box
24, 16 crosslinkers, float64, D = 0.05, skin 0.1): positions from the same
seeded numpy draws, the run's key from the same threefry split. At this
size init picks G = 64, P = 6, SE tile R = 48 and the real-space density
split (base capacity 8, 40 excess slots in up to 64 dense cells), so the
split path runs. Every step is held:
rebuild counters, overflow flags, binding states and targets equal,
positions within 1e-8. The residual comes from the float32 forward FFT of
both wave sums (the reference's cast, kept), the Brownian normals (Giles'
erf_inv within 2 ulp of XLA's) and the order of the sums. The JAX app's
init alone costs ~25 s here, so one module fixture serves both tests; the
free-space and neighbor-RPY modes and the regrow loop are in
test_torch_chromatin_app_free.py.
"""

import jax
import numpy as np
import pytest
import torch

from mundy_tpu.driver.apps.chromatin import ChromatinConfig as JaxConfig
from mundy_tpu.driver.apps.chromatin import ChromatinSim as JaxSim
from mundy_tpu_torch.core.config import config_from_dict
from mundy_tpu_torch.driver.apps.chromatin import ChromatinConfig, ChromatinSim

torch.set_num_threads(1)

KW = dict(num_chains=2, beads_per_chain=64, bead_radius=0.5, num_crosslinkers=16,
          diffusion_coeff=0.05, dt=2e-4, num_steps=30, dtype="float64", chunk=256,
          hydro="rpy_spectral", box_size=24.0, skin=0.1, binding_rate=50.0,
          unbinding_rate=5.0)
STEPS = 30
TOL = 1e-8


@pytest.fixture(scope="module")
def pair():
    jsim = JaxSim(JaxConfig(**KW))
    tsim = ChromatinSim(config_from_dict(ChromatinConfig, KW), device="cpu")
    return jsim, jsim.init(), tsim, tsim.init()


def assert_same_step(js, ts, tol=TOL):
    assert ts.step == int(js.step)
    assert ts.rebuild_count == int(js.rebuild_count)
    assert bool(ts.overflow) == bool(js.overflow)
    np.testing.assert_array_equal(ts.xl_state.numpy(), np.asarray(js.xl_state))
    np.testing.assert_array_equal(ts.xl_bound_to.numpy(), np.asarray(js.xl_bound_to))
    np.testing.assert_allclose(ts.pos.numpy(), np.asarray(js.pos), rtol=0, atol=tol)


def test_init_matches(pair):
    """Init's measured right-sizings (SE tile R, hydro cell capacity and
    density split, rows slack, contact_K, kmc_K), the key, the positions and
    the searches are the reference's."""
    jsim, js, tsim, ts = pair
    assert tuple(tsim.se_geom) == tuple(jsim.se_geom)
    assert (tsim.spectral.grid_n, tsim.spectral.support) == (64, 6)
    assert tsim.se_geom.R == 48
    assert tsim.hydro_split == jsim.hydro_split == (40, 64)
    assert tsim.hydro_split_grid.capacity == jsim.hydro_split_grid.capacity == 8
    assert tsim.hydro_cells_grid.capacity == jsim.hydro_cells_grid.capacity
    assert (tsim.contact_K, tsim.kmc_K, tsim.rows_slack, tsim.kmc_cell_capacity) == (
        jsim.contact_K, jsim.kmc_K, jsim.rows_slack, jsim.kmc_cell_capacity)
    assert tsim.broad_phase() == "rows"
    assert ts.key == tuple(int(w) for w in np.asarray(jax.random.key_data(js.key)))
    np.testing.assert_array_equal(ts.pos.numpy(), np.asarray(js.pos))
    np.testing.assert_array_equal(ts.xl_home.numpy(), np.asarray(js.xl_home))
    np.testing.assert_array_equal(ts.nmat.idx.numpy(), np.asarray(js.nmat.idx))
    np.testing.assert_array_equal(ts.kmc_nmat.idx.numpy(), np.asarray(js.kmc_nmat.idx))
    assert_same_step(js, ts, tol=0.0)


def test_trajectory_matches(pair):
    """30 steps one block at a time: the skin trigger fires (>= 2 rebuilds
    after init's) and crosslinkers bind, with the same counters, binding
    states and positions at every step."""
    jsim, js, tsim, ts = pair
    for _ in range(STEPS):
        js, ts = jsim.run_block(js, 1), tsim.run_block(ts, 1)
        assert_same_step(js, ts)
    assert ts.rebuild_count >= 3
    assert tsim.doubly_bound(ts) > 0
    assert not bool(ts.overflow)
