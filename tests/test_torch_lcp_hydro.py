"""The LCP line's hydro modes end to end: the torch LCPSpheresSim vs the JAX
LCPSpheresSim for `rpy_neighbors`, `rpy_ewald` and `rpy_spectral`.

The config is the reference's hydro tests' (tests/test_app_lcp_spheres.py:
150 spheres, box 14, dt 2e-3, float64, overlap tolerance 1e-6) with the
Brownian drift of its steady-state test (D = 0.02), so that every step
solves and a second skin rebuild falls inside the block. Both sims start
from the JAX app's initial positions and state key. init's right-sizing
must make the same capacities; over 14 steps the BBPGD iterations, active
counts, rebuilds and overflow must be equal at every step, and positions
agree within 1e-8 (the Brownian normals: Giles' erf_inv within 2 ulp of
XLA's in f32, as in tests/test_torch_lcp_spheres.py).

`rpy_spectral` holds to 1e-7 instead: both sides cast the grid to float32
before the forward FFT, as the reference does, and the two FFT libraries
round differently, so the wave part agrees to ~1e-7 of itself
(tests/test_torch_spectral.py); the velocities carry that over the steps.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from mundy_tpu.driver.apps.lcp_spheres import LCPSpheresConfig as JaxConfig
from mundy_tpu.driver.apps.lcp_spheres import LCPSpheresSim as JaxSim
from mundy_tpu_torch.driver.apps.lcp_spheres import LCPSpheresConfig, LCPSpheresSim

torch.set_num_threads(1)

KW = dict(num_spheres=150, box_size=14.0, radius=0.5, dt=2e-3, diffusion_coeff=0.02,
          dtype="float64", chunk=256, max_allowable_overlap=1e-6,
          max_col_iterations=2000, log_every=1000)
CAPACITIES = ("pair_capacity", "rows_k", "rows_slack", "seg_window", "act_window")
STEPS = 14
POS_TOL = {"rpy_neighbors": 1e-8, "rpy_ewald": 1e-8, "rpy_spectral": 1e-7}
MODES = tuple(POS_TOL)


def _counters(s):
    return (int(s.lcp_iters), int(s.act_count), int(s.act_block_max),
            int(s.rebuild_count), bool(s.overflow))


@functools.lru_cache(maxsize=None)
def _started(hydro):
    jsim = JaxSim(JaxConfig(**KW, hydro=hydro))
    js = jsim.init()
    tsim = LCPSpheresSim(LCPSpheresConfig(**KW, hydro=hydro), device="cpu")
    ts = tsim.init(pos=torch.from_numpy(np.array(js.pos)),
                   key_words=np.asarray(jax.random.key_data(js.key)))
    return jsim, js, tsim, ts


@pytest.mark.parametrize("hydro", MODES)
def test_init_matches(hydro):
    jsim, js, tsim, ts = _started(hydro)
    for name in CAPACITIES:
        assert getattr(tsim, name) == getattr(jsim, name), name
    assert _counters(ts) == _counters(js)
    assert jsim.max_overlap(js) > 0.5  # a cold start that overlaps
    np.testing.assert_array_equal(ts.pairs.i.numpy(), np.asarray(js.pairs.i))
    np.testing.assert_array_equal(ts.pairs.j.numpy(), np.asarray(js.pairs.j))
    np.testing.assert_array_equal(ts.hydro_nmat.idx.numpy(), np.asarray(js.hydro_nmat.idx))
    np.testing.assert_array_equal(ts.hydro_nmat.mask.numpy(),
                                  np.asarray(js.hydro_nmat.mask))
    if hydro == "rpy_ewald":  # the wide search, not the constraint matrix
        assert ts.hydro_nmat.idx.shape[1] == 8 * KW.get("max_neighbors", 32)
    if hydro == "rpy_spectral":
        assert (tsim.spectral.grid_n, tsim.spectral.support) == (
            jsim.spectral.grid_n, jsim.spectral.support)
        assert (tsim.se_geom.R, tsim.hydro_cells_grid.capacity) == (
            jsim.se_geom.R, jsim.hydro_cells_grid.capacity)


@pytest.mark.parametrize("hydro", MODES)
def test_trajectory_matches(hydro):
    jsim, js, tsim, ts = _started(hydro)
    for step in range(STEPS):
        js = jsim.run_block(js, 1, resize=False)
        ts = tsim.run_block(ts, 1, resize=False)
        assert _counters(ts) == _counters(js), step
        if int(js.rebuild_count) == 2 and step < 4:  # after the first skin rebuild
            np.testing.assert_array_equal(ts.hydro_nmat.idx.numpy(),
                                          np.asarray(js.hydro_nmat.idx))
    assert ts.step == int(js.step) == STEPS
    assert int(js.rebuild_count) >= 3  # two skin rebuilds inside the block
    assert min(int(js.lcp_iters), ts.lcp_iters) > 0
    np.testing.assert_allclose(ts.pos.numpy(), np.asarray(js.pos), rtol=0,
                               atol=POS_TOL[hydro])
    assert abs(tsim.max_overlap(ts) - jsim.max_overlap(js)) <= POS_TOL[hydro]
    assert tsim.max_overlap(ts) < 1e-4  # the overlaps are resolved


def test_spectral_overflow_regrows():
    """An SE tile row too small for the bodies it bins flags the state's
    overflow (the body would leave the wave sum); run() regrows the tile
    rows and the hydro cells, as the chromatin app does, and completes."""
    sim = LCPSpheresSim(LCPSpheresConfig(**dict(KW, hydro="rpy_spectral", num_steps=4)),
                        device="cpu")
    sim.se_geom = sim.se_geom._replace(R=2)
    st = sim.init()
    assert bool(sim.step(st).overflow)
    lines = []
    st = sim.run(st, log=lines.append)
    assert not bool(st.overflow) and st.step == 4
    assert sim.se_geom.R > 2 and any("regrow" in line for line in lines)


def test_rpy_neighbors_dense_start_matches_reference():
    """rpy_neighbors at the density of examples/lcp_spheres_100k.yaml (0.137
    spheres per unit^3), cut to 10k spheres in float64: from the same cold
    start both packages take the same BBPGD iterations to the same residual
    at every step. At this size and density neither resolves the start's
    overlaps (BBPGD stops with the residual far above tol), which is the
    reference's behaviour the port keeps."""
    n = 10_000
    kw = dict(num_spheres=n, box_size=(n / (100_000 / 90.0 ** 3)) ** (1 / 3), radius=0.5,
              dt=1e-3, max_allowable_overlap=1e-5, max_col_iterations=10_000,
              hydro="rpy_neighbors", dtype="float64", log_every=1000)
    jsim = JaxSim(JaxConfig(**kw))
    js = jsim.init()
    tsim = LCPSpheresSim(LCPSpheresConfig(**kw), device="cpu")
    ts = tsim.init(pos=torch.from_numpy(np.array(js.pos)),
                   key_words=np.asarray(jax.random.key_data(js.key)))
    for step in range(2):
        js = jsim.run_block(js, 1, resize=False)
        ts = tsim.run_block(ts, 1, resize=False)
        assert _counters(ts) == _counters(js), step
        np.testing.assert_allclose(float(ts.lcp_residual), float(js.lcp_residual),
                                   rtol=1e-12)
        assert float(js.lcp_residual) > 1e3 * kw["max_allowable_overlap"]
    np.testing.assert_allclose(ts.pos.numpy(), np.asarray(js.pos), rtol=0, atol=1e-8)
