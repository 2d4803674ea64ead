"""The flat cell-list engine: the torch SpheresSim vs the JAX SpheresSim.

Both start from the JAX app's init state (its positions and the key words
of its state, the second half of the split of PRNGKey(seed)) and run 60
float64 steps on the CPU with at least two skin rebuilds, monodisperse and
at polydispersity 0.4 (per-sphere search radii on the periodic grid, the
packed Hertz branch, per-sphere drag and diffusion). Counters and the
neighbor matrix must be equal; positions agree within 1e-8 (the Brownian
normals' erf_inv and the force sums' rounding, as in
test_torch_spheres_rows.py).
"""

import jax
import numpy as np
import pytest
import torch

from mundy_tpu.driver.apps.spheres import SpheresConfig as JaxConfig
from mundy_tpu.driver.apps.spheres import SpheresSim as JaxSim
from mundy_tpu_torch.core.config import config_from_dict
from mundy_tpu_torch.driver.apps.spheres import SpheresConfig, SpheresSim

torch.set_num_threads(1)

KW = dict(num_spheres=500, box_size=12.0, diffusion_coeff=0.05, dt=1e-4, skin=0.1,
          num_steps=60, log_every=30, dtype="float64")


@pytest.fixture(scope="module", params=[0.0, 0.4], ids=["mono", "poly"])
def pair(request):
    """(JAX sim, its init state, its state after 60 steps, port sim)."""
    kw = dict(KW, polydispersity=request.param)
    jsim = JaxSim(JaxConfig(**kw))
    js0 = jsim.init()
    js = jsim.run_block(js0, 60)
    tsim = SpheresSim(config_from_dict(SpheresConfig, kw), device="cpu")
    return jsim, js0, js, tsim


def _start(jsim, js0, tsim):
    return tsim.init(pos=torch.from_numpy(np.array(js0.pos)),
                     key_words=np.asarray(jax.random.key_data(js0.key)))


def test_init_neighbor_matrix_matches(pair):
    jsim, js0, _, tsim = pair
    ts = _start(jsim, js0, tsim)
    assert (ts.step, ts.rebuild_count) == (0, 1)
    assert tsim.grid.dims == jsim.grid.dims
    np.testing.assert_array_equal(ts.nmat.idx.numpy(), np.asarray(js0.nmat.idx))
    np.testing.assert_array_equal(ts.nmat.mask.numpy(), np.asarray(js0.nmat.mask))
    assert bool(ts.overflow) == bool(js0.overflow) is False


def test_run_block_trajectory_matches(pair):
    jsim, js0, js, tsim = pair
    ts = tsim.run_block(_start(jsim, js0, tsim), 60)
    assert int(js.rebuild_count) >= 3  # init + block start + >= 1 skin rebuild
    assert ts.step == int(js.step) == 60
    assert ts.rebuild_count == int(js.rebuild_count)
    assert bool(ts.overflow) == bool(js.overflow) is False
    np.testing.assert_array_equal(ts.nmat.idx.numpy(), np.asarray(js.nmat.idx))
    np.testing.assert_array_equal(ts.nmat.mask.numpy(), np.asarray(js.nmat.mask))
    np.testing.assert_array_equal(ts.ref_pos.numpy() == ts.pos.numpy(),
                                  np.asarray(js.ref_pos) == np.asarray(js.pos))
    np.testing.assert_allclose(ts.pos.numpy(), np.asarray(js.pos), rtol=0, atol=1e-8)
    assert abs(tsim.max_overlap(ts) - jsim.max_overlap(js)) <= 1e-8


def test_step_matches_run_block(pair):
    """step() rebuilds when the skin fired, then steps: 6 steps of it from a
    fresh rebuild equal a 6-step block."""
    jsim, js0, _, tsim = pair
    ts = _start(jsim, js0, tsim)
    ta = tsim._rebuild(ts)
    for _ in range(6):
        ta = tsim.step(ta)
    tb = tsim.run_block(ts, 6)
    assert ta.rebuild_count == tb.rebuild_count
    assert torch.equal(ta.pos, tb.pos)


def test_regrow_grows_and_rebuilds():
    """A cell capacity too small for the box overflows at init; run()
    regrows K and the cell capacity as the reference does and finishes."""
    kw = dict(KW, cell_capacity=1, max_neighbors=4, num_steps=10, log_every=10)
    tsim = SpheresSim(config_from_dict(SpheresConfig, kw), device="cpu")
    jsim = JaxSim(JaxConfig(**kw))
    js = jsim.init()
    ts = tsim.init(pos=torch.from_numpy(np.array(js.pos)),
                   key_words=np.asarray(jax.random.key_data(js.key)))
    assert bool(ts.overflow)
    log = []
    ts = tsim.run(ts, log=log.append)
    assert any("regrow" in line for line in log) and not bool(ts.overflow)
    assert tsim.config.max_neighbors > 4 and tsim.config.cell_capacity > 1
    assert ts.step == 10


def test_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        SpheresSim(SpheresConfig(num_spheres=100, box_size=16.0))
