"""The LCP line's other paths vs the JAX reference (float64, CPU): the
cell-list broad phase of a box with fewer than 5 cells per axis, and
`run()` with capacities that overflow and regrow.

Same contract as tests/test_torch_lcp_spheres.py: equal capacities and
counters at every step, positions within 1e-8, and equal regrow log lines.
"""

import jax
import numpy as np
import torch

from mundy_tpu.driver.apps.lcp_spheres import LCPSpheresConfig as JaxConfig
from mundy_tpu.driver.apps.lcp_spheres import LCPSpheresSim as JaxSim
from mundy_tpu_torch.driver.apps.lcp_spheres import LCPSpheresConfig, LCPSpheresSim

torch.set_num_threads(1)

BASE = dict(radius=0.5, dt=1e-3, diffusion_coeff=0.01, constraint_buffer=0.45,
            dtype="float64")


def _counters(s):
    return (int(s.lcp_iters), int(s.act_count), int(s.act_block_max),
            int(s.rebuild_count), bool(s.overflow))


def _pair(**kw):
    kw = dict(BASE, **kw)
    jsim = JaxSim(JaxConfig(**kw))
    js = jsim.init()
    tsim = LCPSpheresSim(LCPSpheresConfig(**kw), device="cpu")
    ts = tsim.init(pos=torch.from_numpy(np.array(js.pos)),
                   key_words=np.asarray(jax.random.key_data(js.key)))
    return jsim, js, tsim, ts


def test_cell_list_path_matches():
    """Box 7: 4 cells per axis, below the rows engine's 5."""
    jsim, js, tsim, ts = _pair(num_spheres=120, box_size=7.0, num_steps=20)
    assert tsim._n_cells() == 4
    assert (tsim.pair_capacity, tsim.seg_window, tsim.act_window) == \
        (jsim.pair_capacity, jsim.seg_window, jsim.act_window)
    for step in range(20):
        js = jsim.run_block(js, 1, resize=False)
        ts = tsim.run_block(ts, 1, resize=False)
        assert _counters(ts) == _counters(js), step
    assert int(js.rebuild_count) >= 2
    np.testing.assert_allclose(ts.pos.numpy(), np.asarray(js.pos), rtol=0, atol=1e-8)


def test_run_regrows_like_the_reference():
    """max_neighbors = 6 truncates the cold start's neighbor rows: both
    engines log the same regrow, grow the same capacities and then run two
    blocks with the between-block refits."""
    jsim, js, tsim, ts = _pair(num_spheres=1000, box_size=16.0, num_steps=10,
                               log_every=5, max_neighbors=6)
    assert bool(js.overflow) and bool(ts.overflow)
    jlog, tlog = [], []
    js = jsim.run(js, log=jlog.append)
    ts = tsim.run(ts, log=tlog.append)
    regrow = [line for line in jlog if "regrow" in line]
    assert regrow and [line for line in tlog if "regrow" in line] == regrow
    for name in ("pair_capacity", "rows_k", "rows_slack", "seg_window", "act_window"):
        assert getattr(tsim, name) == getattr(jsim, name), name
    assert tsim.config.max_neighbors == jsim.config.max_neighbors > 6
    assert _counters(ts) == _counters(js)
    np.testing.assert_allclose(ts.pos.numpy(), np.asarray(js.pos), rtol=0, atol=1e-8)
