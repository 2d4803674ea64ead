"""The LCP line end to end: the torch LCPSpheresSim vs the JAX LCPSpheresSim.

Both start from the reference's initial positions and state key, in
float64 on the CPU: 2000 spheres in a box of 20 (volume fraction 0.13, a
cold start with overlaps up to ~0.9), constraint buffer 0.45, dt 1e-3,
D = 0.01. The cold start's push fires a skin rebuild inside the block.
init's right-sizing must make the same capacities; over 30 steps the BBPGD
iterations, active counts, rebuilds and overflow must be equal at every
step; positions and the final overlap agree within 1e-8. The residual comes
from the Brownian normals (Giles' erf_inv within 2 ulp of XLA's in f32)
and from summation order.
"""

import jax
import numpy as np
import pytest
import torch

from mundy_tpu.driver.apps.lcp_spheres import LCPSpheresConfig as JaxConfig
from mundy_tpu.driver.apps.lcp_spheres import LCPSpheresSim as JaxSim
from mundy_tpu_torch.core.config import config_from_dict
from mundy_tpu_torch.driver.apps.lcp_spheres import LCPSpheresConfig, LCPSpheresSim
from mundy_tpu_torch.parallel.comm import Group

torch.set_num_threads(1)

KW = dict(num_spheres=2000, box_size=20.0, radius=0.5, dt=1e-3, diffusion_coeff=0.01,
          constraint_buffer=0.45, num_steps=30, log_every=10, dtype="float64")
CAPACITIES = ("pair_capacity", "rows_k", "rows_slack", "seg_window", "act_window")


def _counters(s):
    return (int(s.lcp_iters), int(s.act_count), int(s.act_block_max),
            int(s.rebuild_count), bool(s.overflow))


@pytest.fixture(scope="module")
def started():
    jsim = JaxSim(JaxConfig(**KW))
    js = jsim.init()
    tsim = LCPSpheresSim(config_from_dict(LCPSpheresConfig, KW), device="cpu")
    ts = tsim.init(pos=torch.from_numpy(np.array(js.pos)),
                   key_words=np.asarray(jax.random.key_data(js.key)))
    return jsim, js, tsim, ts


def test_init_right_sizes_like_the_reference(started):
    jsim, js, tsim, ts = started
    for name in CAPACITIES:
        assert getattr(tsim, name) == getattr(jsim, name), name
    assert tsim.act_capacity == jsim.act_capacity
    assert _counters(ts) == _counters(js)
    assert jsim.max_overlap(js) > 0.5  # a cold start that overlaps
    np.testing.assert_array_equal(ts.pairs.i.numpy(), np.asarray(js.pairs.i))
    np.testing.assert_array_equal(ts.pairs.j.numpy(), np.asarray(js.pairs.j))
    np.testing.assert_array_equal(ts.dual_full.numpy(), np.asarray(js.dual_full))


def test_run_block_trajectory_matches(started):
    jsim, js, tsim, ts = started
    for step in range(30):
        js = jsim.run_block(js, 1, resize=False)
        ts = tsim.run_block(ts, 1, resize=False)
        assert _counters(ts) == _counters(js), step
    assert ts.step == int(js.step) == 30
    assert int(js.rebuild_count) >= 2  # a skin rebuild inside the block
    np.testing.assert_allclose(ts.pos.numpy(), np.asarray(js.pos), rtol=0, atol=1e-8)
    assert abs(tsim.max_overlap(ts) - jsim.max_overlap(js)) <= 1e-8
    assert tsim.max_overlap(ts) < 1e-5  # the overlaps are resolved


def test_untouched_branches_raise():
    """`rpy_ring` over more than one rank runs LCPSpheresSim over the ranks
    (tests/test_torch_ring_lcp.py) and needs the spheres to split into
    equal blocks; an uneven split is refused before any collective (one
    rank: tests/test_torch_ring_rpy.py; the other hydro modes:
    tests/test_torch_lcp_hydro.py; the polydisperse branch:
    tests/test_torch_polydisperse.py)."""
    with pytest.raises(ValueError, match="num_spheres % ranks"):
        LCPSpheresSim(LCPSpheresConfig(**dict(KW, hydro="rpy_ring", num_spheres=2001)),
                      device="cpu", group=Group(0, 2, "cpu", "gloo"))
