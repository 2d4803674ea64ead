"""The (N, K) rods engine end to end: the torch RodsSim vs the JAX RodsSim,
float64 on the CPU, with translational and rotational noise (D = D_rot =
0.05).

Both engines start from the JAX init's state (init(pos, quat, key_words))
and run a block with skin rebuilds, a regrow (K 16 -> 32, and the cell and
row capacities) and a second block, for each narrow phase that runs on
the segment: the frictionless one on the row broad phase, friction (its
per-slot history remapped by pair identity at every rebuild and regrow),
and a box with fewer than 5 row cells per axis (the cell-list broad phase).
Rebuild counts, neighbor ids, masks and overflow flags must be equal; the
positions, quaternions and the tangential history agree within 1e-10: the
residual is the noise's normals (within 64 ulp of XLA's,
tests/test_torch_brownian.py) and the order of the per-row sums. The
ellipsoid narrow phase is in tests/test_torch_rods_ellipsoid.py.
"""

import jax
import numpy as np
import pytest
import torch

from mundy_tpu.driver.apps.rods import RodsConfig as JaxConfig
from mundy_tpu.driver.apps.rods import RodsSim as JaxSim
from mundy_tpu_torch.driver.apps.rods import RodsConfig, RodsSim

torch.set_num_threads(2)

KW = dict(num_rods=200, box_size=14.0, diffusion_coeff=0.05, rot_diffusion_coeff=0.05,
          dt=1e-3, skin=0.1, max_neighbors=16, dtype="float64")
CASES = {
    "segment": dict(engine="nmat"),
    "friction": dict(friction=True),
    "small_box": dict(box_size=13.0),
}


def _same(js, ts, tol=1e-10):
    assert ts.step == int(js.step)
    assert ts.rebuild_count == int(js.rebuild_count)
    np.testing.assert_array_equal(ts.nmat.idx.numpy(), np.asarray(js.nmat.idx))
    np.testing.assert_array_equal(ts.nmat.mask.numpy(), np.asarray(js.nmat.mask))
    assert bool(ts.overflow) == bool(js.overflow)
    for name in ("pos", "quat", "tang", "prev_vel", "prev_omega"):
        np.testing.assert_allclose(getattr(ts, name).numpy(), np.asarray(getattr(js, name)),
                                   rtol=0, atol=tol, err_msg=name)


@pytest.mark.parametrize("case", sorted(CASES))
def test_rods_sim_matches_reference(case):
    kw = dict(KW, **CASES[case])
    jsim = JaxSim(JaxConfig(**kw))
    tsim = RodsSim(RodsConfig(**kw), device="cpu")
    assert tsim.broad_phase() == ("cells" if case == "small_box" else "rows")
    js = jsim.init()
    ts = tsim.init(pos=np.array(js.pos), quat=np.array(js.quat),
                   key_words=np.asarray(jax.random.key_data(js.key)))
    _same(js, ts)
    js, ts = jsim.run_block(js, 20), tsim.run_block(ts, 20)
    assert ts.rebuild_count >= 4
    _same(js, ts)
    js, ts = jsim.regrow(js), tsim.regrow(ts)
    assert tsim.config.max_neighbors == jsim.config.max_neighbors == 32
    _same(js, ts)
    js, ts = jsim.run_block(js, 10), tsim.run_block(ts, 10)
    _same(js, ts)
    if case == "friction":
        assert float(ts.tang.abs().max()) > 0  # contacts carried a history
    assert tsim.max_overlap(ts) == pytest.approx(jsim.max_overlap(js), abs=1e-10)


def test_run_logs_and_stays_finite():
    """run(): the block loop with its status lines, from the default init
    (a torch.Generator from the seed), float32."""
    cfg = RodsConfig(**dict(KW, engine="nmat", dtype="float32", num_steps=12, log_every=4))
    lines = []
    st = RodsSim(cfg, device="cpu").run(log=lines.append)
    assert st.step == 12 and len(lines) == 3 and lines[-1].startswith("step 12/12")
    assert bool(torch.isfinite(st.pos).all()) and not bool(st.overflow)
    np.testing.assert_allclose(st.quat.norm(dim=1).numpy(), 1.0, atol=1e-5)
