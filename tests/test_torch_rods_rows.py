"""Config #3 end to end: the torch RowRodsSim vs the JAX RowRodsSim.

Both engines start from one state (the JAX init, carried across with
core/interop.py or through init(pos, quat, key_words)) and run float64 on
the CPU with translational and rotational noise (D = D_rot = 0.05), on the
config of tests/test_rods_rows.py (400 rods, box 24). Step and rebuild
counters, the overflow flag and the final slot layout must be equal;
positions and quaternions (up to sign) agree within 1e-8. The residual
comes from the Brownian normals (Giles' erf_inv within 2 ulp of XLA's) and
from the order of the contact sums.
"""

import jax
import numpy as np
import pytest
import torch

from mundy_tpu.driver.apps.rods import RodsConfig as JaxConfig
from mundy_tpu.driver.apps.rods_rows import RowRodsSim as JaxSim
from mundy_tpu_torch.core.config import config_from_dict
from mundy_tpu_torch.core.interop import row_grid_from_numpy
from mundy_tpu_torch.driver.apps.rods import RodsConfig
from mundy_tpu_torch.driver.apps.rods_rows import RowRodsSim, row_rods_state_from_numpy

torch.set_num_threads(1)

KW = dict(num_rods=400, box_size=24.0, radius=0.25, length=2.0, dt=1e-4,
          diffusion_coeff=0.05, rot_diffusion_coeff=0.05, num_steps=60,
          log_every=20, dtype="float64")


def _carry(js):
    """The JAX state as the port's, through numpy."""
    r, g = js.rows, js.rows.grid
    grid = row_grid_from_numpy(np.asarray(g.origin), np.asarray(g.cell_yz),
                               g.ny, g.nz, g.row_capacity, dtype=torch.float64)
    return row_rods_state_from_numpy(
        grid, np.asarray(r.pos), np.asarray(r.gid), np.asarray(r.valid),
        np.asarray(r.ref_pos), bool(r.overflow), np.asarray(js.quat),
        np.asarray(jax.random.key_data(js.key)), int(js.step),
        int(js.rebuild_count), bool(js.overflow))


def _assert_same(jsim, js, tsim, ts):
    assert ts.step == int(js.step)
    assert ts.rebuild_count == int(js.rebuild_count)
    assert bool(ts.overflow) == bool(js.overflow)
    assert tsim.grid.row_capacity == jsim.grid.row_capacity
    np.testing.assert_array_equal(ts.rows.gid.numpy(), np.asarray(js.rows.gid))
    np.testing.assert_array_equal(ts.rows.valid.numpy(), np.asarray(js.rows.valid))
    np.testing.assert_allclose(tsim.positions(ts).numpy(),
                               np.asarray(jsim.positions(js)), rtol=0, atol=1e-8)
    qt = tsim.quaternions(ts).numpy()
    qj = np.asarray(jsim.quaternions(js))
    # q and -q are the same rotation
    assert np.minimum(np.abs(qt - qj).max(1), np.abs(qt + qj).max(1)).max() <= 1e-8


def _sims(**over):
    kw = dict(KW, **over)
    jsim = JaxSim(JaxConfig(**kw))
    tsim = RowRodsSim(config_from_dict(RodsConfig, kw), device="cpu")
    return jsim, tsim


@pytest.mark.parametrize("n", [400, 3000])
def test_init_from_reference_state_matches(n):
    """init(pos, quat, key_words) right-sizes R to the reference's value (at
    3000 rods below the grid's) and lays out rows and quaternions as the
    reference's init did; the carried state holds the same."""
    jsim, tsim = _sims(num_rods=n)
    r_grid = tsim.grid.row_capacity
    js = jsim.init()
    ts = tsim.init(pos=torch.from_numpy(np.array(jsim.positions(js))),
                   quat=torch.from_numpy(np.array(jsim.quaternions(js))),
                   key_words=np.asarray(jax.random.key_data(js.key)))
    carried = _carry(js)
    assert (tsim.grid.ny, tsim.grid.nz) == (jsim.grid.ny, jsim.grid.nz) == (8, 8)
    assert tsim.grid.row_capacity == jsim.grid.row_capacity <= r_grid
    assert (tsim.grid.row_capacity < r_grid) == (n == 3000)
    for t in (ts, carried):
        assert t.key == carried.key and t.step == 0 and t.rebuild_count == 1
        np.testing.assert_array_equal(t.quat.numpy(), np.asarray(js.quat))
        _assert_same(jsim, js, tsim, t)


@pytest.mark.parametrize("skin", [0.3, 0.05])
def test_run_block_trajectory_matches(skin):
    """60 noisy steps in one block: skin 0.3 (the config's) rebuilds at the
    block start only, skin 0.05 also after skin triggers mid-block."""
    jsim, tsim = _sims(skin=skin)
    js = jsim.init()
    ts = _carry(js)
    tsim.grid = ts.rows.grid
    js = jsim.run_block(js, 60)
    ts = tsim.run_block(ts, 60)
    assert int(js.rebuild_count) >= (2 if skin == 0.3 else 4)
    _assert_same(jsim, js, tsim, ts)


def test_regrow_then_steps_match():
    jsim, tsim = _sims(skin=0.05)
    js = jsim.init()
    ts = _carry(js)
    tsim.grid = ts.rows.grid
    js, ts = jsim.run_block(js, 20), tsim.run_block(ts, 20)
    js, ts = jsim.regrow(js), tsim.regrow(ts)
    assert tsim.grid.row_capacity == jsim.grid.row_capacity
    _assert_same(jsim, js, tsim, ts)
    js, ts = jsim.run_block(js, 20), tsim.run_block(ts, 20)
    _assert_same(jsim, js, tsim, ts)


def test_run_from_default_init():
    """run() from the generator-seeded init: no rod lost, unit quaternions."""
    tsim = RowRodsSim(RodsConfig(**dict(KW, num_steps=30, log_every=10)), device="cpu")
    lines = []
    st = tsim.run(log=lines.append)
    assert len(lines) == 3 and st.step == 30 and not bool(st.overflow)
    assert int(st.rows.valid.sum()) == KW["num_rods"]
    assert bool(torch.isfinite(tsim.positions(st)).all())
    q = tsim.quaternions(st)
    assert (q.norm(dim=1) - 1).abs().max() <= 1e-12


@pytest.mark.parametrize("over", [dict(engine="nmat"), dict(shape="ellipsoid"),
                                  dict(friction=True),
                                  dict(box_size=13.0, engine="rows")])
def test_unported_engines_raise(over):
    """What the reference's configurator sends to the (N, K) RodsSim raises,
    naming RodsSim (the reference's row engine would run plain
    spherocylinders); a box with fewer than 5 row cells raises ValueError,
    as the reference's does."""
    match = "too small" if "box_size" in over else "RodsSim"
    with pytest.raises(ValueError, match=match):
        RowRodsSim(RodsConfig(**dict(KW, **over)), device="cpu")
