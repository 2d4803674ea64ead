"""The slice end to end: the torch RowSpheresSim vs the JAX RowSpheresSim.

Both engines start from one state (carried across with core/interop.py) and
run 60 float64 steps on the CPU with the skin trigger firing every ~15
steps. Counters, the overflow flag and the final slot layout must be equal;
positions agree within 1e-8. The residual comes from the Brownian normals
(Giles' erf_inv within 2 ulp of XLA's, ~5% of draws differ) and from the
force sums, which the two engines reduce in different orders (half stencil
vs the reference's 9-row stencil on the CPU).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mundy_tpu.driver.apps.spheres import SpheresConfig as JaxConfig
from mundy_tpu.driver.apps.spheres_rows import RowSpheresSim as JaxSim
from mundy_tpu.neighbor.rows import build_rows
from mundy_tpu_torch.core.config import config_from_dict
from mundy_tpu_torch.core.interop import row_grid_from_numpy
from mundy_tpu_torch.driver.apps.spheres import SpheresConfig
from mundy_tpu_torch.driver.apps.spheres_rows import RowSpheresSim, row_spheres_state_from_numpy

torch.set_num_threads(1)

KW = dict(num_spheres=2000, box_size=16.0, diffusion_coeff=0.01, dt=1e-4,
          skin=0.1, num_steps=60, log_every=20, dtype="float64")


def _carry(js):
    """The JAX state as the port's, through numpy."""
    r, g = js.rows, js.rows.grid
    grid = row_grid_from_numpy(np.asarray(g.origin), np.asarray(g.cell_yz),
                               g.ny, g.nz, g.row_capacity, dtype=torch.float64)
    return row_spheres_state_from_numpy(
        grid, np.asarray(r.pos), np.asarray(r.gid), np.asarray(r.valid),
        np.asarray(r.ref_pos), bool(r.overflow),
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


def _sims(**over):
    kw = dict(KW, **over)
    jsim = JaxSim(JaxConfig(**kw))
    tsim = RowSpheresSim(config_from_dict(SpheresConfig, kw), device="cpu")
    return jsim, tsim


def test_init_from_reference_positions_matches():
    """init(pos, key_words) right-sizes R and lays out the rows as the
    reference's init did; the carried state holds the same."""
    jsim, tsim = _sims()
    js = jsim.init()
    flat = np.array(jsim.positions(js))
    ts = tsim.init(pos=torch.from_numpy(flat),
                   key_words=np.asarray(jax.random.key_data(js.key)))
    carried = _carry(js)
    assert (tsim.grid.ny, tsim.grid.nz) == (jsim.grid.ny, jsim.grid.nz) == (8, 8)
    for t in (ts, carried):
        assert t.key == carried.key and t.step == 0 and t.rebuild_count == 1
        _assert_same(jsim, js, tsim, t)


def test_run_block_trajectory_matches():
    jsim, tsim = _sims()
    js = jsim.init()
    ts = _carry(js)
    tsim.grid = ts.rows.grid
    js = jsim.run_block(js, 60)
    ts = tsim.run_block(ts, 60)
    assert int(js.rebuild_count) >= 3  # init + block start + >= 1 skin rebuild
    _assert_same(jsim, js, tsim, ts)
    assert abs(tsim.max_overlap(ts) - jsim.max_overlap(js)) <= 1e-8


def test_run_blocks_regrow_matches():
    """R cut to the initial max occupancy: with this seed a skin rebuild in
    the first 20 steps overflows, and both engines regrow and retry the
    block from the last good state."""
    jsim, tsim = _sims(seed=1, num_steps=20)
    js = jsim.init()
    tight = int(np.asarray(js.rows.valid).sum(axis=2).max())
    jsim.grid = jsim.grid.replace(row_capacity=tight)
    js = js.replace(rows=build_rows(jsim.positions(js),
                                    jnp.arange(KW["num_spheres"], dtype=jnp.int32),
                                    jsim.grid))
    assert not bool(js.overflow)
    ts = _carry(js)
    tsim.grid = ts.rows.grid
    jlog, tlog = [], []
    js = jsim.run(js, log=jlog.append)
    ts = tsim.run(ts, log=tlog.append)
    assert any("regrow" in line for line in jlog)
    assert [line for line in tlog if "regrow" in line] == \
        [line for line in jlog if "regrow" in line]
    _assert_same(jsim, js, tsim, ts)


def test_untouched_branches_raise():
    """No branch is left unported: the small box that was refused now takes
    the pair_accumulate fallback (tests/test_torch_small_box.py holds it to
    the reference); what still raises is a card that is not there."""
    sim = RowSpheresSim(SpheresConfig(**dict(KW, box_size=5.0, skin=0.2, num_spheres=60)),
                        device="cpu")
    assert sim.small_box and (sim.grid.ny, sim.grid.nz) == (4, 4)
    st = sim.run_block(sim.init(), 2)
    assert st.step == 2 and int(st.rows.valid.sum()) == 60
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            RowSpheresSim(SpheresConfig(**KW), device="cuda")
