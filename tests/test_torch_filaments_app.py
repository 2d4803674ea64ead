"""Config #4 end to end: the torch FilamentsSim vs the JAX FilamentsSim.

Both engines start from one state (the JAX init, carried by
init(pos, key_words) or through filaments_state_from_numpy) and run
float64 on the CPU with Brownian noise (D = 0.05) and a skin small enough
to trigger rebuilds inside the blocks, on the config of
tests/test_app_filaments.py
(12 filaments of 8 nodes, box 24). Rebuild counters, overflow flags and
(row engine) slot layouts must be equal; node positions and edge
quaternions agree within 1e-8: the residual comes from the Brownian normals
(Giles' erf_inv within 2 ulp of XLA's) and from the order of the contact
sums. The float32 row-extraction build and the regrow loop are held in
test_torch_filaments_regrow.py.
"""

import pathlib

import jax
import numpy as np
import pytest
import torch

from mundy_tpu.driver.apps.filaments import FilamentsConfig as JaxConfig
from mundy_tpu.driver.apps.filaments import FilamentsSim as JaxSim
from mundy_tpu_torch.core.config import ConfigError, config_from_dict, load_yaml
from mundy_tpu_torch.core.interop import (
    neighbor_matrix_from_numpy,
    row_grid_from_numpy,
    row_state_from_numpy,
)
from mundy_tpu_torch.driver.apps.filaments import (
    FilamentsConfig,
    FilamentsSim,
    filaments_state_from_numpy,
)

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
KW = dict(num_filaments=12, nodes_per_filament=8, segment_length=1.0, radius=0.25,
          bend_modulus=2.0, stretch_stiffness=100.0, box_size=24.0, dt=2e-4,
          num_steps=40, dtype="float64", chunk=256, log_every=20,
          diffusion_coeff=0.05, skin=0.1)


def _sims(**over):
    kw = dict(KW, **over)
    return JaxSim(JaxConfig(**kw)), FilamentsSim(config_from_dict(FilamentsConfig, kw),
                                                 device="cpu")


def _start(jsim, tsim):
    js = jsim.init()
    ts = tsim.init(pos=torch.from_numpy(np.array(js.pos)),
                   key_words=np.asarray(jax.random.key_data(js.key)))
    return js, ts


def _assert_same(jsim, js, tsim, ts, tol=1e-8):
    assert ts.step == int(js.step)
    assert ts.rebuild_count == int(js.rebuild_count)
    assert bool(ts.overflow) == bool(js.overflow)
    assert tsim.contact_engine == jsim.contact_engine
    if tsim.contact_engine == "rows":
        assert tsim.row_grid.row_capacity == jsim.row_grid.row_capacity
        np.testing.assert_array_equal(ts.nmat.gid.numpy(), np.asarray(js.nmat.gid))
        np.testing.assert_array_equal(ts.nmat.valid.numpy(), np.asarray(js.nmat.valid))
    else:
        assert tsim.rows_slack == jsim.rows_slack
    np.testing.assert_allclose(ts.pos.numpy(), np.asarray(js.pos), rtol=0, atol=tol)
    np.testing.assert_allclose(ts.rod.edge_q.numpy(), np.asarray(js.rod.edge_q), rtol=0,
                               atol=tol)


def _carry(jsim, js, device="cpu"):
    """The JAX state as the port's: the contact structure through
    core/interop.py, the rest through filaments_state_from_numpy."""
    if jsim.contact_engine == "rows":
        r, g = js.nmat, js.nmat.grid
        grid = row_grid_from_numpy(np.asarray(g.origin), np.asarray(g.cell_yz), g.ny, g.nz,
                                   g.row_capacity, dtype=torch.float64)
        nmat = row_state_from_numpy(grid, np.asarray(r.pos), np.asarray(r.gid),
                                    np.asarray(r.valid), np.asarray(r.ref_pos),
                                    bool(r.overflow))
    else:
        nmat = neighbor_matrix_from_numpy(np.asarray(js.nmat.idx), np.asarray(js.nmat.mask),
                                          bool(js.nmat.overflow))
    return filaments_state_from_numpy(
        np.asarray(js.pos), np.asarray(js.rod.edge_q), np.asarray(js.rod.tangent),
        np.asarray(js.rod.length), np.asarray(jax.random.key_data(js.key)), int(js.step),
        nmat, np.asarray(js.ref_pos), int(js.rebuild_count), bool(js.overflow))


@pytest.mark.parametrize("engine,over", [("nmat", {}), ("rows", {}),
                                         ("nmat", dict(active_amplitude=0.6, wave_k=1.5,
                                                       wave_omega=30.0))],
                         ids=["nmat", "rows", "nmat-active-wave"])
def test_run_block_trajectory_matches(engine, over):
    """40 noisy steps in two blocks of 20, from the JAX init carried by
    init(pos, key_words); then a JAX state taken after 20 steps continues
    in the port through filaments_state_from_numpy."""
    jsim, tsim = _sims(contact_engine=engine, **over)
    js, ts = _start(jsim, tsim)
    assert tsim.contact_engine == engine
    _assert_same(jsim, js, tsim, ts, tol=1e-15)
    js, ts = jsim.run_block(js, 20), tsim.run_block(ts, 20)
    _assert_same(jsim, js, tsim, ts)
    carried = _carry(jsim, js)
    js = jsim.run_block(js, 20)
    ts, carried = tsim.run_block(ts, 20), tsim.run_block(carried, 20)
    assert int(js.rebuild_count) >= 4  # 1 + 2 block starts + skin triggers
    _assert_same(jsim, js, tsim, ts)
    _assert_same(jsim, js, tsim, carried)


def test_engines_agree_in_float64():
    """The row engine (K4's filaments op) and the neighbor-matrix engine
    give one trajectory to rounding on a dense box with contacts, as the
    reference holds its two engines (1e-9)."""
    kw = dict(KW, num_filaments=40, nodes_per_filament=6, box_size=12.0,
              diffusion_coeff=0.0, skin=0.3)
    sims = {e: FilamentsSim(FilamentsConfig(**dict(kw, contact_engine=e)), device="cpu")
            for e in ("nmat", "rows")}
    assert sims["rows"].contact_engine == "rows"
    pos0 = sims["nmat"].init().pos
    states = {e: s.init(pos=pos0) for e, s in sims.items()}
    f = {e: sims[e]._contact_node_forces(pos0, states[e].nmat) for e in sims}
    assert float(f["nmat"].abs().max()) > 1.0  # filaments touch
    assert float((f["nmat"] - f["rows"]).abs().max()) <= 1e-12 * float(f["nmat"].abs().max())
    out = {e: sims[e].run_block(states[e], 40) for e in sims}
    assert out["nmat"].rebuild_count >= 2 and out["rows"].rebuild_count >= 2
    assert float((out["nmat"].pos - out["rows"].pos).abs().max()) < 1e-9


def test_default_init_and_config():
    """The generator-seeded init, the sperm example's YAML, and engine
    validation."""
    raw = load_yaml(str(ROOT / "examples" / "filaments_sperm.yaml"))
    cfg = config_from_dict(FilamentsConfig, raw["params"])
    assert (cfg.num_filaments, cfg.nodes_per_filament, cfg.active_amplitude) == (128, 16, 0.5)
    sim = FilamentsSim(FilamentsConfig(**dict(KW, num_steps=10, log_every=5)), device="cpu")
    st = sim.run(log=lambda line: None)
    edges = (st.pos[:, 1:] - st.pos[:, :-1]).norm(dim=-1)
    assert st.step == 10 and not bool(st.overflow)
    assert float((edges - 1.0).abs().max()) < 0.1
    assert float((st.rod.edge_q.norm(dim=-1) - 1.0).abs().max()) < 1e-12
    with pytest.raises(ConfigError):
        config_from_dict(FilamentsConfig, dict(KW, contact_engine="dense"))
