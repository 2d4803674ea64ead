"""Config #5's cheaper modes end to end: the torch ChromatinSim vs the JAX
ChromatinSim with local drag in free space inside the spherical periphery
wall (`hydro="none"`) and with neighbor RPY in a periodic box
(`"rpy_neighbors"`), the state carried from JAX into the port, the regrow
loop of `run()`, and the example YAML.

The config is test_torch_chromatin_app.py's (2 chains x 64 beads, 16
crosslinkers, float64, D = 0.05, skin 0.1); rebuild counters, overflow
flags and binding states must be equal at every step, positions within
1e-8 (the Brownian normals' erf_inv and the order of the sums).
"""

import pathlib

import jax
import numpy as np
import pytest
import torch

from mundy_tpu.driver.apps.chromatin import ChromatinConfig as JaxConfig
from mundy_tpu.driver.apps.chromatin import ChromatinSim as JaxSim
from mundy_tpu_torch.core.config import ConfigError, config_from_dict, load_yaml
from mundy_tpu_torch.core.interop import neighbor_matrix_from_numpy
from mundy_tpu_torch.driver.apps.chromatin import (
    ChromatinConfig,
    ChromatinSim,
    chromatin_state_from_numpy,
)

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
KW = dict(num_chains=2, beads_per_chain=64, bead_radius=0.5, num_crosslinkers=16,
          diffusion_coeff=0.05, dt=2e-4, num_steps=40, dtype="float64", chunk=256,
          skin=0.1, binding_rate=50.0, unbinding_rate=5.0, log_every=10)
MODES = {"none": dict(hydro="none", periphery_radius=12.0),
         "rpy_neighbors": dict(hydro="rpy_neighbors", box_size=24.0)}


def assert_same_step(js, ts, tol=1e-8):
    assert ts.step == int(js.step)
    assert ts.rebuild_count == int(js.rebuild_count)
    assert bool(ts.overflow) == bool(js.overflow)
    np.testing.assert_array_equal(ts.xl_state.numpy(), np.asarray(js.xl_state))
    np.testing.assert_array_equal(ts.xl_bound_to.numpy(), np.asarray(js.xl_bound_to))
    np.testing.assert_allclose(ts.pos.numpy(), np.asarray(js.pos), rtol=0, atol=tol)


def _sims(**over):
    kw = dict(KW, **over)
    return JaxSim(JaxConfig(**kw)), ChromatinSim(config_from_dict(ChromatinConfig, kw),
                                                 device="cpu")


def _carry(js):
    """The JAX state as the port's, through chromatin_state_from_numpy."""
    def nm(m):
        return neighbor_matrix_from_numpy(np.asarray(m.idx), np.asarray(m.mask),
                                          bool(m.overflow))

    return chromatin_state_from_numpy(
        np.asarray(js.pos), np.asarray(js.xl.indices), np.asarray(js.xl.active),
        np.asarray(js.xl_state), np.asarray(jax.random.key_data(js.key)), int(js.step),
        nm(js.nmat), nm(js.kmc_nmat), np.asarray(js.ref_pos), int(js.rebuild_count),
        bool(js.overflow))


@pytest.mark.parametrize("mode", list(MODES))
def test_trajectory_matches(mode):
    """40 steps one block at a time, with skin rebuilds and binding events;
    after 20 steps the JAX state continues in the port through
    chromatin_state_from_numpy, step for step with both."""
    jsim, tsim = _sims(**MODES[mode])
    js, ts = jsim.init(), tsim.init()
    assert (tsim.contact_K, tsim.kmc_K, tsim.kmc_cell_capacity) == (
        jsim.contact_K, jsim.kmc_K, jsim.kmc_cell_capacity)
    assert tsim.broad_phase() == ("cell_list" if mode == "none" else "rows")
    assert_same_step(js, ts, tol=0.0)
    carried = None
    for i in range(40):
        if i == 20:
            carried = _carry(js)
        js, ts = jsim.run_block(js, 1), tsim.run_block(ts, 1)
        assert_same_step(js, ts)
        if carried is not None:
            carried = tsim.run_block(carried, 1)
            assert_same_step(js, carried)
    assert ts.rebuild_count >= 4 and tsim.doubly_bound(ts) > 0
    if mode == "none":  # the wall holds every bead inside the periphery
        assert float(ts.pos.norm(dim=1).max()) < 12.0


def test_run_regrows_as_the_reference():
    """A contact cell capacity of 2 overflows at init: run() regrows (every
    capacity grows, as the reference's regrow grows them) and then runs
    its blocks, ending where the JAX run() ends."""
    jsim, tsim = _sims(hydro="none", periphery_radius=12.0, cell_capacity=2, num_steps=20)
    lines = []
    js = jsim.run(log=lambda line: None)
    ts = tsim.run(log=lines.append)
    assert any("regrow" in line for line in lines)
    assert tsim.cell_capacity > 2
    assert (tsim.cell_capacity, tsim.contact_K, tsim.kmc_K, tsim.kmc_cell_capacity) == (
        jsim.cell_capacity, jsim.contact_K, jsim.kmc_K, jsim.kmc_cell_capacity)
    assert_same_step(js, ts)
    assert ts.step == 20 and not bool(ts.overflow)


def test_example_yaml_and_config_errors():
    """examples/chromatin_1m_spectral.yaml loads as written; bad modes are
    refused by the config, the unported ones by the sim."""
    raw = load_yaml(str(ROOT / "examples" / "chromatin_1m_spectral.yaml"))
    assert raw["app"] == "chromatin"
    cfg = config_from_dict(ChromatinConfig, raw["params"])
    assert (cfg.num_chains, cfg.beads_per_chain, cfg.num_crosslinkers) == (2048, 512, 65536)
    assert (cfg.hydro, cfg.box_size, cfg.dtype) == ("rpy_spectral", 152.0, "float32")
    with pytest.raises(ConfigError, match="hydro"):
        config_from_dict(ChromatinConfig, dict(KW, hydro="fmm"))
    with pytest.raises(ConfigError, match="box_size"):
        config_from_dict(ChromatinConfig, dict(KW, hydro="rpy_spectral"))
    with pytest.raises(ConfigError, match="exclusive"):
        config_from_dict(ChromatinConfig, dict(KW, box_size=24.0, periphery_radius=8.0))
