"""The periphery hydro modes end to end: the torch ChromatinSim vs the JAX
ChromatinSim with `hydro="rpy_periphery"` (all-pairs RPY + the no-slip BIE
correction) and `"rpy_periphery_spectral"` (free-space spectral Stokes on
the padded grid, G = 128, P = 10, + the same correction).

The config is the reference test's (tests/test_app_chromatin.py:
2 x 48 beads, 16 crosslinkers, periphery radius 8, order 8, float64) with
binding, a skin of 0.03 (a rebuild every 2-3 steps) and D = 0.002: the
Brownian normals (Giles' float32 erf_inv within 2 ulp of XLA's) leave
~5e-10 in the positions, which sit within 1e-9 of the reference's at every
step; the drift alone agrees to ~3e-15. Rebuild counters, overflow flags and
binding states must be equal. The port's tile gridding of the padded grid
takes the reference's rows layout's place, and its `regrow` also grows the
free-space capacities, which the reference's leaves as they are. One
reference build of the free-space operator costs ~45 s here, so each mode's
pair of sims is made once.
"""

import copy
import functools
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

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parents[1]
KW = dict(num_chains=2, beads_per_chain=48, bead_radius=0.5, num_crosslinkers=16,
          periphery_radius=8.0, periphery_order=8, diffusion_coeff=0.002, dt=2e-4,
          num_steps=20, dtype="float64", chunk=256, skin=0.03, binding_rate=50.0,
          unbinding_rate=5.0, max_neighbors=64, cell_capacity=64, log_every=10)
MODES = ("rpy_periphery", "rpy_periphery_spectral")
TOL = 1e-9


@functools.lru_cache(maxsize=None)
def _pair(mode):
    kw = dict(KW, hydro=mode)
    jsim = JaxSim(JaxConfig(**kw))
    tsim = ChromatinSim(config_from_dict(ChromatinConfig, kw), device="cpu")
    return jsim, jsim.init(), tsim, tsim.init()


def assert_same_step(js, ts, tol=TOL):
    assert ts.step == int(js.step)
    assert ts.rebuild_count == int(js.rebuild_count)
    assert bool(ts.overflow) == bool(js.overflow)
    np.testing.assert_array_equal(ts.xl_state.numpy(), np.asarray(js.xl_state))
    np.testing.assert_array_equal(ts.xl_bound_to.numpy(), np.asarray(js.xl_bound_to))
    np.testing.assert_allclose(ts.pos.numpy(), np.asarray(js.pos), rtol=0, atol=tol)


def _nm(m):
    return neighbor_matrix_from_numpy(np.asarray(m.idx), np.asarray(m.mask), bool(m.overflow))


def _carry(js, hydro_nmat: bool):
    """The JAX state as the port's; the hydro search is carried only where
    it is a search of its own (otherwise it defaults to nmat)."""
    return chromatin_state_from_numpy(
        np.asarray(js.pos), np.asarray(js.xl.indices), np.asarray(js.xl.active),
        np.asarray(js.xl_state), np.asarray(jax.random.key_data(js.key)), int(js.step),
        _nm(js.nmat), _nm(js.kmc_nmat), np.asarray(js.ref_pos), int(js.rebuild_count),
        bool(js.overflow), hydro_nmat=_nm(js.hydro_nmat) if hydro_nmat else None)


@pytest.mark.parametrize("mode", MODES)
def test_init_matches(mode):
    """Positions, capacities and searches at init are the reference's; in
    the spectral mode the free-space operator's grid and the dedicated
    hydro search too, and the tile R is right-sized from the measured
    occupancy (1.5 x + 8, as the reference sizes its rows)."""
    jsim, js, tsim, ts = _pair(mode)
    assert (tsim.contact_K, tsim.kmc_K, tsim.kmc_cell_capacity) == (
        jsim.contact_K, jsim.kmc_K, jsim.kmc_cell_capacity)
    assert tsim.periphery.m_inv.shape == (3 * 162, 3 * 162)
    np.testing.assert_array_equal(ts.pos.numpy(), np.asarray(js.pos))
    np.testing.assert_array_equal(ts.nmat.idx.numpy(), np.asarray(js.nmat.idx))
    np.testing.assert_array_equal(ts.hydro_nmat.idx.numpy(), np.asarray(js.hydro_nmat.idx))
    if mode == "rpy_periphery":
        assert tsim.freespace is None and ts.hydro_nmat is ts.nmat
    else:
        g = tsim.fs_geom
        assert (g.G, g.P, g.m) == (jsim.fs_geom.G, jsim.fs_geom.P, 8) == (128, 10, 8)
        assert (tsim.fs_hydro_search, tsim.fs_hydro_K, tsim.fs_cell_capacity) == (
            jsim.fs_hydro_search, jsim.fs_hydro_K, jsim.fs_cell_capacity)
        assert g.R == 56  # 32 beads in the fullest tile
    assert_same_step(js, ts, tol=0.0)


@pytest.mark.parametrize("mode", MODES)
def test_trajectory_matches(mode):
    """24 steps one block at a time with skin rebuilds and binding events;
    after 12 steps the JAX state continues in the port through
    chromatin_state_from_numpy, step for step with both."""
    jsim, js, tsim, ts = _pair(mode)
    carried = None
    for i in range(24):
        if i == 12:
            carried = _carry(js, mode == "rpy_periphery_spectral")
        js, ts = jsim.run_block(js, 1), tsim.run_block(ts, 1)
        assert_same_step(js, ts)
        if carried is not None:
            carried = tsim.run_block(carried, 1)
            assert_same_step(js, carried)
    assert ts.rebuild_count >= 8 and tsim.doubly_bound(ts) > 0
    assert float(ts.pos.norm(dim=1).max()) < KW["periphery_radius"]


@functools.lru_cache(maxsize=None)
def _jax_run():
    jsim = _pair("rpy_periphery_spectral")[0]
    return jsim, jsim.run(log=lambda line: None)


@pytest.mark.parametrize("capacity", ["hydro_K", "tile_R"])
def test_freespace_overflow_regrows(capacity):
    """The port's departure: a hydro search of K = 8, or a tile R of 8, set
    after init overflows in the first block; run() grows them (the
    reference's regrow leaves them, and its run stops after 8 regrows) and
    then ends where the JAX run() with room to spare ends."""
    jsim, js = _jax_run()
    tsim = copy.copy(_pair("rpy_periphery_spectral")[2])
    ts = tsim.init()
    assert not bool(ts.overflow)
    if capacity == "hydro_K":
        tsim.fs_hydro_K = 8
    else:
        tsim.fs_geom = tsim.fs_geom._replace(R=8)
    lines = []
    ts = tsim.run(ts, log=lines.append)
    assert any("in block" in line for line in lines)
    assert tsim.fs_hydro_K > 8 and tsim.fs_geom.R > 8
    assert tsim.fs_cell_capacity > jsim.fs_cell_capacity
    assert_same_step(js, ts)
    assert ts.step == KW["num_steps"] and not bool(ts.overflow)


def test_freespace_search_right_sized_at_init():
    """Where the hydro search's capacities overflow at init (cell capacity
    8 and K 8 here; HP1's chains overflow the reference's K = 96), init
    grows each to 1.5 x its measured occupancy + 8: no overflow, and the
    reference's hydro pairs, row for row in the same order."""
    jsim, js, tsim0, _ = _pair("rpy_periphery_spectral")
    tsim = copy.copy(tsim0)
    tsim.fs_hydro_K, tsim.fs_cell_capacity = 8, 8
    ts = tsim.init()
    assert not bool(ts.overflow)
    jmask = np.asarray(js.hydro_nmat.mask)
    kmax = int(jmask.sum(1).max())
    assert tsim.fs_hydro_K == ((int(kmax * 1.5) + 8 + 7) // 8) * 8 > 8
    assert tsim.fs_cell_capacity > 8
    jidx, tmask, tidx = np.asarray(js.hydro_nmat.idx), ts.hydro_nmat.mask.numpy(), ts.hydro_nmat.idx.numpy()
    for i in range(tsim.N):
        np.testing.assert_array_equal(tidx[i][tmask[i]], jidx[i][jmask[i]])
    ts, js = tsim.run_block(ts, 4), jsim.run_block(js, 4)
    assert_same_step(js, ts)


def test_hp1_yaml_and_config_errors():
    """examples/hp1_chromatin.yaml loads as written (BASELINE.md's HP1
    input: 7 x 405 beads, 512 crosslinkers, periphery radius 25, order 12);
    the periphery modes need a periphery and exclude a periodic box."""
    raw = load_yaml(str(ROOT / "examples" / "hp1_chromatin.yaml"))
    cfg = config_from_dict(ChromatinConfig, raw["params"])
    assert (cfg.hydro, cfg.num_chains * cfg.beads_per_chain, cfg.num_crosslinkers) == (
        "rpy_periphery", 2835, 512)
    assert (cfg.periphery_radius, cfg.periphery_order, cfg.dt, cfg.num_steps) == (
        25.0, 12, 5e-6, 1000)
    for hydro in MODES:
        with pytest.raises(ConfigError, match="periphery_radius"):
            config_from_dict(ChromatinConfig, dict(KW, hydro=hydro, periphery_radius=0.0))
        with pytest.raises(ConfigError, match="exclusive"):
            config_from_dict(ChromatinConfig, dict(KW, hydro=hydro, box_size=24.0))
