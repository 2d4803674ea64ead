"""Config #4's rebuild paths: the torch FilamentsSim vs the JAX one.

The float32 neighbor matrix built through the row extraction (K2's plain
version on the CPU) with the adjacency post-filter must give the
reference's neighbor ids and masks exactly, and the cell-list builder's
pair set. run() from capacities too small for the state must regrow as the
reference does, with equal log lines, capacities, rebuild counts and
layouts, and node positions and edge quaternions within 1e-8 in float64
(Brownian normals within 2 ulp of XLA's, contact sums in another order).
"""

import jax
import numpy as np
import pytest
import torch

from mundy_tpu.driver.apps.filaments import FilamentsConfig as JaxConfig
from mundy_tpu.driver.apps.filaments import FilamentsSim as JaxSim
from mundy_tpu_torch.driver.apps.filaments import FilamentsConfig, FilamentsSim
from mundy_tpu_torch.neighbor import cell_list as tc

torch.set_num_threads(1)

KW = dict(num_filaments=40, nodes_per_filament=6, segment_length=1.0, radius=0.25,
          bend_modulus=2.0, stretch_stiffness=100.0, box_size=12.0, dt=2e-4,
          num_steps=20, dtype="float64", chunk=256, log_every=10,
          diffusion_coeff=0.05, skin=0.1)


def _sims(**over):
    kw = dict(KW, **over)
    return JaxSim(JaxConfig(**kw)), FilamentsSim(FilamentsConfig(**kw), device="cpu")


def _start(jsim, tsim):
    js = jsim.init()
    ts = tsim.init(pos=torch.from_numpy(np.array(js.pos)),
                   key_words=np.asarray(jax.random.key_data(js.key)))
    return js, ts


def _assert_same(jsim, js, tsim, ts, tol=1e-8):
    assert (ts.step, ts.rebuild_count) == (int(js.step), int(js.rebuild_count))
    assert bool(ts.overflow) == bool(js.overflow)
    if tsim.contact_engine == "rows":
        assert tsim.row_grid.row_capacity == jsim.row_grid.row_capacity
        np.testing.assert_array_equal(ts.nmat.gid.numpy(), np.asarray(js.nmat.gid))
    np.testing.assert_allclose(ts.pos.numpy(), np.asarray(js.pos), rtol=0, atol=tol)
    np.testing.assert_allclose(ts.rod.edge_q.numpy(), np.asarray(js.rod.edge_q), rtol=0,
                               atol=tol)


def test_float32_nmat_build_through_rows_matches():
    """In float32 with >= 5 cells per axis the neighbor matrix comes from
    the row extraction (K2's plain version on the CPU) with the adjacency
    post-filter: the reference's ids and masks, and the cell-list builder's
    pair set; its run_block rebuilds through the same path."""
    jsim, tsim = _sims(nodes_per_filament=5, dtype="float32")
    assert int(tsim.config.box_size // (2 * tsim.search_radius)) >= 5
    js, ts = _start(jsim, tsim)
    assert tsim.rows_slack == jsim.rows_slack
    assert ts.nmat.idx.shape[1] == tsim.config.max_neighbors + 2
    np.testing.assert_array_equal(ts.nmat.idx.numpy(), np.asarray(js.nmat.idx))
    np.testing.assert_array_equal(ts.nmat.mask.numpy(), np.asarray(js.nmat.mask))
    mid = tsim._segments(ts.pos)[2]
    clist = tc.build_cell_list(mid, tsim.grid, tsim.config.cell_capacity)
    cl = tc.neighbor_matrix(mid, clist, tsim.search_radius, metric=tsim.metric,
                            max_neighbors=tsim.config.max_neighbors, chunk=256,
                            exclude=tsim.exclude)

    def pair_set(nm):
        i = np.repeat(np.arange(nm.idx.shape[0]), nm.idx.shape[1])
        m = nm.mask.numpy().ravel()
        return set(zip(i[m].tolist(), nm.idx.numpy().ravel()[m].tolist()))

    assert pair_set(ts.nmat) == pair_set(cl) and len(pair_set(cl)) > 0
    ts = tsim.run_block(ts, 10)
    assert ts.nmat.idx.shape[1] == tsim.config.max_neighbors + 2  # rebuilt the same way
    assert not bool(ts.overflow) and bool(torch.isfinite(ts.pos).all())


@pytest.mark.parametrize("engine", ["nmat", "rows"])
def test_run_regrows_like_the_reference(engine):
    """run() from capacities too small for the state: the regrow loop grows
    them as the reference does, and the trajectories agree."""
    jsim, tsim = _sims(contact_engine=engine, max_neighbors=2, cell_capacity=2)
    js, ts = _start(jsim, tsim)
    if engine == "rows":  # a row capacity below the occupancy
        small = tsim.row_grid.row_capacity // 2
        jsim.row_grid = jsim.row_grid.replace(row_capacity=small)
        tsim.row_grid = tsim.row_grid.replace(row_capacity=small)
        js, ts = jsim._rebuild(js), tsim._rebuild(ts)
    assert bool(ts.overflow) and bool(js.overflow)
    j_lines, t_lines = [], []
    js = jsim.run(js, log=j_lines.append)
    ts = tsim.run(ts, log=t_lines.append)
    assert [ln.split("tps")[0] for ln in t_lines] == [ln.split("tps")[0] for ln in j_lines]
    assert any("regrow" in ln for ln in t_lines)
    assert (tsim.config.max_neighbors, tsim.config.cell_capacity) == (
        jsim.config.max_neighbors, jsim.config.cell_capacity)
    _assert_same(jsim, js, tsim, ts)
