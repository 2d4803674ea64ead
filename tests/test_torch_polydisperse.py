"""Polydisperse spheres on the port's fast paths vs the JAX reference, in
float64 on the CPU.

- The rows broad phase with per-body search radii (K2's plain version with
  its radius plane) equals JAX's neighbor_matrix_rows bit for bit (ids,
  mask, overflow) and finds the brute-force pair set (cutoff s_i + s_j).
- RowSpheresSim with polydispersity 0.4 (500 spheres, box 14; the
  reference's tests/test_polydisperse.py size): from the reference's
  initial positions and key, 60 steps through K6's plain version with the
  radius plane. Equal rebuilds, overflow and slot layout. Without noise
  the positions agree within 1e-12 (summation order only); with D = 0.05
  within 1e-8, the bar of test_torch_spheres_rows: the port's f32 erf_inv
  lies within 2 ulp of XLA's, and ~5% of the normals differ by an ulp.
- A sphere that crossed a periodic y face since the last rebuild (its slot
  in its old row, its position wrapped) and touches a sphere across it,
  one RowSpheresSim step: the reference's row engine misses the contact
  (pre-shifted rows, x-only minimum image). The port's monodisperse branch
  (K1's path) keeps that and matches the reference; the polydisperse
  branch (K6's path) takes the minimum image on every axis, finds the
  contact and departs from the reference by exactly the Hertz step of
  that pair (ROADMAP queue 3 records the decision).
- LCPSpheresSim with polydispersity 0.5 (400 spheres, box 18): equal init
  right-sizing, and at every one of 30 steps equal BBPGD iterations, active
  counts and rebuilds; positions within 1e-8.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mundy_tpu.driver.apps.lcp_spheres import LCPSpheresConfig as JaxLCPConfig
from mundy_tpu.driver.apps.lcp_spheres import LCPSpheresSim as JaxLCPSim
from mundy_tpu.driver.apps.spheres import SpheresConfig as JaxConfig
from mundy_tpu.driver.apps.spheres_rows import RowSpheresSim as JaxRowSim
from mundy_tpu.driver.apps.spheres_rows import RowSpheresState as JaxRowState
from mundy_tpu.neighbor import rows as jrows
from mundy_tpu_torch.core.config import config_from_dict
from mundy_tpu_torch.driver.apps.lcp_spheres import LCPSpheresConfig, LCPSpheresSim
from mundy_tpu_torch.driver.apps.spheres import SpheresConfig
from mundy_tpu_torch.driver.apps.spheres_rows import (RowSpheresSim,
                                                      row_spheres_state_from_numpy)
from mundy_tpu_torch.neighbor import rows as trows

torch.set_num_threads(1)

ROWS_KW = dict(num_spheres=500, box_size=14.0, radius=0.5, polydispersity=0.4,
               dt=1e-4, num_steps=60, dtype="float64", log_every=1000)
LCP_KW = dict(num_spheres=400, box_size=18.0, radius=0.5, polydispersity=0.5,
              dt=1e-3, diffusion_coeff=0.01, num_steps=30, dtype="float64",
              log_every=1000)


@pytest.mark.parametrize("n,box,K", [(600, 16.0, 16), (1000, 16.0, 6)])
def test_rows_broad_phase_search_radii_matches(n, box, K):
    """The second case's K = 6 truncates: ids and overflow still equal."""
    rng = np.random.default_rng(12345)
    p = rng.uniform(0, box, (n, 3))
    sr = rng.uniform(0.3, 0.9, n)
    ref = jrows.neighbor_matrix_rows(jnp.asarray(p), 0.9, (box,) * 3, max_neighbors=K,
                                     search_radii=jnp.asarray(sr))
    got = trows.neighbor_matrix_rows(torch.from_numpy(p), 0.9, (box,) * 3,
                                     max_neighbors=K, search_radii=torch.from_numpy(sr))
    np.testing.assert_array_equal(got.idx.numpy(), np.asarray(ref.idx))
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(ref.mask))
    assert bool(got.overflow) == bool(ref.overflow) == (K == 6)
    if K == 6:
        return
    d = p[:, None, :] - p[None, :, :]
    d -= box * np.round(d / box)
    dist = np.sqrt((d ** 2).sum(-1))
    want = (dist < sr[:, None] + sr[None, :]) & ~np.eye(n, dtype=bool)
    idx, mask = got.idx.numpy(), got.mask.numpy()
    for i in range(n):
        assert set(idx[i][mask[i]].tolist()) == set(np.nonzero(want[i])[0].tolist()), i


@pytest.mark.parametrize("diffusion,atol", [(0.0, 1e-12), (0.05, 1e-8)])
def test_row_spheres_polydisperse_matches(diffusion, atol):
    kw = dict(ROWS_KW, diffusion_coeff=diffusion)
    jsim = JaxRowSim(JaxConfig(**kw))
    tsim = RowSpheresSim(config_from_dict(SpheresConfig, kw), device="cpu")
    np.testing.assert_array_equal(tsim.radii.numpy(), np.asarray(jsim.radii))
    assert tsim.cutoff == jsim.cutoff
    js = jsim.init()
    ts = tsim.init(pos=torch.from_numpy(np.array(jsim.positions(js))),
                   key_words=np.asarray(jax.random.key_data(js.key)))
    assert (tsim.grid.ny, tsim.grid.nz, tsim.grid.row_capacity) == \
        (jsim.grid.ny, jsim.grid.nz, jsim.grid.row_capacity)
    js = jsim.run_block(js, 60)
    ts = tsim.run_block(ts, 60)
    assert ts.rebuild_count == int(js.rebuild_count) >= 3
    assert bool(ts.overflow) == bool(js.overflow) is False
    np.testing.assert_array_equal(ts.rows.gid.numpy(), np.asarray(js.rows.gid))
    np.testing.assert_array_equal(ts.rows.valid.numpy(), np.asarray(js.rows.valid))
    np.testing.assert_allclose(tsim.positions(ts).numpy(), np.asarray(jsim.positions(js)),
                               rtol=0, atol=atol)
    # the deepest overlap with each sphere's own radius, as brute force finds it
    p, r = tsim.positions(ts).numpy(), tsim.radii.numpy()
    d = p[:, None, :] - p[None, :, :]
    d -= 14.0 * np.round(d / 14.0)
    ov = r[:, None] + r[None, :] - np.sqrt((d ** 2).sum(-1))
    np.fill_diagonal(ov, -np.inf)
    assert tsim.max_overlap(ts) == pytest.approx(ov.max(), abs=1e-12)


@pytest.mark.parametrize("polydispersity", [0.0, 0.4])
def test_row_spheres_face_crossed_since_the_rebuild(polydispersity):
    kw = dict(num_spheres=2, box_size=12.0, radius=0.5, polydispersity=polydispersity,
              diffusion_coeff=0.0, dt=1e-3, dtype="float64")
    jsim = JaxRowSim(JaxConfig(**kw))
    tsim = RowSpheresSim(config_from_dict(SpheresConfig, kw), device="cpu")
    assert (tsim.grid.ny, tsim.grid.nz, tsim.grid.row_capacity) == \
        (jsim.grid.ny, jsim.grid.nz, jsim.grid.row_capacity)
    # the rebuild puts sphere 0 (y = 0.05) in row 0 and sphere 1 (y = 11.75)
    # in the last row; then sphere 0 crosses y = 0 and wraps to y = 11.95,
    # 0.2 from sphere 1, with no rebuild (0.1 < skin / 2)
    rows = jrows.build_rows(jnp.asarray([[6.0, 0.05, 6.0], [6.0, 11.75, 6.0]]),
                            jnp.arange(2, dtype=jnp.int32), jsim.grid)
    moved = jnp.where((rows.gid == 0) & rows.valid, 11.95, rows.pos[..., 1])
    rows = rows.replace(pos=rows.pos.at[..., 1].set(moved))
    js = JaxRowState(rows=rows, key=jax.random.PRNGKey(0), step=jnp.asarray(0, jnp.int32),
                     rebuild_count=jnp.asarray(1, jnp.int32), overflow=rows.overflow)
    ts = row_spheres_state_from_numpy(
        tsim.grid, *(np.asarray(a) for a in (rows.pos, rows.gid, rows.valid, rows.ref_pos,
                                             rows.overflow)),
        jax.random.key_data(js.key), 0, 1, False)
    assert not tsim._skin_fired(ts)
    before = tsim.positions(ts).numpy()
    want = np.asarray(jsim.positions(jsim._inner_step(js)))
    got = tsim.positions(tsim._inner_step(ts)).numpy()
    # the reference misses the pair: nothing moves
    np.testing.assert_array_equal(want, before)
    if polydispersity == 0:  # K1's path: the reference's behaviour
        np.testing.assert_array_equal(got, want)
        return
    # K6's path: the pair's Hertz push, each sphere with its own drag
    r = tsim.radii.numpy()
    s, d = r[0] + r[1], 0.2
    e_eff = 1000.0 / (2.0 * (1.0 - 0.3 ** 2))
    mag = (4.0 / 3.0) * e_eff * np.sqrt(r[0] * r[1] / s) * (s - d) ** 1.5
    step = 1e-3 * mag / (6.0 * np.pi * r)
    np.testing.assert_allclose(got[:, 1] - before[:, 1], [step[0], -step[1]], rtol=1e-9)
    np.testing.assert_array_equal(got[:, [0, 2]], before[:, [0, 2]])


def test_lcp_polydisperse_matches():
    jsim = JaxLCPSim(JaxLCPConfig(**LCP_KW))
    js = jsim.init()
    tsim = LCPSpheresSim(config_from_dict(LCPSpheresConfig, LCP_KW), device="cpu")
    ts = tsim.init(pos=torch.from_numpy(np.array(js.pos)),
                   key_words=np.asarray(jax.random.key_data(js.key)))
    np.testing.assert_array_equal(tsim.radii.numpy(), np.asarray(jsim.radii))
    assert tsim.search_radius == jsim.search_radius
    for name in ("pair_capacity", "rows_k", "rows_slack", "seg_window", "act_window"):
        assert getattr(tsim, name) == getattr(jsim, name), name
    assert tsim._n_cells() >= 5  # the rows broad phase with search radii
    np.testing.assert_array_equal(ts.pairs.i.numpy(), np.asarray(js.pairs.i))
    np.testing.assert_array_equal(ts.pairs.j.numpy(), np.asarray(js.pairs.j))
    assert tsim.max_overlap(ts) == pytest.approx(jsim.max_overlap(js), abs=1e-12)
    assert jsim.max_overlap(js) > 0.1  # a cold start that overlaps
    for step in range(30):
        js = jsim.run_block(js, 1, resize=False)
        ts = tsim.run_block(ts, 1, resize=False)
        got = (ts.lcp_iters, int(ts.act_count), ts.rebuild_count, bool(ts.overflow))
        want = (int(js.lcp_iters), int(js.act_count), int(js.rebuild_count),
                bool(js.overflow))
        assert got == want, step
    assert int(js.rebuild_count) >= 2
    np.testing.assert_allclose(ts.pos.numpy(), np.asarray(js.pos), rtol=0, atol=1e-8)
    assert tsim.max_overlap(ts) < 1e-4
