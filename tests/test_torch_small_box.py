"""Small boxes: the general row pair engine (pair_accumulate,
pair_accumulate_multi) and the small-box branch of RowSpheresSim against
the JAX package, in float64 on the CPU.

- pair_accumulate and pair_accumulate_multi agree with the reference's
  within 1e-12 of the max on the fast (`box`) and general (full minimum
  image) paths, with a scalar extra field and, for the multi-output form,
  a vector one; a byte budget that forces >= 3 y-chunks gives a result
  bit-equal to one chunk.
- RowSpheresSim at ny = nz = 3 and 4 (ny or nz < 5 takes the fallback)
  runs 40 steps with rebuilds as the JAX app does: equal rebuilds and
  overflow, positions within 1e-10. The overlaps of the random start drive
  the motion: without Brownian noise, whose normals differ between the
  packages by up to 2 ulp (tests/test_torch_spheres_rows.py), ~2e-9 after
  40 steps here.
- The two decisions of the port (ROADMAP queue 3), each against an
  all-pairs minimum-image Hertz sum over the flat positions: at ny = 2 the
  reference counts every pair in a neighbouring row twice or four times
  (its nine rolls reach that row more than once) and the port once; with
  polydisperse radii the reference's pair_fn takes the scalar radius and
  the port each sphere's own. At ny = 3 and 4 both packages match the sum.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mundy_tpu.driver.apps.spheres import SpheresConfig as JaxConfig
from mundy_tpu.driver.apps.spheres_rows import RowSpheresSim as JaxSim
from mundy_tpu.forces.contact import effective_youngs as j_eff
from mundy_tpu.geom import periodic as jperiodic
from mundy_tpu.neighbor import rows as jrows
from mundy_tpu_torch.core.config import config_from_dict
from mundy_tpu_torch.driver.apps.spheres import SpheresConfig
from mundy_tpu_torch.driver.apps.spheres_rows import RowSpheresSim
from mundy_tpu_torch.geom.periodicity import periodic as tperiodic
from mundy_tpu_torch.neighbor import rows as trows

torch.set_num_threads(1)
TOL = 1e-12
E_EFF = float(j_eff(1e3, 1e3, 0.3, 0.3))  # the config's defaults


def _close(got, ref, tol=TOL):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= tol * max(np.abs(ref).max(), 1e-300)


def _hertz(np_like, sqrt, rsqrt, where, radius=0.5):
    """The Hertz pair_fn of the reference's small-box branch, for jnp or torch."""
    def pair_fn(sep, r2, mask):
        r2 = np_like.maximum(r2, 1e-24) if np_like is jnp else torch.clamp(r2, min=1e-24)
        rinv = rsqrt(r2)
        d = r2 * rinv
        delta = -(d - 2 * radius)
        delta = np_like.maximum(delta, 0.0) if np_like is jnp else torch.clamp(delta, min=0.0)
        mag = (4.0 / 3.0) * E_EFF * np.sqrt(0.5 * radius) * delta * sqrt(delta)
        return -where(mask, mag * rinv, 0.0)[..., None] * sep
    return pair_fn


J_HERTZ = _hertz(jnp, jnp.sqrt, jax.lax.rsqrt, jnp.where)
T_HERTZ = _hertz(torch, torch.sqrt, torch.rsqrt, torch.where)


def _rows(n, box, cutoff, seed=0, slack=3.0):
    pos = np.random.default_rng(seed).uniform(0, box, (n, 3))
    jgrid = jrows.make_row_grid([0, 0, 0], [box] * 3, cutoff, n, capacity_slack=slack,
                                dtype=jnp.float64)
    tgrid = trows.make_row_grid([0, 0, 0], [box] * 3, cutoff, n, capacity_slack=slack,
                                dtype=torch.float64)
    js = jrows.build_rows(jnp.asarray(pos), jnp.arange(n, dtype=jnp.int32), jgrid)
    ts = trows.build_rows(torch.as_tensor(pos), torch.arange(n, dtype=torch.int32), tgrid)
    np.testing.assert_array_equal(ts.gid.numpy(), np.asarray(js.gid))
    return pos, js, ts


def _metrics(box):
    return (jperiodic([box] * 3, dtype=jnp.float64),
            tperiodic([box] * 3, dtype=torch.float64))


@pytest.mark.parametrize("box,path", [(9.0, "fast"), (9.0, "general"), (5.0, "small")])
def test_pair_accumulate_matches(box, path):
    """Hertz forces with a radius-scaled extra field on both paths; the
    small box (3 x 3 rows) falls back to the general path even with `box`."""
    n = 260 if box > 6 else 90
    pos, js, ts = _rows(n, box, 1.25, seed=1)
    jm, tm = _metrics(box)
    jbox = trows.orthorhombic_lengths(tm) if path != "general" else None
    assert (ts.grid.ny >= 5) == (path != "small")
    rng = np.random.default_rng(2)
    scale = rng.uniform(0.5, 1.5, ts.valid.shape)

    def with_field(fn):
        def g(sep, r2, mask, so, sc):
            return fn(sep, r2, mask) * (so * sc)[..., None]
        return g

    want = jrows.pair_accumulate(js, jm, with_field(J_HERTZ),
                                 extra_fields=(jnp.asarray(scale),), box=jbox)
    got = trows.pair_accumulate(ts, tm, with_field(T_HERTZ),
                                extra_fields=(torch.as_tensor(scale),), box=jbox)
    assert np.abs(np.asarray(want)).max() > 0
    _close(got.numpy(), want)


def test_pair_accumulate_chunks_bit_equal():
    """A budget of a few rows a chunk (>= 3 chunks) against one chunk."""
    pos, js, ts = _rows(260, 9.0, 1.25, seed=3)
    _jm, tm = _metrics(9.0)
    box = trows.orthorhombic_lengths(tm)
    one = trows.pair_accumulate(ts, tm, T_HERTZ, box=box)
    per_row = trows.PAIR_PLANES * ts.grid.nz * ts.grid.row_capacity ** 2 * 8
    budget = 2.5 * per_row
    cy = trows.pair_chunk_rows(ts, budget)
    assert cy == 2 and -(-ts.grid.ny // cy) >= 3
    assert trows.pair_chunk_rows(ts) == ts.grid.ny
    for b in (budget, per_row):  # 2 rows, then 1 row a chunk
        assert torch.equal(trows.pair_accumulate(ts, tm, T_HERTZ, box=box,
                                                 hbm_budget_bytes=b), one)
    multi = trows.pair_accumulate_multi(ts, tm, lambda *a: (T_HERTZ(*a),), box=box,
                                        hbm_budget_bytes=budget)
    assert torch.equal(multi[0], one)


@pytest.mark.parametrize("box,use_box", [(9.0, True), (5.0, True), (9.0, False)])
def test_pair_accumulate_multi_matches(box, use_box):
    """A two-output pair_fn (force and a torque-like cross product with a
    vector field, plus a scalar field) against the reference."""
    n = 240 if box > 6 else 90
    pos, js, ts = _rows(n, box, 1.25, seed=4)
    jm, tm = _metrics(box)
    bx = trows.orthorhombic_lengths(tm) if use_box else None
    rng = np.random.default_rng(5)
    axis = rng.normal(size=ts.valid.shape + (3,))
    s = rng.uniform(0.5, 1.5, ts.valid.shape)

    def two(hertz, cross):
        def fn(sep, r2, mask, ao, ac, so, sc):
            f = hertz(sep, r2, mask) * (so * sc)[..., None]
            return f, cross(ao + ac, f)
        return fn

    want = jrows.pair_accumulate_multi(
        js, jm, two(J_HERTZ, lambda a, b: jnp.cross(a, b)),
        extra_fields=(jnp.asarray(axis), jnp.asarray(s)), box=bx)
    got = trows.pair_accumulate_multi(
        ts, tm, two(T_HERTZ, lambda a, b: torch.linalg.cross(a, b, dim=-1)),
        extra_fields=(torch.as_tensor(axis), torch.as_tensor(s)), box=bx)
    assert len(got) == 2 and got[1].shape == ts.pos.shape
    for g, w in zip(got, want):
        assert np.abs(np.asarray(w)).max() > 0
        _close(g.numpy(), w)


KW = dict(diffusion_coeff=0.05, dt=1e-4, skin=0.25, log_every=20, dtype="float64")
# the trajectory runs: a thinner skin, so the start's overlaps alone trigger
# rebuilds; cutoff 1.1 gives 3 rows in a 4.0 box and 4 in a 5.0 one


@pytest.mark.parametrize("box,n,ny", [(4.0, 45, 3), (5.0, 80, 4)])
def test_row_spheres_small_box_trajectory(box, n, ny):
    kw = dict(KW, num_spheres=n, box_size=box, num_steps=40, diffusion_coeff=0.0, skin=0.1)
    jsim = JaxSim(JaxConfig(**kw))
    tsim = RowSpheresSim(config_from_dict(SpheresConfig, kw), device="cpu")
    assert (tsim.grid.ny, tsim.grid.nz) == (jsim.grid.ny, jsim.grid.nz) == (ny, ny)
    assert tsim.small_box
    js = jsim.init()
    ts = tsim.init(pos=torch.as_tensor(np.array(jsim.positions(js))),
                   key_words=np.asarray(jax.random.key_data(js.key)))
    assert tsim.grid.row_capacity == jsim.grid.row_capacity
    js = jsim.run_block(js, 40)
    ts = tsim.run_block(ts, 40)
    assert ts.rebuild_count == int(js.rebuild_count) >= 3
    assert bool(ts.overflow) == bool(js.overflow) is False
    np.testing.assert_allclose(tsim.positions(ts).numpy(), np.asarray(jsim.positions(js)),
                               rtol=0, atol=1e-10)


def _all_pairs(pos, box, radii):
    """Hertz forces (N, 3) summed over every pair under the minimum image."""
    sep = pos[None, :, :] - pos[:, None, :]
    sep -= box * np.round(sep / box)
    d = np.sqrt((sep * sep).sum(-1))
    np.fill_diagonal(d, np.inf)
    ro, rc = radii[:, None], radii[None, :]
    delta = np.maximum(ro + rc - d, 0.0)
    mag = (4.0 / 3.0) * E_EFF * np.sqrt(ro * rc / (ro + rc)) * delta ** 1.5
    return -((mag / d)[..., None] * sep).sum(1)


def _forces_both(box, n, poly=0.0, seed=6):
    kw = dict(KW, num_spheres=n, box_size=box, num_steps=1, polydispersity=poly, seed=seed)
    jsim = JaxSim(JaxConfig(**kw))
    tsim = RowSpheresSim(config_from_dict(SpheresConfig, kw), device="cpu")
    js = jsim.init()
    pos = np.array(jsim.positions(js))
    ts = tsim.init(pos=torch.as_tensor(pos))
    flat_j = np.asarray(jrows.rows_to_flat(js.rows.replace(pos=jsim._forces(js.rows)), n))
    flat_t = trows.rows_to_flat(ts.rows.replace(pos=tsim._forces(ts.rows)), n).numpy()
    radii = (np.asarray(tsim.radii) if poly > 0 else np.full(n, 0.5))
    return pos, flat_j, flat_t, radii, (tsim.grid.ny, tsim.grid.nz)


@pytest.mark.parametrize("box,ny", [(3.5, 2), (4.5, 3), (5.5, 4)])
def test_small_box_against_all_pairs(box, ny):
    """Both packages at ny = 3, 4; the port alone at ny = 2, where the
    reference's count of a neighbouring row's pairs doubles (a pair across
    one axis is reached by two rolls, across both by four)."""
    n = {2: 30, 3: 60, 4: 100}[ny]
    pos, fj, ft, radii, shape = _forces_both(box, n)
    assert shape == (ny, ny)
    ref = _all_pairs(pos, box, radii)
    assert np.abs(ref).max() > 0
    _close(ft, ref, 1e-10)
    if ny >= 3:
        _close(fj, ref, 1e-10)
    else:
        assert np.abs(fj - ref).max() > 0.1 * np.abs(ref).max()
        # every pair in another row, counted again by the extra rolls
        iy = np.clip((pos[:, 1] / (box / 2)).astype(int), 0, 1)
        iz = np.clip((pos[:, 2] / (box / 2)).astype(int), 0, 1)
        mult = (1 + (iy[:, None] != iy[None, :])) * (1 + (iz[:, None] != iz[None, :]))
        sep = pos[None] - pos[:, None]
        sep -= box * np.round(sep / box)
        d = np.sqrt((sep * sep).sum(-1))
        np.fill_diagonal(d, np.inf)
        delta = np.maximum(1.0 - d, 0.0)
        mag = (4.0 / 3.0) * E_EFF * np.sqrt(0.25) * delta ** 1.5
        doubled = -((mult * mag / d)[..., None] * sep).sum(1)
        _close(fj, doubled, 1e-10)


def test_small_box_polydisperse_radii():
    """The port's pair_fn takes each sphere's radius (the all-pairs sum with
    per-sphere radii); the reference's takes the scalar radius (the sum with
    every radius 0.5)."""
    box, n = 5.5, 80
    pos, fj, ft, radii, shape = _forces_both(box, n, poly=0.3)
    assert shape[0] < 5 and np.ptp(radii) > 0.1
    _close(ft, _all_pairs(pos, box, radii), 1e-10)
    _close(fj, _all_pairs(pos, box, np.full(n, 0.5)), 1e-10)
