"""Spectral-Ewald gridding (kernels K5s/K5i): the port's tile binning and
plain spread/interp vs the JAX package.

The same seeded numpy positions, forces and grids go to both sides in
float64 on the CPU, where the wrappers take their plain versions:

- the binning (`se_bin_tiles`: perm, overflow, u, valid, slot_of) is
  bit-equal, the tile geometry and the window weights equal;
- the plain spread and interpolation agree with the reference's tile path
  (`se_spread_tiles` / `se_interp_tiles`) within 1e-12 of the max with the
  ES window, whose weight is exactly zero off the P support points that the
  tile path's dense W-point windows add; the truncated Gaussian window
  differs from the dense one at the truncation level (2e-4 of the max, the
  bound of tests/test_spectral_ewald.py);
- the same holds against the Pallas kernels se_spread_rows_pre /
  se_interp_rows_pre in interpret mode (the TPU kernels K5s/K5i as the JAX
  tests run them on the CPU) and against the scatter/gather reference
  se_spread / se_interpolate (ES: 1e-12 of the max; found ~1e-15);
- the interpolation reads the grid in the inverse FFT's planar layout
  (three (G, G, G) planes, the channel axis outermost), the one layout K5i
  takes, and any other strides raise.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mundy_tpu.mobility import spectral as jsp
from mundy_tpu.ops.pallas import se_grid as jg
from mundy_tpu_torch.mobility import spectral as tsp
from mundy_tpu_torch.ops.kernels import se_grid as tg

torch.set_num_threads(1)

BOX, A, VISC = 10.0, 0.5, 1.0
ES_TOL = 1e-12
GAUSS_TOL = 2e-4


@functools.lru_cache(maxsize=None)
def _ops(window="es", box=BOX, **kw):
    """The JAX and torch operators, built once per module and window."""
    return (jsp.build_spectral_ewald(box, A, VISC, tol=1e-4, dtype=jnp.float64,
                                     window=window, **kw),
            tsp.build_spectral_ewald(box, A, VISC, tol=1e-4, dtype=torch.float64,
                                     window=window, **kw))


def _system(n, box=BOX, seed=3, clustered=False):
    rng = np.random.default_rng(seed)
    if clustered:  # half the particles in one corner: some tiles overflow
        pos = np.concatenate([rng.uniform(0, box, (n - n // 2, 3)),
                              rng.uniform(0, 0.15 * box, (n // 2, 3))])
    else:
        pos = rng.uniform(0, box, (n, 3))
    pos[0] = 0.0  # the origin and the far faces exercise the wrap
    pos[1] = np.nextafter(box, 0.0)
    return pos, rng.normal(size=(n, 3))


def _pieces(jgeom, tgeom, pos):
    jp = jsp.se_bin_geom(jgeom, jnp.asarray(pos), jnp.float64)
    tp = tsp.se_bin_geom(tgeom, torch.as_tensor(pos), torch.float64)
    return jp, tp


def _planar(grid):
    """A (G, G, G, 3) grid as three (G, G, G) planes, the channel axis
    outermost: the inverse FFT's layout, which K5i reads."""
    return torch.as_tensor(grid).permute(3, 0, 1, 2).contiguous().permute(1, 2, 3, 0)


def _rel(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max() / np.abs(np.asarray(b)).max())


@pytest.mark.parametrize("n,slack,clustered", [(300, 1.5, False), (600, 1.15, True),
                                               (5, 1.15, False)],
                         ids=["uniform", "overflow", "sparse"])
def test_bin_tiles_bit_equal(n, slack, clustered):
    jop, top = _ops()
    jgeom = jsp.make_se_geometry_tiles(jop, n, capacity_slack=slack)
    tgeom = tsp.make_se_geometry_tiles(top, n, capacity_slack=slack)
    assert tuple(tgeom) == tuple(jgeom)
    pos, _ = _system(n, clustered=clustered)
    jp, tp = _pieces(jgeom, tgeom, pos)
    for name, a, b in zip(("perm", "overflow", "u", "valid", "slot_of"), jp, tp):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=name)
    assert bool(tp[1]) == clustered


@pytest.mark.parametrize("G,P,n,slack", [(384, 6, 1_048_576, 1.5), (64, 6, 128, 1.5),
                                         (48, 12, 300, 1.15), (16, 6, 40, 1.15)])
def test_tile_geometry_matches(G, P, n, slack):
    """make_se_grid_tiles' tile edge (the slab-budget test) and capacity,
    at the 1M chromatin grid and at small ones."""
    args = (G, P, 152.0, 0.87, 0.0, n)
    kw = dict(capacity_slack=slack, kind="es", beta=12.0)
    assert tuple(tg.make_se_grid_tiles(*args, **kw)) == tuple(jg.make_se_grid_tiles(*args,
                                                                                   **kw))


@pytest.mark.parametrize("window", ["es", "gaussian"])
def test_window_weights_match(window):
    jop, top = _ops(window)
    jgeom = jsp.make_se_geometry_tiles(jop, 100)
    tgeom = tsp.make_se_geometry_tiles(top, 100)
    d = np.linspace(-0.6 * jop.support, 0.6 * jop.support, 257)
    want = np.asarray(jg.window_weights_1d(jgeom, jnp.asarray(d), jnp.float64))
    got = tg.window_weights_1d(tgeom, torch.as_tensor(d)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-15, atol=0)


@pytest.mark.parametrize("window,n,clustered", [("es", 300, False), ("es", 600, True),
                                                ("gaussian", 300, False)],
                         ids=["es", "es-overflow", "gaussian"])
def test_plain_matches_tiles(window, n, clustered):
    """The plain K5s/K5i vs the reference's tile path (the chromatin app's
    gridding), dropped slots included."""
    jop, top = _ops(window)
    slack = 1.15 if clustered else 1.5
    jgeom = jsp.make_se_geometry_tiles(jop, n, capacity_slack=slack)
    tgeom = tsp.make_se_geometry_tiles(top, n, capacity_slack=slack)
    pos, F = _system(n, clustered=clustered)
    jp, tp = _pieces(jgeom, tgeom, pos)
    tol = ES_TOL if window == "es" else GAUSS_TOL
    want = np.asarray(jg.se_spread_tiles(jgeom, jp, jnp.asarray(F)))
    got = tg.se_spread(tgeom, tp, torch.as_tensor(F))
    assert got.shape == (top.grid_n,) * 3 + (3,) and got.dtype == torch.float64
    assert _rel(got.numpy(), want) <= tol
    grid = np.random.default_rng(7).normal(size=want.shape)
    want_u = np.asarray(jg.se_interp_tiles(jgeom, jp, jnp.asarray(grid)))
    got_u = tg.se_interp(tgeom, tp, _planar(grid))
    assert got_u.shape == (n, 3)
    assert _rel(got_u.numpy(), want_u) <= tol
    dropped = tp[4].numpy() >= tp[2].shape[0] * tp[2].shape[1]
    assert dropped.any() == clustered
    assert not got_u.numpy()[dropped].any()


@pytest.mark.parametrize("window", ["es", "gaussian"])
def test_plain_matches_pallas_rows_interpret(window):
    """The plain K5s/K5i on the tile binning vs the TPU kernels K5s/K5i
    (se_spread_rows_pre / se_interp_rows_pre) on their row binning, in
    interpret mode, as tests/test_spectral_ewald.py runs them."""
    n = 250
    jop, top = _ops(window)
    pos, F = _system(n, seed=5)
    rgeom = jsp.make_se_geometry(jop, n)
    rp = jg.se_bin_and_windows(rgeom, jnp.asarray(pos), jnp.float64)
    assert not bool(rp[1])
    tgeom = tsp.make_se_geometry_tiles(top, n, capacity_slack=1.5)
    tp = tsp.se_bin_geom(tgeom, torch.as_tensor(pos), torch.float64)
    assert not bool(tp[1])
    tol = ES_TOL if window == "es" else GAUSS_TOL
    want = np.asarray(jg.se_spread_rows_pre(rgeom, rp, jnp.asarray(F), interpret=True))
    assert _rel(tg.se_spread(tgeom, tp, torch.as_tensor(F)).numpy(), want) <= tol
    grid = np.random.default_rng(8).normal(size=want.shape)
    want_u = np.asarray(jg.se_interp_rows_pre(rgeom, rp, n, jnp.asarray(grid),
                                              interpret=True))
    assert _rel(tg.se_interp(tgeom, tp, _planar(grid)).numpy(), want_u) <= tol


def test_plain_matches_scatter_reference():
    """The plain versions are the reference's P-point scatter and gather
    (spectral.se_spread / se_interpolate) applied to the binned slots."""
    n = 400
    jop, top = _ops("es", box=24.0, xi=np.sqrt(np.log(1e4)) / 3.5, r_cut=3.5)
    pos, F = _system(n, box=24.0, seed=9)
    tgeom = tsp.make_se_geometry_tiles(top, n, capacity_slack=1.5)
    tp = tsp.se_bin_geom(tgeom, torch.as_tensor(pos), torch.float64)
    want = np.asarray(jsp.se_spread(jop, jnp.asarray(pos), jnp.asarray(F)))
    assert _rel(tg.se_spread_plain(tgeom, tp, torch.as_tensor(F)).numpy(), want) <= ES_TOL
    want_u = np.asarray(jsp.se_interpolate(jop, jnp.asarray(pos), jnp.asarray(want)))
    got_u = tg.se_interp_plain(tgeom, tp, _planar(np.array(want))).numpy()
    assert _rel(got_u, want_u) <= ES_TOL


def test_float32_pieces_and_grid():
    """The app's float32 path: u in float32 from float64 positions divided
    in float64 (bit-equal to the reference), the grid in the forces' dtype."""
    n = 300
    jop, top = _ops()
    jgeom = jsp.make_se_geometry_tiles(jop, n, capacity_slack=1.5)
    tgeom = tsp.make_se_geometry_tiles(top, n, capacity_slack=1.5)
    pos, F = _system(n, seed=4)
    pos32 = pos.astype(np.float32)
    jp = jsp.se_bin_geom(jgeom, jnp.asarray(pos32), jnp.float32)
    tp = tsp.se_bin_geom(tgeom, torch.as_tensor(pos32), torch.float32)
    for name, a, b in zip(("perm", "overflow", "u", "valid", "slot_of"), jp, tp):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=name)
    got = tg.se_spread(tgeom, tp, torch.as_tensor(F, dtype=torch.float32))
    want = np.asarray(jg.se_spread_tiles(jgeom, jp, jnp.asarray(F, jnp.float32)))
    assert got.dtype == torch.float32
    assert _rel(got.numpy(), want) <= 1e-5


@pytest.mark.parametrize("window", ["es", "gaussian"])
def test_plain_interp_reads_the_planar_layout(window):
    """The wave apply hands K5i the inverse FFT's output as it comes: three
    planes, the channel axis outermost (mobility/spectral._k_apply). The
    plain interpolation on that layout matches the reference's tile path
    within the tolerance above, and other strides, C order among them,
    raise."""
    n = 300
    jop, top = _ops(window)
    jgeom = jsp.make_se_geometry_tiles(jop, n, capacity_slack=1.5)
    tgeom = tsp.make_se_geometry_tiles(top, n, capacity_slack=1.5)
    pos, F = _system(n, seed=6)
    jp, tp = _pieces(jgeom, tgeom, pos)
    G = top.grid_n
    planar = tsp._k_apply(top, tg.se_spread(tgeom, tp, torch.as_tensor(F)))
    assert planar.stride() == (G * G, G, 1, G ** 3)
    tg.check_grid(tgeom, planar)
    got = tg.se_interp(tgeom, tp, planar)
    assert torch.equal(got, tg.se_interp_plain(tgeom, tp, planar))
    want = np.asarray(jg.se_interp_tiles(jgeom, jp, jnp.asarray(planar.numpy())))
    assert _rel(got.numpy(), want) <= (ES_TOL if window == "es" else GAUSS_TOL)
    for other in (planar.contiguous(), planar.transpose(0, 2)):
        with pytest.raises(ValueError, match="strides"):
            tg.se_interp(tgeom, tp, other)
        with pytest.raises(ValueError, match="strides"):
            tg.se_interp_plain(tgeom, tp, other)
