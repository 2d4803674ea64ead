"""The spectral-Ewald RPY operator: the port vs the JAX package, float64 on
the CPU from the same seeded numpy inputs, at the chromatin app's splitting
(box 24, r_cut 3.5, tol 1e-4: G = 64, P = 6).

- `build_spectral_ewald`: G, P, es_beta, eta, the window transforms, the
  wavenumbers and every table and Chebyshev coefficient of the Ewald base
  are equal (the same float64 host code).
- `_k_apply` runs its forward FFT in float32 on both sides, as the
  reference casts it; the two FFT libraries round differently, so the wave
  parts agree to float32 FFT rounding: 1e-6 of the max (found ~7e-8).
- `se_wave_apply_dense` (tiles) and `se_rpy_apply_cells` on the plain and
  the density-split 3D cells agree within the same 1e-6; the overflow
  flags are equal.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mundy_tpu.mobility import spectral as jsp
from mundy_tpu.neighbor import cells3d as jc
from mundy_tpu_torch.mobility import spectral as tsp
from mundy_tpu_torch.neighbor import cells3d as tc

torch.set_num_threads(1)

BOX, A, VISC, R_CUT = 24.0, 0.5, 1.0, 3.5
XI = float(np.sqrt(np.log(1e4)) / R_CUT)
FFT_TOL = 1e-6


@functools.lru_cache(maxsize=None)
def _ops(window="es"):
    kw = dict(tol=1e-4, xi=XI, r_cut=R_CUT, window=window)
    return (jsp.build_spectral_ewald(BOX, A, VISC, dtype=jnp.float64, **kw),
            tsp.build_spectral_ewald(BOX, A, VISC, dtype=torch.float64, **kw))


def _system(n=300, seed=31):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0, BOX, (n, 3))
    k = n // 3
    pos[:k] = np.mod(5.0 + rng.normal(0.0, 2.0, (k, 3)), BOX)  # a dense blob
    return pos, rng.normal(size=(n, 3))


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.mark.parametrize("window", ["es", "gaussian"])
def test_build_spectral_ewald_matches(window):
    jop, top = _ops(window)
    assert (top.grid_n, top.support, top.window) == (jop.grid_n, jop.support, jop.window)
    assert top.es_beta == jop.es_beta and top.eta == jop.eta
    if window == "es":
        assert (top.grid_n, top.support) == (64, 6)
    assert len(top.wk) == len(jop.wk)
    for a, b in zip(jop.wk + jop.kvec, top.wk + top.kvec):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    jb, tb = jop.base, top.base
    assert (tb.box, tb.radius, tb.viscosity, tb.xi, tb.r_cut, tb.self_coeff) == \
        (jb.box, jb.radius, jb.viscosity, jb.xi, jb.r_cut, jb.self_coeff)
    assert tb.cheb_fw == jb.cheb_fw and tb.cheb_gw == jb.cheb_gw
    for name in ("table_r", "table_f", "table_g", "kvecs", "kcoeff"):
        np.testing.assert_array_equal(getattr(tb, name).numpy(), np.asarray(getattr(jb, name)),
                                      err_msg=name)


@pytest.mark.parametrize("n", [16, 100, 152, 385, 1000])
def test_smooth_size_matches(n):
    assert tsp._smooth_size(n) == jsp._smooth_size(n)


def test_k_apply_matches():
    jop, top = _ops()
    G = top.grid_n
    grid = np.random.default_rng(4).normal(size=(G, G, G, 3))
    want = np.asarray(jsp._k_apply(jop, jnp.asarray(grid)))
    got = tsp._k_apply(top, torch.as_tensor(grid))
    assert got.dtype == torch.float64 and got.shape == grid.shape
    assert _rel(got.numpy(), want) <= FFT_TOL


def test_wave_apply_tiles_matches(monkeypatch):
    """The wave sum through the tile gridding; K5i's wrapper gets its grid
    as the inverse FFT leaves it, three (G, G, G) planes with the channel
    axis outermost, with no copy: the one layout K5i reads (its wrapper
    refuses any other)."""
    jop, top = _ops()
    pos, F = _system()
    n = pos.shape[0]
    jgeom = jsp.make_se_geometry_tiles(jop, n, capacity_slack=1.5)
    tgeom = tsp.make_se_geometry_tiles(top, n, capacity_slack=1.5)
    assert tuple(tgeom) == tuple(jgeom)
    interp = tsp.se_interp
    G = top.grid_n

    def planar_interp(geom, pieces, grid):
        assert grid.stride() == (G * G, G, 1, G ** 3)
        return interp(geom, pieces, grid)

    monkeypatch.setattr(tsp, "se_interp", planar_interp)
    want, jovf = jsp.se_wave_apply_dense(jop, jgeom, jnp.asarray(pos), jnp.asarray(F))
    got, tovf = tsp.se_wave_apply_dense(top, tgeom, torch.as_tensor(pos), torch.as_tensor(F))
    assert bool(tovf) == bool(jovf)
    assert _rel(got.numpy(), want) <= FFT_TOL


@pytest.mark.parametrize("split", [False, True], ids=["cells3d", "split"])
def test_rpy_apply_cells_matches(split):
    """The full periodic RPY product of the chromatin app: the real-space
    correction on the 3D cells (plain, or density-split at C_lo = 8) plus
    the tile-gridded wave sum, from one shared binning."""
    jop, top = _ops()
    pos, F = _system()
    n = pos.shape[0]
    jgeom = jsp.make_se_geometry_tiles(jop, n, capacity_slack=1.5)
    tgeom = tsp.make_se_geometry_tiles(top, n, capacity_slack=1.5)
    jg3 = jc.make_cell_grid3d([BOX] * 3, R_CUT, n, dtype=jnp.float64)
    tg3 = tc.make_cell_grid3d([BOX] * 3, R_CUT, n, dtype=torch.float64)
    if split:
        jcells = jc.build_cells3d_split(jnp.asarray(pos), jg3.replace(capacity=8), 24, 64)
        tcells = tc.build_cells3d_split(torch.as_tensor(pos), tg3.replace(capacity=8), 24, 64)
    else:
        jcells = jc.build_cells3d(jnp.asarray(pos), jg3.replace(capacity=32))
        tcells = tc.build_cells3d(torch.as_tensor(pos), tg3.replace(capacity=32))
    assert not bool(tcells.overflow) and not bool(jcells.overflow)
    jp = jsp.se_bin_geom(jgeom, jnp.asarray(pos), jnp.float64)
    tp = tsp.se_bin_geom(tgeom, torch.as_tensor(pos), torch.float64)
    want, jovf = jsp.se_rpy_apply_cells(jop, jcells, jnp.asarray(pos), jnp.asarray(F),
                                        (BOX,) * 3, jgeom, pieces=jp)
    got, tovf = tsp.se_rpy_apply_cells(top, tcells, torch.as_tensor(pos), torch.as_tensor(F),
                                       (BOX,) * 3, tgeom, pieces=tp)
    assert bool(tovf) == bool(jovf) is False
    assert _rel(got.numpy(), want) <= FFT_TOL
    # mobility is positive definite: power dissipated > 0
    assert float((got * torch.as_tensor(F)).sum()) > 0
