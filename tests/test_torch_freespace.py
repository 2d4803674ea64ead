"""Free-space spectral Stokes and the spectral scatter gridding: the port vs
the JAX package, float64 on the CPU from the same seeded numpy inputs.

The operator is tests/test_freespace.py's: 72 beads in a sphere of radius 5
(domain 10, extent 10, tol 1e-4, r_cut from the bead count), plus one bead
0.2 outside the sphere's bounding box in -x, so its shifted position lies
below 0 on the padded grid (G = 128, P = 10). One reference build costs
~45 s here (its radial table: 4000 radii x 200000 wavenumbers), so the
module builds each package's operator once.

- the build: G, P, the taper and the grid equal; the radial table of the
  window scalars (evaluated in blocks of radii on several threads) equal
  to the reference's loop bit for bit; the kernel
  spectrum khat within 1e-12 of its max (found equal).
- `se_spread` and `se_interpolate` (the scatter gridding): within 1e-12
  of the max, the sums' order apart; `se_wave_apply` and `se_rpy_apply`
  run the periodic `_k_apply`, whose forward FFT is float32 on both sides
  (the reference's cast), so within 1e-6 as tests/test_torch_spectral.py
  holds them (found ~4e-8).
- `freespace_rpy_apply` through the scatter gridding against the JAX
  scatter path, and through the tile gridding (the plain versions of K5s
  and K5i here) against the JAX rows path: within 1e-10 of the max. The
  port meets the reference's own bound against the dense RPY, 5 tol.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mundy_tpu.geom import periodic as jperiodic
from mundy_tpu.mobility import ewald as jew
from mundy_tpu.mobility import freespace as jfs
from mundy_tpu.mobility import spectral as jsp
from mundy_tpu.neighbor import build_cell_list, make_cell_grid, neighbor_matrix
from mundy_tpu_torch.core.interop import neighbor_matrix_from_numpy
from mundy_tpu_torch.geom.periodicity import periodic
from mundy_tpu_torch.mobility import ewald as tew
from mundy_tpu_torch.mobility import freespace as tfs
from mundy_tpu_torch.mobility import spectral as tsp
from mundy_tpu_torch.mobility.rpy import rpy_apply_dense
from mundy_tpu_torch.ops.kernels import se_grid as k5

torch.set_num_threads(2)

A, VISC, R_SPHERE, TOL = 0.5, 1.3, 5.0, 1e-4
FFT32_TOL = 1e-6
DOMAIN, ORIGIN = 2.0 * R_SPHERE, (-R_SPHERE,) * 3


def _confined_cloud(n=72, seed=12345):
    """Non-overlapping beads inside the sphere, then one just outside its
    bounding box."""
    rng = np.random.default_rng(seed)
    pts = []
    while len(pts) < n:
        p = rng.uniform(-R_SPHERE, R_SPHERE, 3)
        if np.linalg.norm(p) > R_SPHERE - A:
            continue
        if pts and np.min(np.linalg.norm(np.asarray(pts) - p, axis=1)) < 2.2 * A:
            continue
        pts.append(p)
    pts.append([-R_SPHERE - 0.2, 0.1, -0.3])
    return np.asarray(pts), rng.normal(size=(n + 1, 3))


@functools.lru_cache(maxsize=None)
def _ops():
    kw = dict(origin=ORIGIN, extent=DOMAIN, tol=TOL, n_particles=72)
    return (jfs.build_freespace_stokes(DOMAIN, A, VISC, dtype=jnp.float64, **kw),
            tfs.build_freespace_stokes(DOMAIN, A, VISC, dtype=torch.float64, **kw))


@functools.lru_cache(maxsize=None)
def _system():
    """Positions, forces and the JAX neighbor matrix at the real-space
    cutoff (tests/test_freespace.py's), carried into the port."""
    jop, _ = _ops()
    pos, f = _confined_cloud()
    r_cut = jop.se.base.r_cut
    grid = make_cell_grid(ORIGIN, np.array([DOMAIN] * 3), max(r_cut, 1.0), (False,) * 3,
                          jnp.float64)
    jn = neighbor_matrix(jnp.asarray(pos), build_cell_list(jnp.asarray(pos), grid, 64),
                         jnp.asarray(0.5 * r_cut, jnp.float64), max_neighbors=96, chunk=256)
    assert not bool(jn.overflow)
    tn = neighbor_matrix_from_numpy(np.asarray(jn.idx), np.asarray(jn.mask), False)
    return pos, f, jn, tn


def _t(a):
    return torch.as_tensor(np.array(a), dtype=torch.float64)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / np.abs(b).max())


def test_build_matches():
    jop, top = _ops()
    assert (top.se.grid_n, top.se.support) == (jop.se.grid_n, jop.se.support) == (128, 10)
    assert (top.trunc_L, top.origin, top.extent) == (jop.trunc_L, jop.origin, jop.extent)
    assert (top.se.es_beta, top.se.base.xi, top.se.base.r_cut, top.se.base.box) == (
        jop.se.es_beta, jop.se.base.xi, jop.se.base.r_cut, jop.se.base.box)
    assert top.se.base.self_coeff == jop.se.base.self_coeff
    for a, b in zip(top.se.wk, jop.se.wk):
        assert _rel(a.numpy(), b) <= 1e-13
    assert top.khat.shape == (6, 128, 128, 65) and top.khat.dtype == torch.float64
    assert _rel(top.khat.numpy(), jop.khat) <= 1e-12


def test_window_table_matches_reference_loop():
    """The port's window scalars, blocks of radii on one thread and on
    three, are the reference's per-radius loop bit for bit (r = 0
    included; nk as the free-space table and as the Ewald tables take it)."""
    jop, _ = _ops()
    r = np.linspace(0.0, 40.0, 29)
    for nk in (200000, 20000):
        want = jew._window_scalars(r, A, VISC, jop.se.base.xi, nk=nk)
        for threads in (1, 3):
            torch.set_num_threads(threads)
            try:
                got = tew._window_scalars(r, A, VISC, jop.se.base.xi, nk=nk)
            finally:
                torch.set_num_threads(2)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w)


def test_k_apply_free_matches_and_keeps_the_planar_layout():
    jop, top = _ops()
    G = top.se.grid_n
    grid = np.random.default_rng(4).normal(size=(G, G, G, 3))
    got = tfs._k_apply_free(top, _t(grid))
    assert got.dtype == torch.float64
    k5.check_grid(tfs.freespace_geometry(top, 73), got)  # K5i's layout, as it comes
    assert _rel(got.numpy(), jfs._k_apply_free(jop, jnp.asarray(grid))) <= 1e-12


def test_scatter_gridding_matches():
    """The spectral scatter path on the padded operator at the shifted
    positions (one below 0), and se_rpy_apply with a periodic metric."""
    jop, top = _ops()
    pos, f, jn, tn = _system()
    p = pos - np.asarray(ORIGIN)
    assert p[-1, 0] < 0
    jp, jf = jnp.asarray(p), jnp.asarray(f)
    grid_t = tsp.se_spread(top.se, _t(p), _t(f))
    grid_j = jsp.se_spread(jop.se, jp, jf)
    assert _rel(grid_t.numpy(), grid_j) <= 1e-12
    assert _rel(tsp.se_interpolate(top.se, _t(p), _t(grid_j)).numpy(),
                jsp.se_interpolate(jop.se, jp, grid_j)) <= 1e-12
    assert _rel(tsp.se_wave_apply(top.se, _t(p), _t(f)).numpy(),
                jsp.se_wave_apply(jop.se, jp, jf)) <= FFT32_TOL
    box = top.se.base.box
    got = tsp.se_rpy_apply(top.se, _t(p), _t(f), tn, periodic([box] * 3, dtype=torch.float64))
    want = jsp.se_rpy_apply(jop.se, jp, jf, jn,
                            jperiodic(np.array([box] * 3), dtype=jnp.float64))
    assert _rel(got.numpy(), want) <= FFT32_TOL


def test_freespace_rpy_apply_matches_both_griddings():
    """Scatter against scatter, and the port's tile gridding against the
    reference's rows layout: the same sums in another order, 1e-10 of the
    max. The bead outside the box is binned into the first tile in x with a
    negative grid position, its window wrapped on the padded grid."""
    jop, top = _ops()
    pos, f, jn, tn = _system()
    jp, jf = jnp.asarray(pos), jnp.asarray(f)
    u_t, ovf_t = tfs.freespace_rpy_apply(top, _t(pos), _t(f), tn)
    u_j, _ = jfs.freespace_rpy_apply(jop, jp, jf, jn)
    assert not bool(ovf_t)
    assert _rel(u_t.numpy(), u_j) <= 1e-10

    geom = tfs.freespace_geometry(top, pos.shape[0])
    assert (geom.G, geom.P, geom.m) == (128, 10, 8)
    pieces = tsp.se_bin_geom(geom, tfs._shift(top, _t(pos)), torch.float64)
    slot, nt1 = int(pieces[4][-1]), geom.G // geom.m
    assert slot // geom.R // nt1 ** 2 == 0  # the first tile in x ...
    assert float(pieces[2].reshape(-1, 3)[slot, 0]) < 0  # ... at u < 0
    u_tiles, ovf = tfs.freespace_rpy_apply(top, _t(pos), _t(f), tn, geom=geom, pieces=pieces)
    u_rows, ovf_j = jfs.freespace_rpy_apply(jop, jp, jf, jn,
                                            geom=jfs.freespace_geometry(jop, pos.shape[0]))
    assert not bool(ovf) and not bool(ovf_j)
    assert _rel(u_tiles.numpy(), u_rows) <= 1e-10
    assert _rel(u_tiles.numpy(), u_j) <= 1e-10


def test_freespace_meets_the_dense_bound():
    """The reference's acceptance bar on the port: within 5 tol of the
    dense free-space RPY (tests/test_freespace.py)."""
    _, top = _ops()
    pos, f, _, tn = _system()
    u, _ = tfs.freespace_rpy_apply(top, _t(pos), _t(f), tn)
    u_ref = rpy_apply_dense(_t(pos), _t(f), A, VISC)
    assert _rel(u.numpy(), u_ref.numpy()) < 5.0 * TOL


def test_wave_apply_dense_overflow_is_flagged():
    """A tile capacity below the measured occupancy sets the flag (and
    drops slots), as the app's sticky overflow needs."""
    _, top = _ops()
    pos, f, _, _ = _system()
    geom = tfs.freespace_geometry(top, pos.shape[0])._replace(R=1)
    _u, ovf = tfs.freespace_wave_apply_dense(top, geom, _t(pos), _t(f))
    assert bool(ovf)
    with pytest.raises(ValueError, match="pieces do not match"):
        tfs.freespace_wave_apply_dense(top, geom._replace(R=8), _t(pos), _t(f),
                                       pieces=tsp.se_bin_geom(geom, _t(pos), torch.float64))
