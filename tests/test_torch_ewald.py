"""The Ewald direct sum and the wide hydro broad phase of the LCP app's
`rpy_ewald` mode: the port vs the JAX package, float64 on the CPU, from
the same seeded numpy inputs, at the app's splitting for the reference
test's box (box 14, r_cut = box / 4 = 3.5, xi = 3 / r_cut, tol 1e-4).

- `build_ewald_rpy`: every table, k-mode and Chebyshev coefficient equal
  (the same float64 host code).
- `ewald_wave_apply`, `ewald_real_apply` (the Chebyshev path and the table
  path, one and several particle chunks) and `ewald_rpy_apply` within
  1e-12 of the largest velocity: the two sides differ only in the order of
  the sums inside each dense product and in rsqrt's last bit.
- The wide hydro neighbor matrix (`build_cell_list` with 4 x the cell
  capacity, `neighbor_matrix` at the hydro search radius with 8 x
  max_neighbors): ids, masks and overflow flags equal, also where the cell
  list and the matrix overflow.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mundy_tpu.geom import periodic as jperiodic
from mundy_tpu.mobility import ewald as je
from mundy_tpu.neighbor import cell_list as jcl
from mundy_tpu_torch.geom.periodicity import periodic as tperiodic
from mundy_tpu_torch.mobility import ewald as te
from mundy_tpu_torch.neighbor import cell_list as tcl

torch.set_num_threads(1)

N, BOX, A, VISC = 150, 14.0, 0.5, 1.0
R_CUT = 0.25 * BOX
KW = dict(xi=3.0 / R_CUT, r_cut=R_CUT, tol=1e-4)
HYDRO_SEARCH = 0.5 * R_CUT
REL = 1e-12


@functools.lru_cache(maxsize=None)
def _ops():
    return (je.build_ewald_rpy(BOX, A, VISC, dtype=jnp.float64, **KW),
            te.build_ewald_rpy(BOX, A, VISC, dtype=torch.float64, **KW))


def _inputs(n=N, seed=11):
    rng = np.random.default_rng(seed)
    return rng.uniform(0.0, BOX, (n, 3)), rng.normal(size=(n, 3))


def _hydro_nmat(pos, cell_capacity=16, max_neighbors=32):
    """The app's wide hydro search on both sides -> (jax nmat, torch nmat,
    jax cell-list overflow, torch cell-list overflow)."""
    jgrid = jcl.make_cell_grid([0, 0, 0], np.array([BOX] * 3), 2 * HYDRO_SEARCH,
                               (True,) * 3, jnp.float64)
    tgrid = tcl.make_cell_grid([0, 0, 0], [BOX] * 3, 2 * HYDRO_SEARCH, (True,) * 3,
                               torch.float64)
    jp, tp = jnp.asarray(pos), torch.from_numpy(pos)
    jcells = jcl.build_cell_list(jp, jgrid, 4 * cell_capacity)
    tcells = tcl.build_cell_list(tp, tgrid, 4 * cell_capacity)
    chunk = min(4096, max(256, pos.shape[0]))
    jm = jcl.neighbor_matrix(jp, jcells, jnp.asarray(HYDRO_SEARCH, jnp.float64),
                             metric=jperiodic(np.array([BOX] * 3), dtype=jnp.float64),
                             max_neighbors=8 * max_neighbors, chunk=chunk)
    tm = tcl.neighbor_matrix(tp, tcells, torch.tensor(HYDRO_SEARCH, dtype=torch.float64),
                             metric=tperiodic([BOX] * 3, dtype=torch.float64),
                             max_neighbors=8 * max_neighbors, chunk=chunk)
    return jm, tm, bool(jcells.overflow), bool(tcells.overflow)


def _close(got, ref):
    ref = np.asarray(ref)
    scale = np.abs(ref).max()
    assert scale > 0
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=REL * scale)


def test_operator_tables_equal():
    jop, top = _ops()
    for name in ("table_r", "table_f", "table_g", "kvecs", "kcoeff"):
        np.testing.assert_array_equal(getattr(top, name).numpy(),
                                      np.asarray(getattr(jop, name)), err_msg=name)
    assert (top.cheb_fw, top.cheb_gw, top.self_coeff) == (jop.cheb_fw, jop.cheb_gw,
                                                          jop.self_coeff)
    assert top.kvecs.shape[0] > 4096  # the wave sum takes several k chunks


@pytest.mark.parametrize("chunk_k", [4096, 1000])
def test_wave_apply_matches(chunk_k):
    jop, top = _ops()
    pos, f = _inputs()
    ref = je.ewald_wave_apply(jop, jnp.asarray(pos), jnp.asarray(f), chunk_k=chunk_k)
    got = te.ewald_wave_apply(top, torch.from_numpy(pos), torch.from_numpy(f),
                              chunk_k=chunk_k)
    _close(got, ref)


@pytest.mark.parametrize("path", ["chebyshev", "tables"])
def test_real_apply_matches(path):
    """Over the wide hydro neighbor matrix of 150 spheres; the table path
    is the one an operator without Chebyshev fits takes (_interp_tables)."""
    jop, top = _ops()
    if path == "tables":
        jop = jop._replace(cheb_fw=(), cheb_gw=())
        top = top._replace(cheb_fw=(), cheb_gw=())
    pos, f = _inputs()
    jm, tm, _, _ = _hydro_nmat(pos)
    assert int(np.asarray(jm.mask).sum(1).max()) > 10
    ref = je.ewald_real_apply(jop, jnp.asarray(pos), jnp.asarray(f), jm,
                              jperiodic(np.array([BOX] * 3), dtype=jnp.float64))
    got = te.ewald_real_apply(top, torch.from_numpy(pos), torch.from_numpy(f), tm,
                              tperiodic([BOX] * 3, dtype=torch.float64))
    _close(got, ref)


def test_interp_tables_match():
    jop, top = _ops()
    r = np.random.default_rng(3).uniform(0.0, 1.1 * R_CUT, 4000)
    for got, ref in zip(te._interp_tables(top, torch.from_numpy(r)),
                        je._interp_tables(jop, jnp.asarray(r))):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                                   atol=REL * np.abs(np.asarray(ref)).max())


def test_real_apply_chunks_over_particles():
    """A small budget cuts the particles into chunks of 1024 (the reference
    pads the last one): 2100 particles on a random 16-wide neighbor
    matrix, both scalar paths."""
    jop, top = _ops()
    n, k = 2100, 16
    pos, f = _inputs(n, seed=12)
    rng = np.random.default_rng(13)
    idx = rng.integers(0, n, (n, k)).astype(np.int32)
    mask = rng.uniform(size=(n, k)) < 0.7
    jm = jcl.NeighborMatrix(idx=jnp.asarray(idx), mask=jnp.asarray(mask),
                            overflow=jnp.asarray(False))
    tm = tcl.NeighborMatrix(idx=torch.from_numpy(idx), mask=torch.from_numpy(mask),
                            overflow=torch.tensor(False))
    for strip in (False, True):
        jo = jop._replace(cheb_fw=(), cheb_gw=()) if strip else jop
        to = top._replace(cheb_fw=(), cheb_gw=()) if strip else top
        ref = je.ewald_real_apply(jo, jnp.asarray(pos), jnp.asarray(f), jm,
                                  jperiodic(np.array([BOX] * 3), dtype=jnp.float64),
                                  hbm_budget_bytes=1e5)
        got = te.ewald_real_apply(to, torch.from_numpy(pos), torch.from_numpy(f), tm,
                                  tperiodic([BOX] * 3, dtype=torch.float64),
                                  hbm_budget_bytes=1e5)
        _close(got, ref)


def test_rpy_apply_matches():
    jop, top = _ops()
    pos, f = _inputs()
    jm, tm, _, _ = _hydro_nmat(pos)
    ref = je.ewald_rpy_apply(jop, jnp.asarray(pos), jnp.asarray(f), jm,
                             jperiodic(np.array([BOX] * 3), dtype=jnp.float64))
    got = te.ewald_rpy_apply(top, torch.from_numpy(pos), torch.from_numpy(f), tm,
                             tperiodic([BOX] * 3, dtype=torch.float64))
    _close(got, ref)


@pytest.mark.parametrize("caps", [(16, 32), (1, 32), (16, 1)])
def test_wide_hydro_neighbor_matrix_matches(caps):
    """The app's caps (16, 32), a cell capacity the list overflows (4 x 1
    per cell) and a K the matrix overflows (8 x 1): ids, masks and flags
    equal."""
    pos, _ = _inputs()
    jm, tm, jovf, tovf = _hydro_nmat(pos, *caps)
    np.testing.assert_array_equal(tm.idx.numpy(), np.asarray(jm.idx))
    np.testing.assert_array_equal(tm.mask.numpy(), np.asarray(jm.mask))
    assert (bool(tm.overflow), tovf) == (bool(jm.overflow), jovf)
    assert (bool(tm.overflow) or tovf) == (caps != (16, 32))
