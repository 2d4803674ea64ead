"""The dense 3D-cell engine and the Ewald real-space RPY on it: the port vs
the JAX package, float64 on the CPU from the same seeded numpy inputs.

Layouts (`build_cells3d`, `build_cells3d_split`: slot positions, ids,
dense-cell tables, overflow flags) are bit-equal. The pair applies (the
real-space RPY correction over the 27-cell neighbourhood, plain and
density-split) agree within 1e-12 of the max: the same pair arithmetic,
summed in another order only where the split scatters its corrections.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mundy_tpu.mobility import ewald as je
from mundy_tpu.neighbor import cells3d as jc
from mundy_tpu_torch.mobility import ewald as te
from mundy_tpu_torch.neighbor import cells3d as tc

torch.set_num_threads(1)

BOX, A, VISC, R_CUT = 24.0, 0.5, 1.0, 3.5
TOL = 1e-12
FULL = 40  # a capacity above the test system's largest cell (33)


@functools.lru_cache(maxsize=None)
def _ops():
    xi = np.sqrt(np.log(1e4)) / R_CUT
    return (je.build_ewald_rpy(BOX, A, VISC, xi=xi, r_cut=R_CUT, tol=1e-4, dtype=jnp.float64),
            te.build_ewald_rpy(BOX, A, VISC, xi=xi, r_cut=R_CUT, tol=1e-4,
                               dtype=torch.float64))


def _system(n, seed=21, clustered=True):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0, BOX, (n, 3))
    if clustered:  # a dense blob across the periodic corner
        k = n // 3
        pos[:k] = np.mod(rng.normal(0.0, 1.2, (k, 3)), BOX)
    return pos, rng.normal(size=(n, 3))


def _grids(n, capacity=None):
    jg = jc.make_cell_grid3d([BOX] * 3, R_CUT, n, dtype=jnp.float64)
    tg = tc.make_cell_grid3d([BOX] * 3, R_CUT, n, dtype=torch.float64)
    if capacity is not None:
        jg, tg = jg.replace(capacity=capacity), tg.replace(capacity=capacity)
    return jg, tg


def _eq(a, b, name):
    np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=name)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.mark.parametrize("n,box", [(400, 24.0), (1000, 31.0), (50, 10.5)])
def test_make_cell_grid3d_matches(n, box):
    jg = jc.make_cell_grid3d([box] * 3, R_CUT, n, dtype=jnp.float64)
    tg = tc.make_cell_grid3d([box] * 3, R_CUT, n, dtype=torch.float64)
    assert (tg.nx, tg.ny, tg.nz, tg.capacity) == (jg.nx, jg.ny, jg.nz, jg.capacity)
    _eq(jg.edge, tg.edge, "edge")
    _eq(jg.origin, tg.origin, "origin")


@pytest.mark.parametrize("capacity", [FULL, 8], ids=["fits", "overflow"])
def test_build_cells3d_bit_equal(capacity):
    n = 600
    pos, F = _system(n)
    jg, tg = _grids(n, capacity)
    js = jc.build_cells3d(jnp.asarray(pos), jg)
    ts = tc.build_cells3d(torch.as_tensor(pos), tg)
    _eq(js.pos, ts.pos, "pos")
    _eq(js.perm, ts.perm, "perm")
    assert bool(ts.overflow) == bool(js.overflow) == (capacity == 8)
    _eq(jc.gather_from_flat(js, jnp.asarray(F)), tc.gather_from_flat(ts, torch.as_tensor(F)),
        "gather_from_flat")
    vals = np.random.default_rng(2).normal(size=tuple(ts.perm.shape) + (3,))
    _eq(jc.scatter_to_flat(js, jnp.asarray(vals), n),
        tc.scatter_to_flat(ts, torch.as_tensor(vals), n), "scatter_to_flat")


@pytest.mark.parametrize("c_lo,c_ex,dc_cap", [(8, 32, 64), (8, 16, 64), (8, 32, 4)],
                         ids=["fits", "excess-overflow", "dense-cell-overflow"])
def test_build_cells3d_split_bit_equal(c_lo, c_ex, dc_cap):
    n = 600
    pos, _ = _system(n)
    jg, tg = _grids(n, c_lo)
    js = jc.build_cells3d_split(jnp.asarray(pos), jg, c_ex, dc_cap)
    ts = tc.build_cells3d_split(torch.as_tensor(pos), tg, c_ex, dc_cap)
    _eq(js.base.pos, ts.base.pos, "base.pos")
    _eq(js.base.perm, ts.base.perm, "base.perm")
    for name in ("xs_pos", "xs_perm", "dc_cell", "dense_of", "overflow"):
        _eq(getattr(js, name), getattr(ts, name), name)
    assert bool(ts.overflow) == (c_ex == 16 or dc_cap == 4)


def test_real_space_apply_matches():
    """ewald_real_apply_cells (self term included) over the plain layout."""
    n = 600
    jop, top = _ops()
    pos, F = _system(n)
    jg, tg = _grids(n, FULL)
    want = je.ewald_real_apply_cells(jop, jc.build_cells3d(jnp.asarray(pos), jg),
                                     jnp.asarray(F), (BOX,) * 3)
    got = te.ewald_real_apply_cells(top, tc.build_cells3d(torch.as_tensor(pos), tg),
                                    torch.as_tensor(F), (BOX,) * 3)
    assert _rel(got.numpy(), want) <= TOL


def test_split_apply_matches_reference_and_plain_layout():
    """pair_apply_cells3d_split vs the reference's, and vs the plain layout
    at full capacity (the split only reorders the sum)."""
    n = 600
    jop, top = _ops()
    pos, F = _system(n)
    jg, tg = _grids(n, 8)
    js = jc.build_cells3d_split(jnp.asarray(pos), jg, 40, 64)
    ts = tc.build_cells3d_split(torch.as_tensor(pos), tg, 40, 64)
    assert not bool(ts.overflow) and int((ts.dc_cell < tg.nx ** 3).sum()) > 0
    want = jc.pair_apply_cells3d_split(js, (BOX,) * 3, jnp.asarray(F),
                                       je.rpy_real_cells_kernel(jop), 3)
    got = tc.pair_apply_cells3d_split(ts, (BOX,) * 3, torch.as_tensor(F),
                                      te.rpy_real_cells_kernel(top), 3)
    assert _rel(got.numpy(), want) <= TOL
    full = te.ewald_real_apply_cells(top, tc.build_cells3d(torch.as_tensor(pos),
                                                           _grids(n, FULL)[1]),
                                     torch.as_tensor(F), (BOX,) * 3)
    assert _rel(got.numpy(), full.numpy()) <= TOL


def test_pair_apply_chunking_is_exact():
    """The byte budget only cuts the rows into chunks: any budget gives the
    same bits."""
    n = 200
    _, top = _ops()
    pos, F = _system(n, seed=5, clustered=False)
    _, tg = _grids(n, 16)
    ts = tc.build_cells3d(torch.as_tensor(pos), tg)
    payload = tc.gather_from_flat(ts, torch.as_tensor(F))
    kern = te.rpy_real_cells_kernel(top)
    whole = tc.pair_apply_cells3d(ts, (BOX,) * 3, payload, kern, 3)
    chunked = tc.pair_apply_cells3d(ts, (BOX,) * 3, payload, kern, 3, hbm_budget_bytes=1.0)
    assert torch.equal(whole, chunked)
    with pytest.raises(ValueError, match="3 cells"):
        small = tc.make_cell_grid3d([6.0] * 3, R_CUT, n, dtype=torch.float64)
        tc.pair_apply_cells3d(tc.build_cells3d(torch.as_tensor(pos) % 6.0, small),
                              (6.0,) * 3, payload[:1], kern, 3)
