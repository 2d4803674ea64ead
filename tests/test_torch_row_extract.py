"""The broad phase of the LCP line: K2's plain version and the cell list vs
the JAX reference, on the CPU.

- `neighbor_matrix_rows` (K2's plain version, the XLA extraction branch
  ported) equals JAX's on the CPU bit for bit: idx, mask and overflow, in
  float32 and float64, including a K that truncates and a grid with ny,
  nz < 8. The distances are computed with the same operations in the same
  order, so even the order at near-ties agrees.
- Against the Pallas kernel in interpret mode, each valid slot's neighbor
  set and count are equal. Order is not compared: the TPU kernel breaks
  near-ties by the lane bits it writes into the low mantissa of r2.
- The cell-list builder, its neighbor matrix and the ordered pair list are
  equal to JAX's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mundy_tpu.neighbor import cell_list as jcl
from mundy_tpu.neighbor import rows as jrows
from mundy_tpu.ops.pallas.row_extract import row_neighbor_extract as pallas_extract
from mundy_tpu_torch.neighbor import cell_list as tcl
from mundy_tpu_torch.neighbor import rows as trows
from mundy_tpu_torch.ops.kernels import row_extract as k2

torch.set_num_threads(1)
_NP = {"float32": np.float32, "float64": np.float64}


def _positions(n, box, dtype, seed=3):
    return np.random.default_rng(seed).uniform(0, box, (n, 3)).astype(_NP[dtype])


@pytest.mark.parametrize("dtype,n,box,K,expect_overflow", [
    ("float32", 2000, 20.0, 12, False),  # the LCP test line's grid (8 x 8 rows)
    ("float64", 3000, 12.0, 8, True),    # dense: K = 8 truncates
    ("float32", 500, 9.0, 20, False),    # ny = nz = 6 < 8: no alignment to 8
])
def test_neighbor_matrix_rows_matches_reference(dtype, n, box, K, expect_overflow):
    p = _positions(n, box, dtype)
    ref = jrows.neighbor_matrix_rows(jnp.asarray(p), 0.725, (box,) * 3, max_neighbors=K)
    got = trows.neighbor_matrix_rows(torch.from_numpy(p), 0.725, (box,) * 3,
                                     max_neighbors=K)
    assert got.idx.dtype == torch.int32 and got.idx.shape == (n, K)
    np.testing.assert_array_equal(got.idx.numpy(), np.asarray(ref.idx))
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(ref.mask))
    assert bool(got.overflow) == bool(ref.overflow) == expect_overflow
    if box == 9.0:
        grid = trows.make_row_grid([0, 0, 0], [box] * 3, 1.45, n, align=8)
        assert grid.ny == grid.nz == 6


def test_plain_matches_pallas_kernel_sets():
    """Same row state into both: per valid slot the neighbor set and the hit
    count agree with the TPU kernel run in interpret mode."""
    n, box, K = 1000, 12.0, 32
    p = jnp.asarray(_positions(n, box, "float32", seed=8))
    grid = jrows.make_row_grid([0, 0, 0], [box] * 3, 1.45, n, dtype=jnp.float32, align=8)
    js = jrows.build_rows(p, jnp.arange(n, dtype=jnp.int32), grid)
    ids_j, cnt_j = pallas_extract(js.pos, js.gid, (box,) * 3, 1.45, K, interpret=True)
    valid = np.asarray(js.valid)
    ids_t, cnt_t = k2.row_neighbor_extract(
        torch.from_numpy(np.array(js.pos)), torch.from_numpy(np.array(js.gid)),
        torch.from_numpy(valid.copy()), ((box,) * 3, (True,) * 3), 1.45, K, n)
    ids_j, cnt_j = np.asarray(ids_j), np.asarray(cnt_j)
    ids_t, cnt_t = ids_t.numpy(), cnt_t.numpy()
    assert cnt_t[valid].max() <= K  # no truncation: the sets are complete
    np.testing.assert_array_equal(cnt_t[valid], cnt_j[valid])
    np.testing.assert_array_equal(cnt_t[~valid], 0)
    for slot in zip(*np.nonzero(valid)):
        assert set(ids_t[slot][ids_t[slot] < n]) == set(ids_j[slot][ids_j[slot] >= 0])


def test_plain_extract_refuses_a_plane_over_budget():
    """A distribution too clustered for the row layout (one y-plane of
    (R, 9R) blocks over the byte budget) raises and names the cell-list
    builder; thin grids (< 5 rows per periodic axis) raise the same way."""
    p = torch.from_numpy(_positions(2000, 20.0, "float32", seed=2))
    with pytest.raises(ValueError, match="neighbor_matrix"):
        trows.neighbor_matrix_rows(p, 0.725, (20.0,) * 3, max_neighbors=12,
                                   hbm_budget_bytes=1e5)
    with pytest.raises(ValueError, match="neighbor_matrix"):
        trows.neighbor_matrix_rows(p[:100] * 0.3, 0.725, (6.0,) * 3, max_neighbors=12)


@pytest.mark.parametrize("n,box,cap", [(300, 7.0, 16), (400, 5.0, 4)])
def test_cell_list_neighbor_matrix_matches_reference(n, box, cap):
    """4 x 4 x 4 and 3 x 3 x 3 periodic grids (the stencil wraps onto
    itself); cap 4 overflows."""
    p = _positions(n, box, "float64", seed=4)
    jg = jcl.make_cell_grid([0, 0, 0], [box] * 3, 1.45, (True,) * 3, jnp.float64)
    tg = tcl.make_cell_grid([0, 0, 0], [box] * 3, 1.45, (True,) * 3, torch.float64)
    assert tg.dims == jg.dims
    jl = jcl.build_cell_list(jnp.asarray(p), jg, cap)
    tl = tcl.build_cell_list(torch.from_numpy(p), tg, cap)
    np.testing.assert_array_equal(tl.entries.numpy(), np.asarray(jl.entries))
    np.testing.assert_array_equal(tl.counts.numpy(), np.asarray(jl.counts))
    assert bool(tl.overflow) == bool(jl.overflow) == (cap == 4)
    from mundy_tpu.geom import periodic as jperiodic
    from mundy_tpu_torch.geom.periodicity import periodic as tperiodic
    jm = jcl.neighbor_matrix(jnp.asarray(p), jl, jnp.asarray(0.725),
                             metric=jperiodic([box] * 3, dtype=jnp.float64),
                             max_neighbors=12, chunk=256)
    tm = tcl.neighbor_matrix(torch.from_numpy(p), tl, torch.tensor(0.725, dtype=torch.float64),
                             metric=tperiodic([box] * 3, dtype=torch.float64),
                             max_neighbors=12, chunk=256)
    np.testing.assert_array_equal(tm.idx.numpy(), np.asarray(jm.idx))
    np.testing.assert_array_equal(tm.mask.numpy(), np.asarray(jm.mask))
    assert bool(tm.overflow) == bool(jm.overflow)


@pytest.fixture(scope="module")
def nmats():
    p = _positions(800, 10.0, "float64", seed=6)
    return (jrows.neighbor_matrix_rows(jnp.asarray(p), 0.725, (10.0,) * 3, max_neighbors=16),
            trows.neighbor_matrix_rows(torch.from_numpy(p), 0.725, (10.0,) * 3,
                                       max_neighbors=16))


@pytest.mark.parametrize("capacity", [16384, 4096])
def test_build_pair_list_ordered_matches_reference(nmats, capacity):
    """~8200 ordered pairs: 4096 slots truncate the list (overflow)."""
    jm, tm = nmats
    jp = jcl.build_pair_list_ordered(jm, capacity)
    tp = tcl.build_pair_list_ordered(tm, capacity)
    for a, b in zip(tp, jp):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert bool(tp.overflow) == (capacity == 4096)
