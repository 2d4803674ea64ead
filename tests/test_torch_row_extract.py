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


def _outward(t, up):
    """The float32 bound of t that the kernel keeps for a chunk: t itself
    in float32, rounded down (or up) from float64."""
    f = t.to(torch.float32)
    if t.dtype == torch.float32:
        return f
    off = (f.double() < t) if up else (f.double() > t)
    step = torch.full_like(f, float("inf") if up else float("-inf"))
    return torch.where(off, torch.nextafter(f, step), f).to(t.dtype)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("radii", [False, True])
@pytest.mark.parametrize("case", ["uniform", "x_faces", "moved"])
def test_plain_has_no_hit_in_a_chunk_the_kernel_skips(dtype, radii, case):
    """K2 skips a chunk of packed candidates whose x bounds `chunk_visit`
    rejects for a warp's own slots. Every row is packed and chunked as the
    kernel does (occupied candidates in lane order, CHUNK at a time, float
    bounds rounded outward, the greatest |search radius| with radii; own
    slots OWN_GROUP at a time, their least and greatest x and greatest
    |search radius|), and no hit of the plain version's pair test may lie
    in a chunk that the test rejects for its own slot's warp:
    uniform rows; half the spheres within the cut of an x face, so pairs
    and chunks wrap in x; and rows whose spheres moved after build_rows, so
    their x order is stale. Counts, both sides of the wrap and the share of
    rejected chunks keep the check from passing vacuously."""
    td = torch.float32 if dtype == "float32" else torch.float64
    n, box = 1500, 12.0
    cutoff = 1.8 if radii else 1.45
    rng = np.random.default_rng(21)
    p = rng.uniform(0, box, (n, 3))
    if case == "x_faces":
        p[::2, 0] = np.mod(rng.uniform(-0.8, 0.8, p[::2].shape[0]), box)
    grid = trows.make_row_grid([0, 0, 0], [box] * 3, cutoff, n, dtype=td, align=8)
    ts = trows.build_rows(torch.as_tensor(p, dtype=td), torch.arange(n, dtype=torch.int32),
                          grid)
    pos = ts.pos
    if case == "moved":
        moved = torch.remainder(pos + torch.as_tensor(rng.normal(0, 0.5, pos.shape),
                                                      dtype=td), box)
        pos = torch.where(ts.valid[..., None], moved, pos)
    sr = None
    if radii:
        s = torch.as_tensor(rng.uniform(0.3, 0.9, n), dtype=td)
        sr = torch.where(ts.valid, s[ts.gid.long()], 0.0)
    ny, nz, R = ts.valid.shape
    gid_f = ts.gid.to(td)
    fields = (gid_f, ts.valid.to(td)) + (() if sr is None else (sr,))
    cx, cy, cz, (cg, cval, *csr) = trows._candidate_planes(pos, ((box,) * 3, (True,) * 3),
                                                           fields)
    cut2 = torch.tensor(cutoff * cutoff, dtype=td)
    ox = pos[..., 0]
    _, hit = k2._pair_hits(cx, cy, cz, cg, ox, pos[..., 1], pos[..., 2], gid_f, box, True,
                           cut2, sr, csr[0] if csr else None)
    hit &= ts.valid[..., None]

    # pack and chunk the candidates as the kernel does
    nc = -(-R // k2.CHUNK)
    cv = cval > 0.5
    rank = torch.cumsum(cv.reshape(ny, nz, 9, R).long(), -1).reshape(ny, nz, 9 * R) - 1
    blk = torch.arange(9 * R) // R
    chunk = torch.where(cv, blk * nc + torch.div(rank, k2.CHUNK, rounding_mode="floor"),
                        9 * nc)
    inf = torch.full((ny, nz, 9 * nc + 1), float("inf"), dtype=td)
    lo = _outward(inf.scatter_reduce(-1, chunk, cx, "amin")[..., :-1], up=False)
    hi = _outward((-inf).scatter_reduce(-1, chunk, cx, "amax")[..., :-1], up=True)
    # each warp's own slots: OWN_GROUP consecutive occupied slots of the row
    own = torch.cumsum(ts.valid.long(), -1) - 1
    ng = -(-R // k2.OWN_GROUP)
    grp = torch.where(ts.valid, torch.div(own, k2.OWN_GROUP, rounding_mode="floor"), ng)
    inf_g = torch.full((ny, nz, ng + 1), float("inf"), dtype=td)
    p_lo = inf_g.scatter_reduce(-1, grp, ox, "amin")
    p_hi = (-inf_g).scatter_reduce(-1, grp, ox, "amax")
    ccut2 = cut2
    if radii:
        smax = torch.zeros_like(inf).scatter_reduce(-1, chunk, csr[0].abs(), "amax")
        s_own = torch.zeros_like(inf_g).scatter_reduce(-1, grp, sr.abs(), "amax")
        ccut2 = k2.chunk_cut2(s_own[..., None], _outward(smax[..., :-1], up=True)[..., None, :])
    visit = k2.chunk_visit(lo[..., None, :], hi[..., None, :], p_lo[..., None],
                           p_hi[..., None], ccut2, box)  # (ny, nz, ng + 1, 9 nc)
    visit = torch.gather(visit, -2, grp[..., None].expand(ny, nz, R, 9 * nc))
    at = torch.clamp(chunk, max=9 * nc - 1)[..., None, :].expand(hit.shape)
    assert not bool((hit & ~torch.gather(visit, -1, at)).any())

    assert int(hit.sum()) > 2000
    own_visits = visit[ts.valid]
    assert own_visits.float().mean().item() < 0.5  # most chunks are skipped
    raw = (cx[..., None, :] - ox[..., :, None]).abs()
    assert bool((hit & (raw > box / 2)).any())  # pairs across the x face
