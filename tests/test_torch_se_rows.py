"""The rows layout of the spectral-Ewald gridding (kernels K5s-rows and
K5i-rows) against the JAX package.

The same seeded numpy positions, forces and grids go to both sides in
float64 on the CPU, where the wrappers take their plain versions:

- the geometry (make_se_grid_rows, make_se_geometry) has equal fields, the
  binning (perm, overflow, gx0, gy0) is bit-equal and the window pieces
  (wx, wy, wz) agree within 1e-12, for both windows, uniform and clustered
  positions and a case that overflows;
- the plain K5s-rows and K5i-rows agree with the TPU kernels
  se_spread_rows_pre and se_interp_rows_pre, run in interpret mode as the
  JAX package's tests run them, within 1e-12 of the max;
- the dense trio and se_wave_apply_rows agree with the JAX functions with
  equal overflow flags: u within 1e-10 of max|u| with the FFT mode product
  replaced on both sides by a float64 map (the gridding around it), and
  within 1e-6 through the real `_k_apply`, whose forward FFT runs in
  float32 in both packages (found ~7e-8, the bound of
  tests/test_torch_spectral.py).
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
PIECE_TOL = 1e-12
GRID_TOL = 1e-12
WAVE_TOL = 1e-10
FFT_TOL = 1e-6


@functools.lru_cache(maxsize=None)
def _ops(window):
    """The JAX and torch operators, built once per module and window."""
    return (jsp.build_spectral_ewald(BOX, A, VISC, tol=1e-4, dtype=jnp.float64,
                                     window=window),
            tsp.build_spectral_ewald(BOX, A, VISC, tol=1e-4, dtype=torch.float64,
                                     window=window))


def _system(n, seed=3, clustered=False):
    rng = np.random.default_rng(seed)
    if clustered:  # half the particles in one corner: some rows overflow
        pos = np.concatenate([rng.uniform(0, BOX, (n - n // 2, 3)),
                              rng.uniform(0, 0.15 * BOX, (n // 2, 3))])
    else:
        pos = rng.uniform(0, BOX, (n, 3))
    pos[0] = 0.0  # the origin and the far faces exercise the wrap
    pos[1] = np.nextafter(BOX, 0.0)
    return pos, rng.normal(size=(n, 3))


def _rel(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max() / np.abs(np.asarray(b)).max())


def _planar(grid):
    """The inverse FFT's layout: three (G, G, G) planes, channel outermost."""
    return torch.as_tensor(np.asarray(grid)).permute(3, 0, 1, 2).contiguous().permute(
        1, 2, 3, 0)


@pytest.mark.parametrize("window", ["es", "gaussian"])
def test_geometry_fields_equal(window):
    jop, top = _ops(window)
    for n, slack in ((300, 1.15), (5000, 1.6)):
        jgeom = jsp.make_se_geometry(jop, n, capacity_slack=slack)
        tgeom = tsp.make_se_geometry(top, n, capacity_slack=slack)
        assert tuple(tgeom) == pytest.approx(tuple(jgeom), rel=1e-15)
        assert (tgeom.G, tgeom.m, tgeom.P, tgeom.R) == (jgeom.G, jgeom.m, jgeom.P, jgeom.R)
        assert tgeom.R % 8 == 0
    assert tuple(tg.make_se_grid_rows(48, 6, 12.0, 1.3, 0.4, 777, min_m=5)) == pytest.approx(
        tuple(jg.make_se_grid_rows(48, 6, 12.0, 1.3, 0.4, 777, min_m=5)))


@pytest.mark.parametrize("window,n,slack,clustered", [
    ("es", 300, 1.15, False), ("gaussian", 300, 1.15, False),
    ("es", 400, 1.15, True), ("gaussian", 400, 2.0, True)])
def test_pieces_match(window, n, slack, clustered):
    jop, top = _ops(window)
    jgeom = jsp.make_se_geometry(jop, n, capacity_slack=slack)
    tgeom = tsp.make_se_geometry(top, n, capacity_slack=slack)
    pos, _ = _system(n, seed=11, clustered=clustered)
    jp = jg.se_bin_and_windows(jgeom, jnp.asarray(pos), jnp.float64)
    tp = tg.se_bin_and_windows(tgeom, torch.as_tensor(pos), torch.float64)
    for name, a, b in zip(("perm", "overflow", "gx0", "gy0"), jp[:4], tp[:4]):
        assert b.dtype in (torch.int32, torch.bool), name
        np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=name)
    for name, a, b in zip(("wx", "wy", "wz"), jp[4:], tp[4:]):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0, atol=PIECE_TOL,
                                   err_msg=name)
    assert bool(tp[1]) == clustered


@pytest.mark.parametrize("window,clustered", [("es", False), ("gaussian", False),
                                              ("es", True)])
def test_plain_matches_pallas_interpret(window, clustered):
    """Plain K5s-rows / K5i-rows vs the Pallas row kernels in interpret
    mode on the same pieces; a bead that binning dropped interpolates to 0."""
    n = 250
    jop, top = _ops(window)
    jgeom = jsp.make_se_geometry(jop, n)
    tgeom = tsp.make_se_geometry(top, n)
    pos, F = _system(n, seed=5, clustered=clustered)
    jp = jg.se_bin_and_windows(jgeom, jnp.asarray(pos), jnp.float64)
    tp = tg.se_bin_and_windows(tgeom, torch.as_tensor(pos), torch.float64)
    assert bool(tp[1]) == bool(jp[1]) == clustered
    want = np.asarray(jg.se_spread_rows_pre(jgeom, jp, jnp.asarray(F), interpret=True))
    got = tg.se_spread_rows_pre(tgeom, tp, torch.as_tensor(F))
    assert got.shape == want.shape and got.dtype == torch.float64
    assert _rel(got.numpy(), want) <= GRID_TOL
    grid = np.random.default_rng(8).normal(size=want.shape)
    want_u = np.asarray(jg.se_interp_rows_pre(jgeom, jp, n, jnp.asarray(grid),
                                              interpret=True))
    got_u = tg.se_interp_rows_pre(tgeom, tp, n, _planar(grid))
    assert _rel(got_u.numpy(), want_u) <= GRID_TOL
    dropped = ~np.isin(np.arange(n), tp[0].numpy())
    assert dropped.any() == clustered
    assert not got_u.numpy()[dropped].any()


@pytest.mark.parametrize("window,clustered", [("es", False), ("gaussian", True)])
def test_dense_trio_and_wave_apply_rows(window, clustered, monkeypatch):
    n = 300
    jop, top = _ops(window)
    jgeom = jsp.make_se_geometry(jop, n)
    tgeom = tsp.make_se_geometry(top, n)
    pos, F = _system(n, seed=7, clustered=clustered)
    jpos, tpos = jnp.asarray(pos), torch.as_tensor(pos)
    jd = jg.se_bin_dense(jgeom, jpos, jnp.float64)
    td = tg.se_bin_dense(tgeom, tpos, torch.float64)
    for name, a, b in zip(("perm", "overflow", "u", "valid"), jd, td):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=name)
    want = np.asarray(jg.se_spread_dense(jgeom, jd, jnp.asarray(F)))
    got = tg.se_spread_dense(tgeom, td, torch.as_tensor(F)).numpy()
    assert _rel(got, want) <= GRID_TOL
    grid = np.random.default_rng(9).normal(size=want.shape)
    want_u = np.asarray(jg.se_interp_dense(jgeom, jd, n, jnp.asarray(grid)))
    assert _rel(tg.se_interp_dense(tgeom, td, n, torch.as_tensor(grid)).numpy(),
                want_u) <= GRID_TOL

    def applies():
        return (("dense", jsp.se_wave_apply_dense(jop, jgeom, jpos, jnp.asarray(F)),
                 tsp.se_wave_apply_dense(top, tgeom, tpos, torch.as_tensor(F))),
                ("rows", jsp.se_wave_apply_rows(jop, jgeom, jpos, jnp.asarray(F),
                                                interpret=True),
                 tsp.se_wave_apply_rows(top, tgeom, tpos, torch.as_tensor(F))))

    for name, (ju, jo), (tu, to) in applies():
        assert bool(to) == bool(jo) == clustered, name
        assert _rel(tu.numpy(), ju) <= FFT_TOL, name
    # the gridding around the FFT: a float64 mode map on both sides
    monkeypatch.setattr(jsp, "_k_apply", lambda op, g: g * 0.5)
    monkeypatch.setattr(tsp, "_k_apply", lambda op, g: g * 0.5)
    for name, (ju, jo), (tu, to) in applies():
        assert bool(to) == bool(jo), name
        assert _rel(tu.numpy(), ju) <= WAVE_TOL, name


def test_wave_apply_rows_takes_pieces():
    """Precomputed pieces give the same u as binning inside the call."""
    n = 200
    _jop, top = _ops("es")
    tgeom = tsp.make_se_geometry(top, n)
    pos, F = _system(n, seed=2)
    tpos, tF = torch.as_tensor(pos), torch.as_tensor(F)
    pieces = tg.se_bin_and_windows(tgeom, tpos, torch.float64)
    u1, o1 = tsp.se_wave_apply_rows(top, tgeom, tpos, tF, pieces=pieces)
    u2, o2 = tsp.se_wave_apply_rows(top, tgeom, tpos, tF)
    assert torch.equal(u1, u2) and not bool(o1) and not bool(o2)


def test_rows_kernel_wrappers_raise_off_the_envelope():
    """Devices other than the CPU and CUDA have no kernel; shapes that do
    not match the geometry raise before any launch."""
    n = 100
    _jop, top = _ops("es")
    tgeom = tsp.make_se_geometry(top, n)
    pos, F = _system(n, seed=1)
    tp = tg.se_bin_and_windows(tgeom, torch.as_tensor(pos), torch.float64)
    with pytest.raises(ValueError, match="no K5s-rows kernel"):
        tg.se_spread_rows_pre(tgeom, tp, torch.as_tensor(F).to("meta"))
    bad = tgeom._replace(R=tgeom.R + 8)
    with pytest.raises(ValueError, match="pieces do not match"):
        tg.se_spread_rows_pre(bad, tp, torch.as_tensor(F))


@pytest.mark.parametrize("window", ["es", "gaussian"])
def test_window_1d_matches(window):
    """The operator's P-point window along one axis (spectral._window_1d)."""
    jop, top = _ops(window)
    frac = np.random.default_rng(12).uniform(0, 1, 50)
    frac[:2] = [0.0, np.nextafter(1.0, 0.0)]
    want = np.asarray(jsp._window_1d(jop, jnp.asarray(frac), jnp.float64))
    got = tsp._window_1d(top, torch.as_tensor(frac), torch.float64)
    assert got.shape == (50, top.support)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=PIECE_TOL * np.abs(want).max())


@pytest.mark.parametrize("G,P", [(64, 6), (72, 10), (16, 6), (384, 6), (40, 16)])
def test_rows_lists_hold_every_spread_term(G, P):
    """The premise of the rows kernels' x-run lists (rows_run_members, the
    pre-pass's plain version): a slot is in run k's spread list exactly when
    one of its P x support points lies in the run, so the list holds every
    slot with a term there, and in exactly one interp list, the run of its
    first support point; no row holds more entries than rows_plan's
    scratch. Positions cluster at x = 0 (supports wrapping onto the last
    run) and at a run's edge."""
    n = 3000
    geom = tg.make_se_grid_rows(G, P, 24.0, 0.87, 0.5, n, min_m=max(8, P // 2 + 1), kind="es",
                                beta=2.0 * P)
    rng = np.random.default_rng(G + P)
    pos = rng.uniform(0, 24.0, (n, 3))
    pos[: n // 3, 0] = np.mod(rng.uniform(-0.4, 0.4, n // 3), 24.0)
    pos[n // 3: n // 2, 0] = np.mod(31.5 * 24.0 / G, 24.0)
    pieces = tg.se_bin_and_windows(geom, torch.as_tensor(pos), torch.float64)
    plan = tg.rows_plan(geom, 8)
    sel = (pieces[0].reshape(-1) < n).nonzero()[:, 0]
    x, _y, _z = tg._rows_support(geom, pieces, sel)
    meets = torch.zeros((sel.shape[0], plan.nxr), dtype=torch.bool)
    meets.scatter_(1, x // tg.RUN_X, True)
    spread = tg.rows_run_members(geom, pieces, n)
    interp = tg.rows_run_members(geom, pieces, n, starts=True)
    assert torch.equal(spread.reshape(-1, plan.nxr)[sel], meets)
    first = torch.zeros_like(meets)
    first[torch.arange(sel.shape[0]), x[:, 0] // tg.RUN_X] = True
    assert torch.equal(interp.reshape(-1, plan.nxr)[sel], first)
    assert not spread.reshape(-1, plan.nxr)[~(pieces[0].reshape(-1) < n)].any()
    per_slot = spread.sum(-1)
    assert int(per_slot.max()) <= plan.max_runs
    assert int(spread.sum((1, 2)).max()) <= plan.spread_lcap
    assert int(interp.sum((1, 2)).max()) <= plan.interp_lcap
    if (G, P) == (72, 10):  # runs of 32, 32 and 8 points: a support can meet all three
        assert plan.max_runs == 3 and int(per_slot.max()) == 3


def test_rows_max_runs():
    """The most runs of 32 x points one wrapped support meets."""
    assert [tg.rows_max_runs(G, P) for G, P in ((384, 6), (64, 6), (16, 6), (32, 8),
                                                (72, 10), (66, 6), (40, 16))] \
        == [2, 2, 1, 1, 3, 3, 2]


def _plan_geom(G, m, P, R):
    return tg.SEGridRows(G=G, m=m, P=P, R=R, box=24.0, c=1.0, kind="es", beta=2.0,
                         wh=0.5 * P)


def test_rows_plan_runs_edge():
    """rows_plan takes MAX_RUNS runs of RUN_X points along x and refuses one
    more, before any launch."""
    G = tg.MAX_RUNS * tg.RUN_X
    assert tg.rows_plan(_plan_geom(G, 8, 6, 8), 4).nxr == tg.MAX_RUNS
    with pytest.raises(ValueError, match=f"{tg.MAX_RUNS + 1} runs of"):
        tg.rows_plan(_plan_geom(G + 8, 8, 6, 8), 4)


def test_rows_plan_list_edge():
    """rows_plan takes the largest R whose x-run lists the kernels index in
    int32 and refuses R + 1."""
    G, m, P = 64, 8, 6
    n_rows, runs = (G // m) ** 2, tg.rows_max_runs(G, P)
    R = ((1 << 31) - 1) // (n_rows * runs)
    assert tg.rows_plan(_plan_geom(G, m, P, R), 4).spread_lcap == R * runs
    with pytest.raises(ValueError, match="int32"):
        tg.rows_plan(_plan_geom(G, m, P, R + 1), 4)


@pytest.mark.parametrize("itemsize", [4, 8])
def test_rows_plan_shared_memory_edge(itemsize):
    """Above some row edge m a block's shared memory passes the SMEM_LIMIT
    bytes a block may use (K5i-rows' chunk sums and one staged plane grow as
    W^2): rows_plan raises there and takes m - 1."""
    P = 6
    m = 8
    while True:
        try:
            plan = tg.rows_plan(_plan_geom(4 * m, m, P, 64), itemsize)
        except ValueError as e:
            assert "shared memory" in str(e) and str(tg.SMEM_LIMIT) in str(e)
            break
        assert max(plan.spread_smem, plan.interp_smem) <= tg.SMEM_LIMIT
        m += 1
    inside = tg.rows_plan(_plan_geom(4 * (m - 1), m - 1, P, 64), itemsize)
    assert max(inside.spread_smem, inside.interp_smem) <= tg.SMEM_LIMIT
    assert m > 32  # the rows kernels take every row edge up to 32


def test_rows_cuda_envelope_returns_the_plan():
    """The wrappers' envelope check (_check_rows_cuda, plain Python) returns
    rows_plan at the pieces' value size and raises on the old limits."""
    n = 500
    geom = tg.make_se_grid_rows(64, 6, 24.0, 0.87, 0.5, n, kind="es", beta=12.0)
    pos = torch.as_tensor(np.random.default_rng(5).uniform(0, 24.0, (n, 3)))
    pieces = tg.se_bin_and_windows(geom, pos, torch.float32)
    assert tg._check_rows_cuda(geom, pieces, ()) == tg.rows_plan(geom, 4)
    with pytest.raises(ValueError, match="row edge"):
        tg._check_rows_cuda(geom._replace(m=2), pieces, ())
