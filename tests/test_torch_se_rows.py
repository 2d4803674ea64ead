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
