"""Row-grid engine and kernel K1 of the torch port vs the JAX reference.

Slot layouts (gid, valid, overflow, sentinel positions) must be bit-equal,
because both engines take two stable sorts and the same scatter. Forces are
compared at the bounds of tests/test_pallas_row_central.py: float64 within
1e-12 max|f| (reduction order only), float32 within 2e-5 max(max|f|, 1).
The CUDA kernel is held against this plain version on the card, in
tests/test_torch_kernels.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mundy_tpu.forces.contact import effective_youngs, hertzian_pair_force
from mundy_tpu.geom import periodic as jax_periodic
from mundy_tpu.neighbor import rows as jr
from mundy_tpu.ops.pallas.row_central import row_hertzian_forces_sym as jax_k1
from mundy_tpu_torch.geom.periodicity import periodic
from mundy_tpu_torch.neighbor import rows as tr
from mundy_tpu_torch.ops.kernels import row_central as k1

torch.set_num_threads(1)

_DT = {"float32": (jnp.float32, torch.float32),
       "float64": (jnp.float64, torch.float64)}


def _grids(box, cutoff, n, dtype, align=8, slack=2.0):
    jd, td = _DT[dtype]
    jg = jr.make_row_grid([0, 0, 0], [box] * 3, cutoff, n, dtype=jd,
                          align=align, capacity_slack=slack)
    tg = tr.make_row_grid([0, 0, 0], [box] * 3, cutoff, n, dtype=td,
                          align=align, capacity_slack=slack)
    return jg, tg


def _built(n, box, cutoff, dtype, seed=3, capacity=None):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0, box, (n, 3))
    jg, tg = _grids(box, cutoff, n, dtype)
    if capacity is not None:
        jg = jg.replace(row_capacity=capacity)
        tg = tg.replace(row_capacity=capacity)
    jd, td = _DT[dtype]
    js = jr.build_rows(jnp.asarray(pos, jd), jnp.arange(n, dtype=jnp.int32), jg)
    ts = tr.build_rows(torch.as_tensor(pos, dtype=td),
                       torch.arange(n, dtype=torch.int32), tg)
    return js, ts


@pytest.mark.parametrize("box,cutoff,n,align", [(12.0, 1.4, 4000, 8),
                                                 (16.0, 1.05, 2000, 8),
                                                 (30.0, 1.4, 500, 1)])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_make_row_grid_fields_equal(box, cutoff, n, align, dtype):
    jg, tg = _grids(box, cutoff, n, dtype, align=align)
    assert (tg.ny, tg.nz, tg.row_capacity) == (jg.ny, jg.nz, jg.row_capacity)
    np.testing.assert_array_equal(tg.origin.numpy(), np.asarray(jg.origin))
    np.testing.assert_array_equal(tg.cell_yz.numpy(), np.asarray(jg.cell_yz))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("capacity", [None, 40])
def test_build_rows_bit_equal(dtype, capacity):
    """capacity=40 sits below the max occupancy of this draw: particles
    past a row's capacity are dropped the same way and flag overflow."""
    js, ts = _built(4000, 12.0, 1.4, dtype, capacity=capacity)
    assert bool(ts.overflow) == bool(js.overflow) == (capacity is not None)
    np.testing.assert_array_equal(ts.gid.numpy(), np.asarray(js.gid))
    np.testing.assert_array_equal(ts.valid.numpy(), np.asarray(js.valid))
    np.testing.assert_array_equal(ts.pos.numpy(), np.asarray(js.pos))
    np.testing.assert_array_equal(ts.ref_pos.numpy(), np.asarray(js.ref_pos))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_rows_to_flat_and_skin_equal(dtype):
    n, box = 2000, 16.0
    js, ts = _built(n, box, 1.05, dtype, seed=4)
    np.testing.assert_array_equal(tr.rows_to_flat(ts, n).numpy(),
                                  np.asarray(jr.rows_to_flat(js, n)))
    jd, td = _DT[dtype]
    jm = jax_periodic(np.array([box] * 3), dtype=jd)
    tm = periodic([box] * 3, dtype=td)
    rng = np.random.default_rng(9)
    kick = rng.normal(scale=0.03, size=tuple(ts.pos.shape))
    for skin in (0.05, 0.1, 0.2):
        jmoved = js.replace(pos=jm.wrap(js.pos + jnp.asarray(kick, jd)))
        tmoved = ts.replace(pos=tm.wrap(ts.pos + torch.as_tensor(kick, dtype=td)))
        np.testing.assert_array_equal(tmoved.pos.numpy(), np.asarray(jmoved.pos))
        assert (bool(tr.moved_beyond_skin(tmoved, tm, skin))
                == bool(jr.moved_beyond_skin(jmoved, jm, skin)))


def _jax_scalar_fn(dtype, radius=0.5, youngs=1000.0, poisson=0.3):
    e_eff = jnp.asarray(effective_youngs(youngs, youngs, poisson, poisson), dtype)
    two_r = jnp.asarray(2 * radius, dtype)
    r_eff = jnp.asarray(0.5 * radius, dtype)

    def fn(r2):
        r2 = jnp.maximum(r2, 1e-24)
        rinv = jax.lax.rsqrt(r2)
        mag = hertzian_pair_force(r2 * rinv - two_r, r_eff, e_eff)
        return -mag * rinv

    return fn


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("n,box,cutoff", [(4000, 12.0, 1.4), (2000, 16.0, 1.05)])
def test_k1_plain_matches_jax_xla(dtype, n, box, cutoff):
    js, ts = _built(n, box, cutoff, dtype)
    boxs = ((box,) * 3, (True,) * 3)
    jd, _ = _DT[dtype]
    got = k1.row_hertzian_forces_sym(ts.pos, (box,) * 3, 0.5, 1000.0, 0.3).numpy()
    assert got.shape == tuple(ts.pos.shape)
    for jax_fn in (jr.pair_accumulate_central_sym, jr.pair_accumulate_central):
        ref = np.asarray(jax_fn(js, boxs, _jax_scalar_fn(jd)))
        fmax = np.abs(ref).max()
        assert fmax > 0  # the draw has contacts
        if dtype == "float64":
            assert np.abs(got - ref).max() <= 1e-12 * fmax
        else:
            assert np.abs(got - ref).max() <= 2e-5 * max(fmax, 1.0)


def test_k1_plain_matches_pallas_interpret():
    """The TPU kernel itself (interpret mode) at the _setup of
    tests/test_pallas_row_central.py, on valid slots."""
    js, ts = _built(4000, 12.0, 1.4, "float32")
    ref = np.asarray(jax_k1(js.pos, (12.0,) * 3, 0.5, 1000.0, 0.3,
                            interpret=True))
    got = k1.row_hertzian_forces_sym(ts.pos, (12.0,) * 3, 0.5, 1000.0, 0.3).numpy()
    m = np.asarray(js.valid)
    a, b = ref[m], got[m]
    assert np.abs(a - b).max() <= 2e-5 * max(np.abs(a).max(), 1.0)


def test_k1_rejects_small_grids():
    pos = torch.zeros((4, 8, 16, 3))
    with pytest.raises(ValueError):
        k1.row_hertzian_forces_sym(pos, (10.0,) * 3, 0.5, 1000.0, 0.3)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_k1_early_stop_rejects_only_pairs_that_add_zero(dtype):
    """K1 stops a pair when contact_reach rejects its r2; the plain version
    gives every such pair an exactly zero force. On 600 random spheres plus
    pairs along x a few ulp either side of contact (2r = 1) and of the
    early stop's cut (2r)^2 (1 + 2^-10), the same across the x wrap, and a
    coincident pair, over the full 9-row stencil."""
    td = _DT[dtype][1]
    n, box, radius = 600, 9.0, 0.5
    rng = np.random.default_rng(31)
    pos = rng.uniform(0, box, (n, 3))
    eps = float(torch.finfo(td).eps)
    cut = float(torch.sqrt(torch.tensor(1.0, dtype=td) * k1.REACH_MARGIN))
    # (own x, candidate x, in contact (None: within rounding of 2r), kept by
    # the early stop)
    placed = [(2.0, 2.999, True, True), (0.25, 0.25 - 0.999 + box, True, True),
              (7.0, 7.0, False, True)]  # the last pair coincident
    for k in (-3, -1, 1, 3):
        placed.append((2.0, 3.0 + 4 * k * eps, None if k < 0 else False, True))
        placed.append((0.25, 0.25 - (1.0 + 4 * k * eps) + box, None if k < 0 else False,
                       True))
        placed.append((5.0, 5.0 + cut * (1 + 8 * k * eps), False, k < 0))
    for i, (xo, xc, _, _) in enumerate(placed):
        yz = 0.3 + (box - 0.6) * i / len(placed)
        pos[2 * i], pos[2 * i + 1] = [xo, yz, yz], [xc, yz, yz]
    tg = tr.make_row_grid([0, 0, 0], [box] * 3, 1.4, n, dtype=td, align=1)
    ts = tr.build_rows(torch.as_tensor(pos, dtype=td), torch.arange(n, dtype=torch.int32), tg)
    gid = torch.where(ts.valid, ts.gid, -1).to(td)
    cx, cy, cz, (cg,) = tr._candidate_planes(ts.pos, ((box,) * 3, (True,) * 3), (gid,))
    ox, oy, oz = ts.pos.unbind(-1)
    # the plain version's pair arithmetic (rows._central_force_chunk_sym)
    dx = cx[..., None, :] - ox[..., :, None]
    dx = dx - box * torch.round(dx * (1.0 / box))
    dy = cy[..., None, :] - oy[..., :, None]
    dz = cz[..., None, :] - oz[..., :, None]
    r2 = dx * dx + dy * dy + dz * dz
    w = k1.hertz_scalar_fn(radius, 1000.0, 0.3, td, "cpu")(r2)
    terms = torch.stack([w * dx, w * dy, w * dz], dim=-1)
    keep = k1.contact_reach(r2, radius)
    assert bool((terms[~keep] == 0).all())
    og = gid[..., :, None].expand_as(keep)
    cg = cg[..., None, :].expand_as(keep)
    both = (og >= 0) & (cg >= 0)
    assert 0.9 < float((~keep[both]).double().mean()) < 1.0
    assert bool((terms[keep & both].abs().amax(-1) > 0).any())
    for i, (_, _, touch, kept) in enumerate(placed):
        pair = (og == 2 * i) & (cg == 2 * i + 1)
        assert int(pair.sum()) == 1
        assert bool(keep[pair]) == kept
        if touch is not None:
            assert bool(terms[pair].abs().max() > 0) == touch


def test_k1_mask_is_checked_and_optional():
    """The mask the app passes must be build_rows' (ny, nz, R) bool mask;
    on the CPU the wrapper computes the plain version with or without it."""
    _, ts = _built(2000, 16.0, 1.05, "float64", seed=4)
    args = ((16.0,) * 3, 0.5, 1000.0, 0.3)
    with pytest.raises(ValueError, match="valid"):
        k1.row_hertzian_forces_sym(ts.pos, *args, valid=ts.valid[..., :-1])
    with pytest.raises(ValueError, match="valid"):
        k1.row_hertzian_forces_sym(ts.pos, *args, valid=ts.valid.int())
    got = k1.row_hertzian_forces_sym(ts.pos, *args, valid=ts.valid)
    assert torch.equal(got, k1.row_hertzian_forces_sym(ts.pos, *args))
    assert bool((got[~ts.valid] == 0).all())
