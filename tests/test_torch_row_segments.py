"""Segment-segment row contact (kernel K4's plain path) vs the JAX reference.

The torch `pair_accumulate_segments` and the K4 wrapper's plain version
take the same numpy inputs as the JAX `pair_accumulate_segments` with the
rods closure (driver/apps/rods_rows.py): float64 within 1e-10 of each
output group's max (force planes, torque planes), since both sides take the
same operations and differ only in the order of the candidate sums.
float32 is held against the TPU kernel itself in interpret mode within
5e-4 of the max, the bound of tests/test_pallas_row_segments.py (rsqrt and
summation order). The CUDA kernel is held against this plain version on the
card, in tests/test_torch_kernels.py. The rods kernel evaluates only the
pairs that pass `segment_reach`; every pair the test rejects is held here
to an exactly zero force and torque in the plain version, in both dtypes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mundy_tpu.forces.contact import effective_youngs, hertzian_pair_force
from mundy_tpu.neighbor import rows as jr
from mundy_tpu.ops.pallas.row_segments import row_segment_pairs_sym as jax_k4
from mundy_tpu_torch.neighbor import rows as tr
from mundy_tpu_torch.ops.kernels import row_segments as k4

torch.set_num_threads(1)

RADIUS, LENGTH = 0.2, 0.8
E_EFF = float(effective_youngs(200.0, 200.0, 0.3, 0.3))
_DT = {"float32": (jnp.float32, torch.float32),
       "float64": (jnp.float64, torch.float64)}


def _unit(rng, n):
    q = rng.normal(size=(n, 3))
    return q / np.linalg.norm(q, axis=1, keepdims=True)


def _setup(dtype, n=600, box=12.8, cutoff=1.6, seed=7, pos=None, axes=None):
    """Rows of both engines from one numpy draw: tests/test_pallas_row_segments
    .py's setup (600 rods, box 12.8, cutoff 1.6: 8 cells per axis) by
    default."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0, box, (n, 3)) if pos is None else pos
    axes = _unit(rng, n) if axes is None else axes
    jd, td = _DT[dtype]
    jg = jr.make_row_grid([0, 0, 0], [box] * 3, cutoff, n, dtype=jd, align=8)
    tg = tr.make_row_grid([0, 0, 0], [box] * 3, cutoff, n, dtype=td, align=8)
    js = jr.build_rows(jnp.asarray(pos, jd), jnp.arange(n, dtype=jnp.int32), jg)
    ts = tr.build_rows(torch.as_tensor(pos, dtype=td), torch.arange(n, dtype=torch.int32), tg)
    valid = np.asarray(js.valid)
    gid = np.minimum(np.asarray(js.gid), n - 1)
    hedges = np.where(valid[..., None], 0.5 * LENGTH * axes[gid], 0.0)
    return js, ts, hedges, box


def _jax_out_fn(s, t, dx, dy, dz, d2, oex, _cex, oey, _cey, oez, _cez):
    """The rods out_fn of driver/apps/rods_rows.py."""
    d2c = jnp.maximum(d2, 1e-24)
    rinv = jax.lax.rsqrt(d2c)
    dist = d2c * rinv
    mag = hertzian_pair_force(dist - 2 * RADIUS, 0.5 * RADIUS, E_EFF)
    w = -(mag * rinv)
    fx, fy, fz = w * dx, w * dy, w * dz
    u2 = 2.0 * s - 1.0
    rr = RADIUS * rinv
    px, py, pz = u2 * oex + rr * dx, u2 * oey + rr * dy, u2 * oez + rr * dz
    return (fx, fy, fz, py * fz - pz * fy, pz * fx - px * fz, px * fy - py * fx)


def _jax_partner_fn(s, t, dx, dy, dz, d2, _oex, cex, _oey, cey, _oez, cez):
    d2c = jnp.maximum(d2, 1e-24)
    rinv = jax.lax.rsqrt(d2c)
    dist = d2c * rinv
    mag = hertzian_pair_force(dist - 2 * RADIUS, 0.5 * RADIUS, E_EFF)
    w = -(mag * rinv)
    gx, gy, gz = -(w * dx), -(w * dy), -(w * dz)
    v2 = 2.0 * t - 1.0
    rr = RADIUS * rinv
    px, py, pz = v2 * cex - rr * dx, v2 * cey - rr * dy, v2 * cez - rr * dz
    return (gx, gy, gz, py * gz - pz * gy, pz * gx - px * gz, px * gy - py * gx)


def _jax_ref(js, hedges, box, dtype):
    jd, _ = _DT[dtype]
    h = jnp.asarray(hedges, jd)
    out = jr.pair_accumulate_segments(js, ((box,) * 3, (True,) * 3), h, _jax_out_fn,
                                      extra_fields=(h[..., 0], h[..., 1], h[..., 2]))
    return np.stack(out[:3], -1), np.stack(out[3:], -1)


def _torch_k4(ts, hedges, box, dtype):
    f, t = k4.row_segment_pairs_sym(ts.pos, torch.as_tensor(hedges, dtype=_DT[dtype][1]),
                                    ts.valid, (box,) * 3, RADIUS, E_EFF)
    return f.numpy(), t.numpy()


def _close(got, ref, rel):
    for g, r in zip(got, ref):
        scale = np.abs(r).max()
        assert scale > 0  # the draw has contacts
        assert np.isfinite(g).all()
        assert np.abs(g - r).max() <= rel * scale, (np.abs(g - r).max(), scale)


@pytest.mark.parametrize("n,box,cutoff,ncell", [(600, 12.8, 1.6, 8), (300, 8.5, 1.6, 5)])
def test_plain_matches_jax_float64(n, box, cutoff, ncell):
    """The K4 wrapper on CPU tensors (its plain version) against the JAX
    pair_accumulate_segments; the second case is the small box with
    ny = nz = 5, the least the row engine takes."""
    js, ts, hedges, box = _setup("float64", n=n, box=box, cutoff=cutoff)
    assert (ts.grid.ny, ts.grid.nz) == (ncell, ncell)
    _close(_torch_k4(ts, hedges, box, "float64"), _jax_ref(js, hedges, box, "float64"),
           1e-10)


def test_plain_matches_pallas_interpret_float32():
    """The TPU kernel itself, in interpret mode, as
    tests/test_pallas_row_segments.py:88-102 runs it on the CPU."""
    js, ts, hedges, box = _setup("float32")
    ref = jax_k4(js.pos, jnp.asarray(hedges, jnp.float32), (box,) * 3,
                 _jax_out_fn, _jax_partner_fn, 6, interpret=True)
    ref = (np.stack(ref[:3], -1), np.stack(ref[3:], -1))
    _close(_torch_k4(ts, hedges, box, "float32"), ref, 5e-4)


def test_scalar_payload_and_chunking_match_jax():
    """pair_accumulate_segments with a scalar extra field (a gid payload
    that excludes chain neighbours, the filaments usage) against JAX in
    float64, and y-chunked under a small byte budget against one chunk:
    the chunks take the same operations, so the two are bit-equal."""
    js, ts, hedges, box = _setup("float64", n=400, seed=11)
    gid_j = jnp.where(js.valid, js.gid.astype(jnp.float64), -10.0)
    gid_t = torch.where(ts.valid, ts.gid.to(torch.float64), -10.0)

    def mk(where, abs_, rsqrt, clamp):
        def fn(s, t, dx, dy, dz, d2, own_g, cand_g):
            d2c = clamp(d2)
            rinv = rsqrt(d2c)
            adjacent = abs_(abs_(cand_g - own_g) - 1.0) < 0.5
            w = where(adjacent, 0.0, -(1.0 - d2c * rinv) * rinv)
            w = where(d2c * rinv < 2 * RADIUS, w, 0.0)
            return ((1.0 - s) * w * dx, (1.0 - s) * w * dy, (1.0 - s) * w * dz, s * w * dx)
        return fn

    boxs = ((box,) * 3, (True,) * 3)
    h = jnp.asarray(hedges)
    ref = jr.pair_accumulate_segments(
        js, boxs, h, mk(jnp.where, jnp.abs, jax.lax.rsqrt, lambda x: jnp.maximum(x, 1e-24)),
        extra_fields=(gid_j,))
    t_fn = mk(torch.where, torch.abs, torch.rsqrt, lambda x: torch.clamp(x, min=1e-24))
    th = torch.as_tensor(hedges)
    got = tr.pair_accumulate_segments(ts.pos, boxs, th, t_fn, extra_fields=(gid_t,))
    scale = max(np.abs(np.asarray(r)).max() for r in ref)
    assert scale > 0
    for g, r in zip(got, ref):
        assert np.abs(g.numpy() - np.asarray(r)).max() <= 1e-10 * scale
    one_row = tr.pair_accumulate_segments(ts.pos, boxs, th, t_fn, extra_fields=(gid_t,),
                                          hbm_budget_bytes=1.0)
    for a, b in zip(got, one_row):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_coincident_and_parallel_rods(dtype):
    """Two coincident rods (one midpoint, one axis), a pair of exactly
    parallel overlapping rods 0.3 apart, and a crossed pair, far from the
    random rest: outputs are finite, the coincident rods feel nothing (the
    noise floor's exact zero), the other pairs push equal and opposite, and
    float64 matches JAX."""
    n, box = 300, 12.8
    rng = np.random.default_rng(5)
    pos = rng.uniform(0, box, (n, 3))
    axes = _unit(rng, n)
    far = np.abs(pos - np.array([6.4, 6.4, 6.4])).max(axis=1) < 3.0
    pos[far] += 6.4  # empty a cube of edge 6 around the test rods
    pos %= box
    pos[:6] = [[6.0, 6.0, 6.0], [6.0, 6.0, 6.0], [6.0, 7.0, 6.5], [6.0, 7.3, 6.7],
               [7.5, 5.5, 5.5], [7.5, 5.8, 5.5]]
    axes[:6] = [[1, 0, 0], [1, 0, 0], [0, 0, 1], [0, 0, 1], [1, 0, 0], [0, 0, 1]]
    js, ts, hedges, box = _setup(dtype, n=n, box=box, pos=pos, axes=axes)
    f, t = _torch_k4(ts, hedges, box, dtype)
    assert np.isfinite(f).all() and np.isfinite(t).all()
    flat = tr.rows_to_flat(ts.replace(pos=torch.as_tensor(f)), n).numpy()
    flat_t = tr.rows_to_flat(ts.replace(pos=torch.as_tensor(t)), n).numpy()
    assert (flat[:2] == 0).all() and (flat_t[:2] == 0).all()
    for i in (2, 4):
        assert np.abs(flat[i]).max() > 0
        np.testing.assert_allclose(flat[i], -flat[i + 1], rtol=1e-5, atol=0)
    if dtype == "float64":
        _close((f, t), _jax_ref(js, hedges, box, dtype), 1e-10)


def test_wrapper_checks():
    pos = torch.zeros((8, 8, 16, 3))
    valid = torch.ones((8, 8, 16), dtype=torch.bool)
    with pytest.raises(ValueError, match="ny, nz >= 5"):
        k4.row_segment_pairs_sym(pos[:4], pos[:4], valid[:4], (10.0,) * 3, 0.25, 500.0)
    with pytest.raises(TypeError, match="float32 or float64"):
        k4.row_segment_pairs_sym(pos, pos.double(), valid, (10.0,) * 3, 0.25, 500.0)
    with pytest.raises(ValueError, match="must match"):
        k4.row_segment_pairs_sym(pos, pos[:, :, :8], valid, (10.0,) * 3, 0.25, 500.0)
    with pytest.raises(ValueError, match="bool"):
        k4.row_segment_pairs_sym(pos, pos, valid[:, :, :8], (10.0,) * 3, 0.25, 500.0)
    with pytest.raises(ValueError, match="bool"):
        k4.row_segment_pairs_sym(pos, pos, valid.int(), (10.0,) * 3, 0.25, 500.0)


def _pair_planes(ts, hedges, box, dtype):
    """Every (own slot, candidate) pair of the 9-row stencil, through the
    plain version's own segment_pair_terms: the rods op's six outputs per
    pair (..., 6), the kernel's reach test, and the own and candidate gids
    (-1 on invalid slots)."""
    td = _DT[dtype][1]
    he = torch.as_tensor(hedges, dtype=td)
    hx, hy, hz = he.unbind(-1)
    lens = k4.half_edge_lengths(he)
    gid = torch.where(ts.valid, ts.gid, -1).to(td)
    cx, cy, cz, (cex, cey, cez, cl, cg) = tr._candidate_planes(
        ts.pos, ((box,) * 3, (True,) * 3), (hx, hy, hz, lens, gid))
    ox, oy, oz = ts.pos.unbind(-1)
    (sx, sy, sz), out = tr.segment_pair_terms(
        ox, oy, oz, hx, hy, hz, (hx, hy, hz), cx, cy, cz, cex, cey, cez,
        (cex, cey, cez), k4.rods_out_fn(RADIUS, E_EFF, td, "cpu"), (box, 1.0 / box))
    keep = k4.segment_reach(sx, sy, sz, lens[..., :, None], cl[..., None, :], RADIUS)
    return (torch.stack(torch.broadcast_tensors(*out), -1), keep,
            gid[..., :, None].expand_as(keep), cg[..., None, :].expand_as(keep))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_reach_rejects_only_pairs_that_add_zero(dtype):
    """The rods kernel skips a pair when segment_reach rejects it; the plain
    version gives every such pair an exactly zero force and torque. On 600
    random rods plus collinear pairs (reach 2 |e| + 2r = 1.2) placed just
    inside contact, just inside the margin (kept, no contact) and just
    outside it (rejected), the same across the x wrap, and a coincident
    pair."""
    n, box = 600, 12.8
    rng = np.random.default_rng(23)
    pos = rng.uniform(0, box, (n, 3))
    axes = _unit(rng, n)
    reach = 2 * 0.5 * LENGTH + 2 * RADIUS
    # (own x, candidate x, y = z, in contact, kept by the reach test)
    placed = [(2.0, 2.0 + reach * (1 - 1e-3), 2.0, True, True),
              (2.0, 2.0 + reach * (1 + 2e-4), 3.6, False, True),
              (2.0, 2.0 + reach * (1 + 2e-3), 5.2, False, False),
              (0.05, 0.05 - reach * (1 - 1e-3) + box, 6.8, True, True),
              (0.05, 0.05 - reach * (1 + 2e-4) + box, 8.4, False, True),
              (0.05, 0.05 - reach * (1 + 2e-3) + box, 10.0, False, False),
              (9.0, 9.0, 11.6, False, True)]  # coincident
    for i, (xo, xc, yz, _, _) in enumerate(placed):
        pos[2 * i], pos[2 * i + 1] = [xo, yz, yz], [xc, yz, yz]
        axes[2 * i] = axes[2 * i + 1] = [1.0, 0.0, 0.0]
    _, ts, hedges, box = _setup(dtype, n=n, box=box, pos=pos, axes=axes)
    out, keep, og, cg = _pair_planes(ts, hedges, box, dtype)
    assert bool((out[~keep] == 0).all())
    assert 0.5 < float((~keep).double().mean()) < 1.0
    assert bool((out[keep].abs().amax(-1) > 0).any())
    for i, (_, _, _, touch, kept) in enumerate(placed):
        pair = (og == 2 * i) & (cg == 2 * i + 1)
        assert int(pair.sum()) == 1
        assert bool(keep[pair]) == kept
        assert bool((out[pair].abs().max() > 0)) == touch


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_reach_rejects_only_filament_pairs_that_add_zero(dtype):
    """The filaments op skips a pair when segment_reach (with the filaments
    radius) rejects it; the plain version's filaments out_fn gives every
    such pair exactly zero node forces. On 40 random chains of 7 unit
    segments plus collinear pairs (reach 2 |e| + 2r = 1.5) just inside
    contact, just inside the margin and just outside it, across the x wrap
    too, each once between two filaments and once between adjacent
    segments of one filament, and a coincident pair."""
    td = _DT[dtype][1]
    radius, e_eff, E, box = 0.25, 274.725, 6, 14.0
    rng = np.random.default_rng(41)
    F = 40
    d = rng.normal(size=(F, 1, 3)) + 0.3 * rng.normal(size=(F, E, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    start = rng.uniform(0, box, (F, 1, 3))
    nodes = np.concatenate([start, start + np.cumsum(d, axis=1)], axis=1)
    mid = np.mod(0.5 * (nodes[:, :-1] + nodes[:, 1:]), box).reshape(-1, 3)
    he = (0.5 * (nodes[:, 1:] - nodes[:, :-1])).reshape(-1, 3)
    reach = 2 * 0.5 + 2 * radius
    # (own x, candidate x, in contact, kept by the reach test)
    placed = [(2.0, 2.0 + reach * (1 - 1e-3), True, True),
              (2.0, 2.0 + reach * (1 + 2e-4), False, True),
              (2.0, 2.0 + reach * (1 + 2e-3), False, False),
              (0.05, 0.05 - reach * (1 - 1e-3) + box, True, True),
              (0.05, 0.05 - reach * (1 + 2e-4) + box, False, True),
              (0.05, 0.05 - reach * (1 + 2e-3) + box, False, False),
              (9.0, 9.0, False, True)]  # coincident
    S = F * E
    # pair i takes segments 2i, 2i + 1: gids 2i, 2i + 1 (adjacent in one
    # filament) for even i; for odd i the second takes the gid of a far
    # segment (two filaments)
    gid = np.arange(S)
    for i, (xo, xc, _, _) in enumerate(placed):
        yz = 0.5 + (box - 1.0) * i / len(placed)
        mid[2 * i], mid[2 * i + 1] = [xo, yz, yz], [xc, yz, yz]
        he[2 * i] = he[2 * i + 1] = [0.5, 0.0, 0.0]
        if i % 2:
            far = S - 1 - 2 * i
            gid[2 * i + 1], gid[far] = gid[far], gid[2 * i + 1]
    tg = tr.make_row_grid([0, 0, 0], [box] * 3, 1.8, S, dtype=td, align=1)
    ts = tr.build_rows(torch.as_tensor(mid, dtype=td), torch.as_tensor(gid, dtype=torch.int32),
                       tg)
    by_gid = {int(g): k for k, g in enumerate(gid)}
    slot_seg = torch.as_tensor([by_gid[int(g)] for g in ts.gid.flatten()],
                               dtype=torch.long).reshape(ts.gid.shape)
    he_rows = torch.where(ts.valid[..., None], torch.as_tensor(he, dtype=td)[slot_seg], 0.0)
    hx, hy, hz = he_rows.unbind(-1)
    lens = k4.half_edge_lengths(he_rows)
    g_f = torch.where(ts.valid, ts.gid.to(td), -10.0)
    cx, cy, cz, (cex, cey, cez, cl, cg) = tr._candidate_planes(
        ts.pos, ((box,) * 3, (True,) * 3), (hx, hy, hz, lens, g_f))
    ox, oy, oz = ts.pos.unbind(-1)
    (sx, sy, sz), out = tr.segment_pair_terms(
        ox, oy, oz, hx, hy, hz, (g_f,), cx, cy, cz, cex, cey, cez, (cg,),
        k4.filaments_out_fn(radius, e_eff, E), (box, 1.0 / box))
    out = torch.stack(torch.broadcast_tensors(*out), -1)
    keep = k4.segment_reach(sx, sy, sz, lens[..., :, None], cl[..., None, :], radius)
    assert bool((out[~keep] == 0).all())
    og = g_f[..., :, None].expand_as(keep)
    cg = cg[..., None, :].expand_as(keep)
    both = (og >= 0) & (cg >= 0)
    assert 0.5 < float((~keep[both]).double().mean()) < 1.0
    assert bool((out[keep & both].abs().amax(-1) > 0).any())
    for i, (_, _, touch, kept) in enumerate(placed):
        pair = (og == int(gid[2 * i])) & (cg == int(gid[2 * i + 1]))
        assert int(pair.sum()) == 1
        assert bool(keep[pair]) == kept
        adjacent = abs(int(gid[2 * i + 1]) - int(gid[2 * i])) == 1
        assert adjacent == (i % 2 == 0)
        assert bool(out[pair].abs().max() > 0) == (touch and not adjacent)
