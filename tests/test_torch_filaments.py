"""The modules of config #4 (flexible filaments) that hold or feed a
kernel: the torch port vs the JAX reference (the app end to end is in
test_torch_filaments_app.py).

Same numpy inputs to both, made from a seed. Tolerances:
- segment_closest_planes, float64: within 1e-12 of each output's largest
  magnitude (the same operations in the same order);
- neighbor_matrix with the exclude table and rows_extract_feasible on CPU
  tensors: equal;
- kernel K4's filaments op, plain version, against the JAX
  pair_accumulate_segments with the filaments out_fn: float64 within 1e-12
  of max|out|; float32 against the reference run op by op within 1e-6 of
  it (summation order; see test_filaments_op_plain_matches_reference).
The CUDA op is held against its plain version on the card, in
tests/test_torch_kernels.py.
"""

import jax

if __name__ == "__main__":  # run as a script: tests/conftest.py's settings
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np
import pytest
import torch

from mundy_tpu.forces.contact import hertzian_pair_force as j_hertz
from mundy_tpu.geom import periodic as j_periodic
from mundy_tpu.geom.distance import segment_closest_planes as j_closest
from mundy_tpu.neighbor import cell_list as jc
from mundy_tpu.neighbor import rows as jr
from mundy_tpu_torch.geom.distance import segment_closest_planes
from mundy_tpu_torch.geom.periodicity import periodic
from mundy_tpu_torch.neighbor import cell_list as tc
from mundy_tpu_torch.neighbor import rows as tr
from mundy_tpu_torch.ops.kernels import row_segments as k4

torch.set_num_threads(1)

_DT = {"float32": (jnp.float32, torch.float32), "float64": (jnp.float64, torch.float64)}


def _close(got, ref, tol):
    ref = np.asarray(ref)
    got = got.numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol * max(np.abs(ref).max(), 1e-300))


def test_segment_closest_planes_matches():
    """Random pairs, with parallel, coincident and point-like segments among
    them."""
    rng = np.random.default_rng(2)
    n, k = 64, 9
    S = rng.normal(size=(3, k, n))
    oe = rng.normal(size=(3, 1, n)) * 0.5
    ce = rng.normal(size=(3, k, n)) * 0.5
    ce[:, 0] = oe[:, 0]             # parallel, offset
    S[:, 1], ce[:, 1] = 0.0, oe[:, 0]  # coincident
    ce[:, 2] = 0.0                  # point-like candidate
    got = segment_closest_planes(*(torch.as_tensor(a) for a in (*S, *oe, *ce)))
    ref = j_closest(*(jnp.asarray(a) for a in (*S, *oe, *ce)))
    for g, r in zip(got, ref):
        _close(g, r, 1e-12)
    assert float(got[5][1].abs().max()) == 0.0  # the coincident floor


def _chain_mids(F, M, box, seed, dense=False):
    """Midpoints and half-edges of F random straight-ish chains; with
    `dense`, filament 1 starts where filament 0 ends (gids E - 1 and E,
    adjacent but on two filaments, touch)."""
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(F, 1, 3)) + 0.3 * rng.normal(size=(F, M - 1, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    start = rng.uniform(0, box, (F, 1, 3))
    if dense:
        start[1, 0] = start[0, 0] + d[0].sum(0) + 0.1
    pos = np.concatenate([start, start + np.cumsum(d, axis=1)], axis=1)
    a, b = pos[:, :-1].reshape(-1, 3), pos[:, 1:].reshape(-1, 3)
    return np.mod(0.5 * (a + b), box), 0.5 * (b - a)


def _jax_filaments_op(js, row_e, box, radius, e_eff, E, jd):
    """The reference's rows narrow phase (driver/apps/filaments.py
    _contact_node_forces_rows, its pair_accumulate_segments branch)."""
    two_r, r_eff = 2.0 * radius, 0.5 * radius

    def out_fn(s, t, dx, dy, dz, d2, own_g, cand_g):
        d2c = jnp.maximum(d2, 1e-24)
        rinv = jax.lax.rsqrt(d2c)
        mag = j_hertz(d2c * rinv - two_r, r_eff, e_eff)
        dg = cand_g - own_g
        min_g = jnp.minimum(own_g, cand_g)
        adjacent = (jnp.abs(jnp.abs(dg) - 1.0) < 0.5) & (
            jnp.abs(jnp.mod(min_g, float(E)) - (E - 1)) > 0.5)
        w = jnp.where(adjacent, 0.0, -(mag * rinv))
        fx, fy, fz = w * dx, w * dy, w * dz
        return ((1.0 - s) * fx, (1.0 - s) * fy, (1.0 - s) * fz, s * fx, s * fy, s * fz)

    box_l = jr.orthorhombic_lengths(j_periodic(np.array([box] * 3), dtype=jd))

    @jax.jit
    def run(js, row_e):
        gid_f = jnp.where(js.valid, js.gid.astype(jd), jnp.asarray(-10.0, jd))
        out = jr.pair_accumulate_segments(js, box_l, row_e, out_fn, extra_fields=(gid_f,))
        return jnp.stack(out[:3], -1), jnp.stack(out[3:], -1)

    return run(js, jnp.asarray(row_e, jd))


_OP_CASES = [("float64", 60, 6, 9.5), ("float64", 200, 9, 12.0), ("float32", 60, 6, 9.5),
             ("float32", 120, 7, 11.0), ("float32", 200, 9, 12.0)]
_RADIUS, _E_EFF = 0.25, 274.725


def _op_case(dtype, F, M, box):
    """The row layouts of F chains of M nodes in both packages, and the
    (ny, nz, R, 3) half-edges: (js, ts, row_e, E)."""
    jd, td = _DT[dtype]
    mid, e = _chain_mids(F, M, box, seed=F, dense=True)
    E = M - 1
    S = F * E
    jg = jr.make_row_grid([0, 0, 0], [box] * 3, 1.8, S, dtype=jd, align=8)
    tg = tr.make_row_grid([0, 0, 0], [box] * 3, 1.8, S, dtype=td, align=8)
    js = jr.build_rows(jnp.asarray(mid, jd), jnp.arange(S, dtype=jnp.int32), jg)
    ts = tr.build_rows(torch.as_tensor(mid, dtype=td), torch.arange(S, dtype=torch.int32), tg)
    valid = np.asarray(js.valid)
    row_e = np.where(valid[..., None], e[np.minimum(np.asarray(js.gid), S - 1)], 0.0)
    return js, ts, row_e, E


def _port_op(ts, row_e, box, E, op=k4.row_segment_filaments_sym):
    return op(ts.pos, torch.as_tensor(row_e, dtype=ts.pos.dtype), ts.valid, ts.gid,
              (box,) * 3, _RADIUS, _E_EFF, E)


@pytest.mark.parametrize("dtype,F,M,box", _OP_CASES)
def test_filaments_op_plain_matches_reference(dtype, F, M, box):
    """The box of 200 x 9 (a volume fraction near 0.25) holds nearly
    intersecting pairs (d2 ~ 1e-7), where the closest vector cancels O(1)
    terms, so float32 sits ~1e-4 of the max from float64 there, in the
    reference and in this version alike. Jitted, XLA's CPU backend
    contracts multiply-adds into FMAs, which round such pairs differently.
    The float32 reference therefore runs op by op, each primitive compiled
    alone, so it rounds as this version does: the two differ in summation
    order only. `PYTHONPATH=. python tests/test_torch_filaments.py` prints the
    readings."""
    jd = _DT[dtype][0]
    js, ts, row_e, E = _op_case(dtype, F, M, box)
    if dtype == "float32":
        with jax.disable_jit():
            ref = _jax_filaments_op(js, row_e, box, _RADIUS, _E_EFF, E, jd)
    else:
        ref = _jax_filaments_op(js, row_e, box, _RADIUS, _E_EFF, E, jd)
    before = k4.row_segment_filaments_sym.launches
    got = _port_op(ts, row_e, box, E)
    assert k4.row_segment_filaments_sym.launches == before  # CPU: the plain version
    plain = _port_op(ts, row_e, box, E, op=k4.row_segment_filaments_plain)
    tol = 1e-12 if dtype == "float64" else 1e-6
    for g, p, r in zip(got, plain, ref):
        assert torch.equal(g, p)
        assert r.dtype == jd
        assert float(np.abs(np.asarray(r)).max()) > 0
        _close(g, r, tol)


def _f32_readings() -> None:
    """For each float32 case, max |a - b| / max |b| of f_start and of f_end:
    a = the reference jitted and this version, b = the reference's float64;
    a = this version, b = the reference jitted and run op by op. Run with
    XLA_FLAGS=--xla_cpu_max_isa=SSE4_2 to take FMA away from XLA."""
    def rel(a, b):
        out = []
        for x, y in zip(a, b):
            x, y = np.asarray(x, np.float64), np.asarray(y, np.float64)
            out.append(f"{np.abs(x - y).max() / np.abs(y).max():.3e}")
        return " ".join(out)

    for _, F, M, box in (c for c in _OP_CASES if c[0] == "float32"):
        js64, _, row_e, E = _op_case("float64", F, M, box)
        js, ts, _, _ = _op_case("float32", F, M, box)
        f64 = _jax_filaments_op(js64, row_e, box, _RADIUS, _E_EFF, E, jnp.float64)
        jit = _jax_filaments_op(js, row_e, box, _RADIUS, _E_EFF, E, jnp.float32)
        with jax.disable_jit():
            eager = _jax_filaments_op(js, row_e, box, _RADIUS, _E_EFF, E, jnp.float32)
        port = [t.numpy() for t in _port_op(ts, row_e, box, E)]
        print(f"{F} x {M}, box {box}: reference jitted vs f64 {rel(jit, f64)}; port vs f64 "
              f"{rel(port, f64)}; port vs reference jitted {rel(port, jit)}, op by op "
              f"{rel(port, eager)}")


def test_filaments_op_excludes_only_same_filament_neighbors():
    """Two touching segments with gids g, g + 1: no force inside one
    filament (g mod E != E - 1), a push across a filament boundary."""
    box, E = 12.0, 4
    mid = np.array([[6.0, 6.0, 6.0], [6.0, 6.2, 6.0]] + [[1.0 + i, 1.0, 1.0] for i in range(6)])
    e = np.tile([[0.5, 0.0, 0.0]], (8, 1))
    grid = tr.make_row_grid([0, 0, 0], [box] * 3, 1.8, 8, dtype=torch.float64, align=1)
    out = {}
    for g0 in (1, 3):  # (1, 2) share a filament; (3, 4) do not
        gid = torch.tensor([g0, g0 + 1] + [10 + 2 * i for i in range(6)], dtype=torch.int32)
        rows = tr.build_rows(torch.as_tensor(mid), gid, grid)
        he = torch.where(rows.valid[..., None], torch.as_tensor(e)[0], 0.0)
        fs, fe = k4.row_segment_filaments_sym(rows.pos, he, rows.valid, rows.gid, (box,) * 3,
                                              0.25, 274.725, E)
        sel = (rows.gid == g0) & rows.valid
        out[g0] = (fs[sel] + fe[sel]).reshape(3)
    assert float(out[1].abs().max()) == 0.0
    assert float(out[3][1]) < -1.0  # pushed away from its neighbour along -y


def test_neighbor_matrix_exclude_matches():
    rng = np.random.default_rng(4)
    n, box, sr = 500, 8.0, 0.6
    pos = rng.uniform(0, box, (n, 3))
    excl = rng.integers(-1, n, (n, 3))
    jg = jc.make_cell_grid([0, 0, 0], [box] * 3, 2 * sr, (True,) * 3, jnp.float64)
    tg = tc.make_cell_grid([0, 0, 0], [box] * 3, 2 * sr, (True,) * 3, torch.float64)
    jcl = jc.build_cell_list(jnp.asarray(pos), jg, 24)
    tcl = tc.build_cell_list(torch.as_tensor(pos), tg, 24)
    ref = jc.neighbor_matrix(jnp.asarray(pos), jcl, jnp.asarray(sr),
                             metric=j_periodic(np.array([box] * 3), dtype=jnp.float64),
                             max_neighbors=20, chunk=128,
                             exclude=jnp.asarray(excl, jnp.int32))
    got = tc.neighbor_matrix(torch.as_tensor(pos), tcl, sr,
                             metric=periodic([box] * 3, dtype=torch.float64),
                             max_neighbors=20, chunk=128,
                             exclude=torch.as_tensor(excl, dtype=torch.int32))
    np.testing.assert_array_equal(got.idx.numpy(), np.asarray(ref.idx))
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(ref.mask))
    assert bool(got.overflow) == bool(ref.overflow)
    i = np.nonzero(np.asarray(ref.mask))[0]
    assert not (np.asarray(ref.idx)[np.asarray(ref.mask)][:, None] == excl[i]).any()


@pytest.mark.parametrize("n,box,slack,k", [(98_000, 120.0, 1.9, 26), (98_000, 120.0, 25.0, 26),
                                           (5000, 20.0, 40.0, 12), (300, 12.0, 1.9, 600)])
def test_rows_extract_feasible_matches_on_cpu(n, box, slack, k):
    """The reference's answer off the TPU: the byte budget of the plain
    extraction (the second case, R = 608, is past it)."""
    jg = jr.make_row_grid([0, 0, 0], [box] * 3, 1.8, n, capacity_slack=slack,
                          dtype=jnp.float32, align=8)
    tg = tr.make_row_grid([0, 0, 0], [box] * 3, 1.8, n, capacity_slack=slack,
                          dtype=torch.float32, align=8)
    assert tg.row_capacity == jg.row_capacity
    assert tr.rows_extract_feasible(tg, k) == jr.rows_extract_feasible(jg, k)
    if slack == 25.0:
        assert not tr.rows_extract_feasible(tg, k)


if __name__ == "__main__":
    _f32_readings()
