"""The reference's smaller public names in the port against the JAX
package, on seeded numpy inputs in float64 on the CPU: the convex spaces
and a solve with a finite upper bound, need_rebuild, the FENE, FENE-WCA and
angular springs, wca_contact_forces (uniform and per-particle),
local_drag_angular_mobility, debug_assert, the Morton and row-major cell
keys, and World, WorldBuilder and links_to_csr. Integer outputs are
bit-equal; floats agree within 1e-12 of the compared array's largest
magnitude."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mundy_tpu import forces as jfo
from mundy_tpu import math as jma
from mundy_tpu import mobility as jmo
from mundy_tpu import neighbor as jne
from mundy_tpu import state as jst
from mundy_tpu.geom import periodic as jperiodic
from mundy_tpu_torch import core as tco
from mundy_tpu_torch import forces as tfo
from mundy_tpu_torch import math as tma
from mundy_tpu_torch import mobility as tmo
from mundy_tpu_torch import neighbor as tne
from mundy_tpu_torch import state as tst
from mundy_tpu_torch.core import errors as terr
from mundy_tpu_torch.geom import periodic as tperiodic

torch.set_num_threads(1)
BOX = 8.0


def _close(got, ref, tol=1e-12):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max(initial=0.0) <= tol * max(1.0, np.abs(ref).max(initial=0.0))


def _t(a):
    return torch.as_tensor(np.asarray(a))


# ---- math/convex.py spaces --------------------------------------------------

@pytest.mark.parametrize("space", ["unconstrained", "lower", "upper", "bounded"])
def test_spaces_and_bounded_solve(space):
    """Each space projects as the reference's, and solve_cqpp on a box QP
    with finite bounds (the residual's upper-bound branch) takes the same
    iterations to the same minimizer."""
    rng = np.random.default_rng(1)
    n = 24
    M = rng.normal(size=(n, n))
    A = M @ M.T / n + np.eye(n)
    q = rng.normal(size=n) * 3
    lo, hi = -0.2 * np.ones(n), 0.3 * np.ones(n)
    make = {"unconstrained": (lambda m, d: m.unconstrained(d), ()),
            "lower": (lambda m, d: m.lower_bound(lo, dtype=d), ()),
            "upper": (lambda m, d: m.upper_bound(hi, dtype=d), ()),
            "bounded": (lambda m, d: m.bounded(lo, hi, dtype=d), ())}[space][0]
    js = make(jma, jnp.float64)
    ts = make(tma, torch.float64)
    x = rng.normal(size=n)
    _close(ts.project(_t(x)).numpy(), js.project(jnp.asarray(x)))
    cfg_j = jma.PGDConfig(max_iters=500, tol=1e-10)
    cfg_t = tma.PGDConfig(max_iters=500, tol=1e-10)
    jr = jma.solve_cqpp(lambda v: jnp.asarray(A) @ v, jnp.asarray(q), js, config=cfg_j)
    tr = tma.solve_cqpp(lambda v: _t(A) @ v, _t(q), ts, config=cfg_t)
    assert int(tr.num_iters) == int(jr.num_iters) > 3
    _close(tr.x.numpy(), jr.x, 1e-10)
    _close(tr.residual.numpy(), jr.residual, 1e-6)
    assert bool(tr.converged) == bool(jr.converged)
    if space in ("upper", "bounded"):
        assert np.isclose(tr.x.numpy(), hi).any()  # the upper bound is active


# ---- neighbor/cell_list.py need_rebuild -------------------------------------

@pytest.mark.parametrize("use_metric", [False, True])
def test_need_rebuild(use_metric):
    rng = np.random.default_rng(2)
    ref = rng.uniform(0, BOX, (50, 3))
    jm = jperiodic([BOX] * 3, dtype=jnp.float64) if use_metric else None
    tm = tperiodic([BOX] * 3, dtype=torch.float64) if use_metric else None
    for scale in (0.01, 0.04, 0.2):
        pos = np.mod(ref + rng.normal(size=ref.shape) * scale, BOX)
        want = bool(jne.need_rebuild(jnp.asarray(pos), jnp.asarray(ref), 0.3, jm))
        got = tne.need_rebuild(_t(pos), _t(ref), 0.3, tm)
        assert got.dtype == torch.bool and bool(got) == want


# ---- forces ------------------------------------------------------------------

def _bonds(n=40, m=60, seed=3):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0, BOX, (n, 3))
    i = rng.integers(0, n, m).astype(np.int32)
    j = (i + 1 + rng.integers(0, n - 1, m)).astype(np.int32) % n
    mask = rng.uniform(size=m) > 0.2
    return pos, i, j, mask


@pytest.mark.parametrize("use_metric", [False, True])
def test_spring_forces(use_metric):
    pos, i, j, mask = _bonds()
    pos = pos * 0.2 + 3.0  # bonds shorter than r_max
    jm = jperiodic([BOX] * 3, dtype=jnp.float64) if use_metric else None
    tm = tperiodic([BOX] * 3, dtype=torch.float64) if use_metric else None
    jp, tp = jnp.asarray(pos), _t(pos)
    ji, jj, ti, tj = jnp.asarray(i), jnp.asarray(j), _t(i), _t(j)
    _close(tfo.fene_spring_forces(tp, ti, tj, 30.0, 1.6, mask=_t(mask), metric=tm).numpy(),
           jfo.fene_spring_forces(jp, ji, jj, 30.0, 1.6, mask=jnp.asarray(mask), metric=jm))
    _close(tfo.fenewca_spring_forces(tp, ti, tj, 30.0, 1.6, 0.8, 1.0, mask=_t(mask),
                                     metric=tm).numpy(),
           jfo.fenewca_spring_forces(jp, ji, jj, 30.0, 1.6, 0.8, 1.0,
                                     mask=jnp.asarray(mask), metric=jm), 1e-11)
    apex = (i + 7) % pos.shape[0]
    _close(tfo.angular_spring_forces(tp, ti, tj, _t(apex), 5.0, 2.0, mask=_t(mask),
                                     metric=tm).numpy(),
           jfo.angular_spring_forces(jp, ji, jj, jnp.asarray(apex), 5.0, 2.0,
                                     mask=jnp.asarray(mask), metric=jm))


@pytest.mark.parametrize("uniform", [True, False])
def test_wca_contact_forces(uniform):
    rng = np.random.default_rng(4)
    n = 120
    pos = rng.uniform(0, BOX, (n, 3))
    per = (True,) * 3
    jg = jne.make_cell_grid([0, 0, 0], [BOX] * 3, 1.4, per, jnp.float64)
    tg = tne.make_cell_grid([0, 0, 0], [BOX] * 3, 1.4, per, dtype=torch.float64)
    jm, tm = jperiodic([BOX] * 3, dtype=jnp.float64), tperiodic([BOX] * 3, dtype=torch.float64)
    jn = jne.neighbor_matrix(jnp.asarray(pos), jne.build_cell_list(jnp.asarray(pos), jg, 32),
                             jnp.asarray(0.7), metric=jm, max_neighbors=24, chunk=64)
    tn = tne.neighbor_matrix(_t(pos), tne.build_cell_list(_t(pos), tg, 32), 0.7, metric=tm,
                             max_neighbors=24, chunk=64)
    np.testing.assert_array_equal(tn.idx.numpy(), np.asarray(jn.idx))
    if uniform:
        jr, tr, je, te = 0.5, 0.5, 1.2, 1.2
    else:
        r = rng.uniform(0.4, 0.6, n)
        e = rng.uniform(0.5, 1.5, n)
        jr, tr, je, te = jnp.asarray(r), _t(r), jnp.asarray(e), _t(e)
    want = jfo.wca_contact_forces(jnp.asarray(pos), jr, je, jn, jm)
    assert np.abs(np.asarray(want)).max() > 0
    # the two pow() implementations differ by a few ulp
    _close(tfo.wca_contact_forces(_t(pos), tr, te, tn, tm).numpy(), want, 1e-11)


def test_local_drag_angular_mobility():
    rng = np.random.default_rng(5)
    T = rng.normal(size=(30, 3))
    r = rng.uniform(0.3, 0.7, 30)
    _close(tmo.local_drag_angular_mobility(_t(T), 0.5, 1.3).numpy(),
           jmo.local_drag_angular_mobility(jnp.asarray(T), 0.5, 1.3))
    _close(tmo.local_drag_angular_mobility(_t(T), _t(r), 1.3).numpy(),
           jmo.local_drag_angular_mobility(jnp.asarray(T), jnp.asarray(r), 1.3))


# ---- core/errors.py debug_assert --------------------------------------------

def test_debug_assert(monkeypatch, capsys):
    """Off by default (nothing printed, nothing read); on, a failed
    condition prints its message and a holding one prints nothing."""
    monkeypatch.setattr(terr, "DEBUG_ASSERTS", False)
    tco.debug_assert(torch.tensor([True, False]), "silent")
    monkeypatch.setattr(terr, "DEBUG_ASSERTS", True)
    tco.debug_assert(torch.tensor([True, True]), "holds")
    tco.debug_assert(torch.tensor([True, False]), "broken invariant")
    tco.debug_assert(True, "python bool holds")
    err = capsys.readouterr().err
    assert "broken invariant" in err and "silent" not in err and "holds" not in err
    terr.debug_report(wait=True)  # nothing pending on the CPU
    assert terr._PENDING == []


# ---- math/spacefill.py keys --------------------------------------------------

def test_morton_and_linear_keys_bit_equal():
    rng = np.random.default_rng(6)
    ix, iy, iz = (rng.integers(0, 1024, 500).astype(np.int32) for _ in range(3))
    ix[:3] = [0, 1023, 512]
    want = np.asarray(jma.morton_key_3d(jnp.asarray(ix), jnp.asarray(iy), jnp.asarray(iz)))
    got = tma.morton_key_3d(_t(ix), _t(iy), _t(iz)).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))
    dims = (17, 23, 9)
    cx, cy, cz = (rng.integers(0, d, 500).astype(np.int32) for d in dims)
    want = np.asarray(jma.cell_linear_index(jnp.asarray(cx), jnp.asarray(cy),
                                            jnp.asarray(cz), dims))
    got = tma.cell_linear_index(_t(cx), _t(cy), _t(cz), dims)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


# ---- state/world.py ----------------------------------------------------------

def _build_world(lib):
    jx = lib is jst
    b = (lib.WorldBuilder(dtype=jnp.float64) if jx
         else lib.WorldBuilder(dtype=torch.float64, device="cpu"))
    b.declare_set("beads", 10).declare_field("beads", "x", (3,)).declare_part("beads", "end")
    b.declare_field("beads", "id", (), dtype=jnp.int32 if jx else torch.int32, fill=-1)
    b.declare_set("linkers", 6).declare_field("linkers", "k", fill=2.0)
    b.declare_links("bonds", ("beads", "beads"), 8,
                    fields={"rest": ((), None, 1.0)})
    x = np.arange(21, dtype=np.float64).reshape(7, 3)
    idx = b.add_entities("beads", 7, parts=("end",), x=x, id=np.arange(7))
    b.add_entities("linkers", 2, k=[3.0, 4.0])
    b.add_links("bonds", [[0, 1], [1, 2], [5, 2], [3, 3]], rest=[0.5, 0.6, 0.7, 0.8])
    return b.commit(), idx


def test_world_builder_and_links_to_csr():
    jw, jidx = _build_world(jst)
    tw, tidx = _build_world(tst)
    np.testing.assert_array_equal(tidx, jidx)
    for name in ("beads", "linkers"):
        je, te = jw.entity(name), tw.entity(name)
        assert te.capacity == je.capacity and int(te.num_active) == int(je.num_active)
        np.testing.assert_array_equal(te.active.numpy(), np.asarray(je.active))
        for f in je.fields:
            np.testing.assert_array_equal(te.field(f).numpy(), np.asarray(je.field(f)))
            assert te.field(f).dtype == {np.dtype("float64"): torch.float64,
                                         np.dtype("int32"): torch.int32}[je.field(f).dtype]
        for p in je.parts:
            np.testing.assert_array_equal(te.parts[p].numpy(), np.asarray(je.parts[p]))
    jl, tl = jw.link("bonds"), tw.link("bonds")
    assert (tl.capacity, tl.arity, tl.targets) == (jl.capacity, jl.arity, jl.targets)
    np.testing.assert_array_equal(tl.indices.numpy(), np.asarray(jl.indices))
    np.testing.assert_array_equal(tl.fields["rest"].numpy(), np.asarray(jl.fields["rest"]))
    for slot in (0, 1):
        jo, jorder = jst.links_to_csr(jl, slot, 10)
        to, torder = tst.links_to_csr(tl, slot, 10)
        np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
        np.testing.assert_array_equal(torder.numpy(), np.asarray(jorder))
    # functional updates
    es = tw.entity("beads").set_field("x", torch.zeros((10, 3), dtype=torch.float64))
    w2 = tw.update_set("beads", es).update_link("bonds", tl.replace(active=tl.active & False))
    assert float(w2.entity("beads").field("x").abs().sum()) == 0.0
    assert not bool(w2.link("bonds").active.any()) and bool(tw.link("bonds").active.any())
    with pytest.raises(tco.require.__globals__["MundyError"], match="unknown field"):
        es.set_field("nope", es.field("x"))
    with pytest.raises(tco.require.__globals__["MundyError"], match="capacity exceeded"):
        tst.WorldBuilder(device="cpu").declare_set("a", 1).add_entities("a", 2)
