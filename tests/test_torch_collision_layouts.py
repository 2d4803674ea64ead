"""The collision layouts beside the strided one against the JAX package, in
float64 on the CPU: the windowed sorted segment sum
(segment_sum_sorted_blocked) with its overflow drops, the unstrided
active-set compaction (active_pair_subset), the j-sort permutation of an
unordered list (pair_j_permutation), and collision_forces in the
windowed, j_perm and unordered layouts, each also against the strided
result on one contact problem; then resolve_collisions on the windowed
and unordered setups.

Integer outputs are equal; floats agree within 1e-12 of the largest
magnitude of the compared array (summation order only).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mundy_tpu.constraints import collision as jcol
from mundy_tpu.geom import periodic as jperiodic
from mundy_tpu.mobility import local_drag_mobility as jdrag
from mundy_tpu.neighbor import cell_list as jcl
from mundy_tpu.neighbor import rows as jrows
from mundy_tpu.ops import segments as jseg
from mundy_tpu_torch.constraints import collision as tcol
from mundy_tpu_torch.geom.periodicity import periodic as tperiodic
from mundy_tpu_torch.mobility.local_drag import local_drag_mobility as tdrag
from mundy_tpu_torch.neighbor import cell_list as tcl
from mundy_tpu_torch.neighbor import rows as trows
from mundy_tpu_torch.ops import segments as tseg

torch.set_num_threads(1)
N, BOX, SR, K, CAP, B, W = 300, 10.0, 0.725, 16, 4096, 64, 160
DT, MARGIN = 1e-3, 0.1


def _close(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max(initial=0.0) <= 1e-12 * max(1.0, np.abs(ref).max(initial=0.0))


def _equal(got, ref):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))


def _positions(seed=0):
    return np.random.default_rng(seed).uniform(0, BOX, (N, 3))


class _Side:
    """One package's ordered and unordered setups for positions p."""

    def __init__(self, lib, p):
        jx = lib == "jax"
        self.jx = jx
        self.arr = (lambda a: jnp.asarray(a)) if jx else (lambda a: torch.as_tensor(np.array(a)))
        rows, cl, col, seg = (jrows, jcl, jcol, jseg) if jx else (trows, tcl, tcol, tseg)
        self.col, self.seg = col, seg
        self.metric = (jperiodic([BOX] * 3, dtype=jnp.float64) if jx
                       else tperiodic([BOX] * 3, dtype=torch.float64))
        self.pos = self.arr(p)
        self.nmat = rows.neighbor_matrix_rows(self.pos, SR, (BOX,) * 3, max_neighbors=K)
        self.pairs = cl.build_pair_list_ordered(self.nmat, CAP)
        self.starts = col.body_pair_starts(self.nmat)
        self.win = seg.segment_windows(self.pairs.i, N, B, 2048, body_starts=self.starts)
        self.setup = col.collision_setup_spheres(self.pos, self.arr(0.5), self.pairs,
                                                 metric=self.metric)
        self.upairs = cl.build_pair_list(self.nmat, CAP // 2)
        self.j_perm = col.pair_j_permutation(self.upairs, N)
        self.usetup = col.collision_setup_spheres(self.pos, self.arr(0.5), self.upairs,
                                                  metric=self.metric, j_perm=self.j_perm)

    def gamma(self, setup, seed):
        g = np.random.default_rng(seed).uniform(0, 1, np.asarray(setup.sep0).shape)
        return self.arr(g)


@pytest.fixture(scope="module")
def sides():
    p = _positions()
    return _Side("jax", p), _Side("torch", p)


@pytest.mark.parametrize("window", [2048, 40, 8])
def test_segment_sum_sorted_blocked(sides, window):
    """Window starts from the sorted ids; a narrow window drops the rows
    beyond it (W = 8 and 40 overflow at this occupancy, 2048 does not)."""
    js, ts = sides
    vals = np.random.default_rng(3).normal(size=(CAP, 3))
    vals[~np.asarray(js.pairs.mask)] = 0.0
    jw = jseg.segment_windows(js.pairs.i, N, B, window, body_starts=js.starts)
    tw = tseg.segment_windows(ts.pairs.i, N, B, window, body_starts=ts.starts)
    _equal(tw.starts.numpy(), jw.starts)
    assert bool(tw.overflow) == bool(jw.overflow) == (window < 2048)
    want = jseg.segment_sum_sorted_blocked(jnp.asarray(vals), js.pairs.i, N, jw)
    got = tseg.segment_sum_sorted_blocked(torch.as_tensor(vals), ts.pairs.i, N, tw)
    _close(got.numpy(), want)
    # a D = 5 value block (K3 sums it three columns at a time)
    v5 = np.random.default_rng(4).normal(size=(CAP, 5)) * np.asarray(js.pairs.mask)[:, None]
    _close(tseg.segment_sum_sorted_blocked(torch.as_tensor(v5), ts.pairs.i, N, tw).numpy(),
           jseg.segment_sum_sorted_blocked(jnp.asarray(v5), js.pairs.i, N, jw))


@pytest.mark.parametrize("capacity", [CAP, 200])
def test_active_pair_subset(sides, capacity):
    js, ts = sides
    ja = jcol.active_pair_subset(js.setup, jnp.asarray(MARGIN), capacity, N,
                                 seg_starts=js.win.starts, block_bodies=B, window=W)
    ta = tcol.active_pair_subset(ts.setup, torch.as_tensor(MARGIN), capacity, N,
                                 seg_starts=ts.win.starts, block_bodies=B, window=W)
    (jset, jsel, jn, jo), (tset, tsel, tn, to) = ja, ta
    _equal(tsel.numpy(), jsel)
    assert int(tn) == int(jn) and bool(to) == bool(jo) == (capacity < int(jn))
    for name in ("i", "j", "mask", "num_pairs", "overflow"):
        _equal(getattr(tset.pairs, name).numpy(), getattr(jset.pairs, name))
    _close(tset.normals.numpy(), jset.normals)
    _close(tset.sep0.numpy(), jset.sep0)
    _equal(tset.windows.starts.numpy(), jset.windows.starts)
    assert bool(tset.windows.overflow) == bool(jset.windows.overflow)
    # without seg_starts no windows ride along
    assert tcol.active_pair_subset(ts.setup, MARGIN, capacity, N)[0].windows is None


def test_pair_j_permutation(sides):
    js, ts = sides
    assert int(ts.upairs.num_pairs) > 50
    _equal(ts.j_perm.numpy(), js.j_perm)
    assert ts.j_perm.dtype == torch.int32


def test_collision_forces_layouts(sides):
    """Windowed (ordered, active subset), j_perm and unordered layouts vs
    the JAX functions, and all three vs the strided result."""
    js, ts = sides
    ja = jcol.active_pair_subset(js.setup, jnp.asarray(MARGIN), CAP, N,
                                 seg_starts=js.win.starts, block_bodies=B, window=W)[0]
    ta = tcol.active_pair_subset(ts.setup, torch.as_tensor(MARGIN), CAP, N,
                                 seg_starts=ts.win.starts, block_bodies=B, window=W)[0]
    # the ordered pairs carry one multiplier per contact (both directions)
    gam = np.random.default_rng(5).uniform(0, 1, CAP)
    ui, uj = np.asarray(js.upairs.i), np.asarray(js.upairs.j)
    key = {(a, b): g for a, b, g in zip(ui[:int(js.upairs.num_pairs)],
                                        uj[:int(js.upairs.num_pairs)], gam)}
    gam_u = np.array([key.get((a, b), 0.0) if m else 0.0
                      for a, b, m in zip(ui, uj, np.asarray(js.upairs.mask))])
    ai, aj, am = (np.asarray(x) for x in (ja.pairs.i, ja.pairs.j, ja.pairs.mask))
    gam_a = np.array([key.get((min(a, b), max(a, b)), 0.0) if m else 0.0
                      for a, b, m in zip(ai, aj, am)])
    # only the active (near-contact) pairs: zero the unordered ones outside
    act_u = np.asarray(js.usetup.sep0) < MARGIN
    gam_u = np.where(act_u, gam_u, 0.0)
    want_w = jcol.collision_forces(ja, jnp.asarray(gam_a), N)
    got_w = tcol.collision_forces(ta, torch.as_tensor(gam_a), N)
    _close(got_w.numpy(), want_w)
    want_p = jcol.collision_forces(js.usetup, jnp.asarray(gam_u), N)
    got_p = tcol.collision_forces(ts.usetup, torch.as_tensor(gam_u), N)
    _close(got_p.numpy(), want_p)
    un_j = js.usetup._replace(j_perm=None)
    un_t = ts.usetup._replace(j_perm=None)
    want_u = jcol.collision_forces(un_j, jnp.asarray(gam_u), N)
    got_u = tcol.collision_forces(un_t, torch.as_tensor(gam_u), N)
    _close(got_u.numpy(), want_u)
    # the strided layout of the same active set
    st = tcol.active_pair_subset_strided(ts.setup, torch.as_tensor(MARGIN), N, B, W,
                                         ts.win.starts).setup
    si, sj, sm = (x.numpy() for x in (st.pairs.i, st.pairs.j, st.pairs.mask))
    gam_s = np.array([key.get((min(a, b), max(a, b)), 0.0) if m else 0.0
                      for a, b, m in zip(si, sj, sm)])
    ref = tcol.collision_forces(st, torch.as_tensor(gam_s), N).numpy()
    assert np.abs(ref).max() > 0
    for got in (got_w, got_p, got_u):
        _close(got.numpy(), ref)


@pytest.mark.parametrize("layout", ["windowed", "j_perm", "unordered"])
def test_resolve_collisions_layouts(sides, layout):
    """The LCP solve on each layout's setup: same iterations, gamma and
    velocities as the JAX solve."""
    out = []
    for side, drag in zip(sides, (jdrag, tdrag)):
        if layout == "windowed":
            setup = side.col.active_pair_subset(
                side.setup, side.arr(MARGIN), CAP, N, seg_starts=side.win.starts,
                block_bodies=B, window=W)[0]
        else:
            setup = side.usetup if layout == "j_perm" else side.usetup._replace(j_perm=None)
        gamma, vel, res = side.col.resolve_collisions(
            setup, lambda f: drag(f, 0.5, 1.0), N, DT, max_iterations=200)
        out.append((gamma, vel, int(res.num_iters)))
    (jg, jv, jn), (tg_, tv, tn) = out
    assert tn == jn > 1
    _close(tg_.numpy(), jg)
    _close(tv.numpy(), jv)
