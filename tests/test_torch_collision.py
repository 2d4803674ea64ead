"""The constraint pipeline of the LCP line vs the JAX reference, on one small
contact problem in float64 on the CPU.

Integer outputs (pair slots, dual slots, cumsums, counts, iteration counts)
are equal. Floats agree within 1e-12 of the largest magnitude of the
compared array (summation order only; the multipliers reach ~1e3). The
contact problem is 300 spheres at volume fraction 0.16, dense enough to
overlap and sparse enough that BBPGD's 30-40 iterations amplify the
summation-order differences to ~1e-13 only.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mundy_tpu.constraints import collision as jcol
from mundy_tpu.geom import periodic as jperiodic
from mundy_tpu.math import convex as jcvx
from mundy_tpu.mobility import local_drag_mobility as jdrag
from mundy_tpu.neighbor import cell_list as jcl
from mundy_tpu.neighbor import rows as jrows
from mundy_tpu.ops import segments as jseg
from mundy_tpu_torch.constraints import collision as tcol
from mundy_tpu_torch.geom.periodicity import periodic as tperiodic
from mundy_tpu_torch.math import convex as tcvx
from mundy_tpu_torch.mobility.local_drag import local_drag_mobility as tdrag
from mundy_tpu_torch.neighbor import cell_list as tcl
from mundy_tpu_torch.neighbor import rows as trows
from mundy_tpu_torch.ops import segments as tseg

torch.set_num_threads(1)
N, BOX, SR, K, CAP, B, W = 300, 10.0, 0.725, 16, 4096, 64, 160
DT, MOB = 1e-3, 1.0 / (6.0 * np.pi * 0.5)


def _close(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max(initial=0.0) <= 1e-12 * max(1.0, np.abs(ref).max(initial=0.0))


def _equal(got, ref):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))


class _Side:
    """One engine's pipeline state for positions p (numpy)."""

    def __init__(self, lib, p):
        self.lib = lib
        jx = lib == "jax"
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
        near = self.setup.sep0 < 0.225
        self.dual_full, self.missing = col.pair_dual_slots(self.pairs, self.starts,
                                                           self.nmat, near=near)

    def active(self, margin, prev=None, gamma_full=None):
        return self.col.active_pair_subset_strided(
            self.setup, self.arr(margin), N, B, W, self.win.starts,
            dual_full=self.dual_full, prev=prev, gamma_full=gamma_full)

    def solve(self, act, u_ext, gamma0=None, alpha0=None):
        mob = self.arr(MOB)
        band = self.col.make_band_delassus_apply(act.setup, act.dual, DT, K,
                                                 mobility_i=mob, mobility_j=mob)
        drag = jdrag if self.lib == "jax" else tdrag
        return self.col.resolve_collisions(
            act.setup, lambda f: drag(f, 0.5, 1.0), N, DT,
            max_allowable_overlap=1e-6, max_iterations=2000, gamma0=gamma0,
            u_ext=self.arr(u_ext), alpha0=alpha0, apply_override=band)


@pytest.fixture(scope="module")
def problem():
    rng = np.random.default_rng(21)
    p0 = rng.uniform(0, BOX, (N, 3))
    p1 = np.mod(p0 + rng.normal(scale=0.05, size=(N, 3)), BOX)
    u_ext = rng.normal(scale=3.0, size=(N, 3))
    return {k: (_Side("jax", p), _Side("torch", p)) for k, p in (("p0", p0), ("p1", p1))}, u_ext


def test_broad_phase_and_setup_match(problem):
    sides, _ = problem
    j, t = sides["p0"]
    assert int(j.pairs.num_pairs) > 500 and not bool(j.pairs.overflow)
    for a, b in ((t.pairs.i, j.pairs.i), (t.pairs.j, j.pairs.j), (t.starts, j.starts),
                 (t.win.starts, j.win.starts), (t.dual_full, j.dual_full)):
        _equal(a, b)
    assert bool(t.missing) == bool(j.missing) is False
    _close(t.setup.normals, j.setup.normals)
    _close(t.setup.sep0, j.setup.sep0)
    assert float(j.setup.sep0[j.pairs.mask].min()) < -0.3  # overlapping start


def test_active_subset_band_apply_and_solve_match(problem):
    """Two steps of the per-step pipeline: a cold solve, then a warm one at
    moved positions whose compaction maps last step's multipliers."""
    sides, u_ext = problem
    results = {}
    for lib, idx in (("jax", 0), ("torch", 1)):
        s0, s1 = sides["p0"][idx], sides["p1"][idx]
        act0 = s0.active(0.3)
        g0, v0, r0 = s0.solve(act0, u_ext)
        act1 = s1.active(0.3, prev=(act0.cum, g0, W),
                         gamma_full=s1.arr(np.linspace(0.0, 1.0, CAP)))
        g1, v1, r1 = s1.solve(act1, u_ext, gamma0=act1.gamma0, alpha0=r0.alpha)
        probe = np.random.default_rng(3).normal(size=act1.sel.shape[0])
        band = s1.col.make_band_delassus_apply(act1.setup, act1.dual, DT, K)
        results[lib] = dict(act0=act0, act1=act1, g0=g0, v0=v0, it0=int(r0.num_iters),
                            g1=g1, v1=v1, it1=int(r1.num_iters), res1=r1.residual,
                            band=band(s1.arr(probe) * s1.arr(np.asarray(act1.setup.pairs.mask))))
    j, t = results["jax"], results["torch"]
    for key in ("act0", "act1"):
        a, b = t[key], j[key]
        for f in ("sel", "n_act", "block_max", "overflow", "cum", "dual"):
            _equal(getattr(a, f), getattr(b, f))
        _equal(a.setup.pairs.i, b.setup.pairs.i)
        _equal(a.setup.pairs.j, b.setup.pairs.j)
        _close(a.setup.normals, b.setup.normals)
        _close(a.setup.sep0, b.setup.sep0)
    assert int(j["act0"].n_act) > 300
    _close(t["act1"].gamma0, j["act1"].gamma0)
    assert np.count_nonzero(np.asarray(j["act1"].gamma0)) > 100  # warm start carried
    _close(t["band"], j["band"])
    assert t["it0"] == j["it0"] > 5 and t["it1"] == j["it1"]
    for key in ("g0", "v0", "g1", "v1"):
        _close(t[key], j[key])
    _close(t["res1"], j["res1"])


@pytest.mark.parametrize("branch", ["old_nmat", "probe_starts", "probe_search"])
def test_remap_gamma_matches(problem, branch):
    sides, _ = problem
    out = {}
    for lib, idx in (("jax", 0), ("torch", 1)):
        old, new = sides["p0"][idx], sides["p1"][idx]
        gam = old.arr(np.random.default_rng(8).uniform(size=CAP))
        kw = {"old_nmat": dict(old_starts=old.starts, old_nmat=old.nmat),
              "probe_starts": dict(old_starts=old.starts), "probe_search": {}}[branch]
        out[lib] = old.col.remap_gamma(old.pairs, gam, new.pairs, probes=K, **kw)
    _equal(out["torch"], out["jax"])
    assert np.count_nonzero(np.asarray(out["jax"])) > 500


def test_solve_lcp_dense_matches():
    """BBPGD on a dense SPD problem: same iterates, same iteration count."""
    rng = np.random.default_rng(9)
    m = rng.normal(size=(40, 40))
    A = m @ m.T / 40 + 0.1 * np.eye(40)
    q = rng.normal(size=40)
    cfg_j = jcvx.PGDConfig(max_iters=500, tol=1e-10)
    cfg_t = tcvx.PGDConfig(max_iters=500, tol=1e-10)
    rj = jcvx.solve_lcp(lambda x: jnp.asarray(A) @ x, jnp.asarray(q), config=cfg_j)
    At = torch.from_numpy(A)
    rt = tcvx.solve_lcp(lambda x: At @ x, torch.from_numpy(q), config=cfg_t)
    assert rt.num_iters == int(rj.num_iters) > 10
    assert bool(rt.converged) == bool(rj.converged) is True
    _close(rt.x, rj.x)
    # (the returned BB step is a ratio of rounding-level differences once the
    # iterate has converged, so it is not compared)
    assert (rt.x >= 0).all()
