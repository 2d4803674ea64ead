"""K3t's path, the scalar-mobility Delassus applies, vs the JAX reference on
the CPU.

- `ops/segments.strided_t` (K3t's plain version: K3's sum of -gamma n, the
  block-local gather and the dot) against JAX's strided_t on the CPU (its
  XLA fallback: the strided sum, then a row gather): float64 within 1e-12
  of max|t| (summation order only); float32 within 3e-7 of max(|t|, 1),
  the bar of the reference's own kernel test (its f32 sums ride a
  three-term bf16 split). In float32 also against the Pallas kernel
  strided_onehot_t in interpret mode, which computes in float32 whatever
  its input.
- On one contact problem (300 spheres at volume fraction 0.16, the
  reference's active set carried over through numpy), float64:
  make_local_drag_apply, make_block_delassus_apply and
  assemble_block_delassus equal the JAX functions with scalar and with
  per-pair mobilities (rtol 1e-10, as tests/test_mobility_collision.py);
  resolve_collisions with each apply as `apply_override` takes the JAX
  solve's iterations, and its multipliers agree within 1e-10 of max.
"""

import math

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
from mundy_tpu.ops.pallas.seg_onehot import strided_onehot_t as pallas_t
from mundy_tpu_torch.constraints import collision as tcol
from mundy_tpu_torch.mobility.local_drag import local_drag_mobility as tdrag
from mundy_tpu_torch.neighbor.cell_list import PairList
from mundy_tpu_torch.ops import segments as tseg

torch.set_num_threads(1)
N, BOX, SR, K, CAP, B, W = 300, 10.0, 0.725, 16, 4096, 64, 256
DT, MU, RADIUS = 1e-3, 1.3, 0.5
_NP = {"float32": np.float32, "float64": np.float64}


def _strided_inputs(nb, Wd, Bd, dtype, seed=4):
    """Sorted per-block body ids with pad slots (id n), unit normals and
    multipliers zero on the pads, as the strided active layout holds them."""
    rng = np.random.default_rng(seed)
    n = nb * Bd - Bd // 2  # the last block is part full: pads fall inside it
    ids = []
    for b in range(nb):
        k = rng.integers(Wd // 2, Wd)
        hi = min((b + 1) * Bd, n)
        ids.append(np.concatenate([np.sort(rng.integers(b * Bd, hi, k)),
                                   np.full(Wd - k, n)]))
    ids = np.concatenate(ids).astype(np.int32)
    valid = ids < n
    gamma = np.where(valid, rng.normal(size=nb * Wd), 0.0).astype(_NP[dtype])
    normals = rng.normal(size=(nb * Wd, 3))
    normals /= np.linalg.norm(normals, axis=1, keepdims=True)
    normals = np.where(valid[:, None], normals, 0.0).astype(_NP[dtype])
    return n, ids, gamma, normals


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_strided_t_matches_reference(dtype):
    nb, Wd, Bd = 4, 64, 128
    n, ids, gamma, normals = _strided_inputs(nb, Wd, Bd, dtype)
    jwin = jseg.StridedWindows(block_bodies=Bd, window=Wd, nb=nb,
                               overflow=jnp.asarray(False))
    ref = np.asarray(jseg.strided_t(jnp.asarray(gamma), jnp.asarray(normals),
                                    jnp.asarray(ids), n, jwin), np.float64)
    twin = tseg.StridedWindows(block_bodies=Bd, window=Wd, nb=nb,
                               overflow=torch.tensor(False))
    got = tseg.strided_t(torch.from_numpy(gamma), torch.from_numpy(normals),
                         torch.from_numpy(ids), twin)
    assert got.dtype == torch.from_numpy(gamma).dtype and got.shape == (nb * Wd,)
    got = got.numpy().astype(np.float64)
    assert np.abs(ref).max() > 0.5 and np.all(got[ids >= n] == 0.0)
    if dtype == "float64":
        assert np.abs(got - ref).max() <= 1e-12 * np.abs(ref).max()
        return
    scale = max(1.0, np.abs(ref).max())
    assert np.abs(got - ref).max() <= 3e-7 * scale
    loc = ids - np.repeat(np.arange(nb, dtype=np.int32), Wd) * Bd
    pal = np.asarray(pallas_t(jnp.asarray(gamma.reshape(nb, Wd)),
                              jnp.asarray(normals.reshape(nb, Wd, 3).transpose(0, 2, 1)),
                              jnp.asarray(loc.reshape(nb, Wd)), Bd, interpret=True))
    assert np.abs(got - pal.reshape(-1)).max() <= 3e-7 * scale


def _close(got, ref, rel):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= rel * max(np.abs(ref).max(), 1e-300)


@pytest.fixture(scope="module")
def problem():
    """The reference's strided active set of one overlapping contact problem,
    and the same set as the port's tensors."""
    rng = np.random.default_rng(21)
    p = rng.uniform(0, BOX, (N, 3))
    metric = jperiodic([BOX] * 3, dtype=jnp.float64)
    pos = jnp.asarray(p)
    nmat = jrows.neighbor_matrix_rows(pos, SR, (BOX,) * 3, max_neighbors=K)
    pairs = jcl.build_pair_list_ordered(nmat, CAP)
    starts = jcol.body_pair_starts(nmat)
    win = jseg.segment_windows(pairs.i, N, B, 2048, body_starts=starts)
    setup = jcol.collision_setup_spheres(pos, jnp.asarray(RADIUS), pairs, metric=metric)
    dual_full, missing = jcol.pair_dual_slots(pairs, starts, nmat)
    assert not bool(missing)
    act = jcol.active_pair_subset_strided(setup, jnp.asarray(0.3), N, B, W, win.starts,
                                          dual_full=dual_full)
    assert not bool(act.overflow) and int(act.n_act) > 300
    js = act.setup
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    ts = tcol.CollisionSetup(
        pairs=PairList(i=t(js.pairs.i), j=t(js.pairs.j), mask=t(js.pairs.mask),
                       num_pairs=t(js.pairs.num_pairs), overflow=t(js.pairs.overflow)),
        normals=t(js.normals), sep0=t(js.sep0),
        windows=tseg.StridedWindows(block_bodies=B, window=W, nb=js.windows.nb,
                                    overflow=torch.tensor(False)))
    radii = rng.uniform(0.3, 0.7, N)
    inv = 1.0 / (6.0 * math.pi * MU * radii)
    ii = np.minimum(np.asarray(js.pairs.i), N - 1)
    jj = np.minimum(np.asarray(js.pairs.j), N - 1)
    mob = {"scalar": (1.0 / (6.0 * math.pi * MU * RADIUS),) * 2,
           "per_pair": (inv[ii], inv[jj])}
    u_ext = rng.normal(scale=3.0, size=(N, 3))
    return js, np.asarray(act.dual), ts, t(act.dual), mob, u_ext


def _applies(kind, mob_kind, problem):
    js, jdual, ts, tdual, mob, _ = problem
    mi, mj = mob[mob_kind]
    jm = [m if np.ndim(m) == 0 else jnp.asarray(m) for m in (mi, mj)]
    tm = [m if np.ndim(m) == 0 else torch.from_numpy(m) for m in (mi, mj)]
    if kind == "local":
        return (jcol.make_local_drag_apply(js, jnp.asarray(jdual), N, DT, *jm),
                tcol.make_local_drag_apply(ts, tdual, DT, *tm))
    return (jcol.make_block_delassus_apply(js, jnp.asarray(jdual), DT, *jm),
            tcol.make_block_delassus_apply(ts, tdual, DT, *tm))


@pytest.mark.parametrize("kind", ["local", "block"])
@pytest.mark.parametrize("mob_kind", ["scalar", "per_pair"])
def test_delassus_apply_matches(problem, kind, mob_kind):
    js, _, ts, _, _, _ = problem
    japply, tapply = _applies(kind, mob_kind, problem)
    gamma = np.random.default_rng(5).normal(size=js.sep0.shape)
    ref = np.asarray(japply(jnp.asarray(gamma)))
    got = tapply(torch.from_numpy(gamma)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-10, atol=1e-12 * np.abs(ref).max())
    if kind == "block":
        _close(tcol.assemble_block_delassus(ts), jcol.assemble_block_delassus(js), 1e-12)


@pytest.mark.parametrize("kind", ["local", "block"])
def test_resolve_collisions_with_override_matches(problem, kind):
    """A cold solve with Brownian drift through each fused apply."""
    js, _, ts, _, _, u_ext = problem
    japply, tapply = _applies(kind, "scalar", problem)
    gj, vj, rj = jcol.resolve_collisions(
        js, lambda f: jdrag(f, RADIUS, MU), N, DT, max_allowable_overlap=1e-6,
        max_iterations=2000, u_ext=jnp.asarray(u_ext), apply_override=japply)
    gt, vt, rt = tcol.resolve_collisions(
        ts, lambda f: tdrag(f, RADIUS, MU), N, DT, max_allowable_overlap=1e-6,
        max_iterations=2000, u_ext=torch.from_numpy(u_ext), apply_override=tapply)
    assert rt.num_iters == int(rj.num_iters) > 5
    assert bool(rt.converged) == bool(rj.converged) is True
    _close(gt, gj, 1e-10)
    _close(vt, vj, 1e-10)
