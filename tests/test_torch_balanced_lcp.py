"""The density-balanced LCP engine over 4 gloo ranks on the CPU against the
JAX engine over a 4-device mesh (parallel/balanced_lcp.py).

Both start from the reference test's clustered overlapping spheres (1024
spheres of radius 0.3 packed into the bottom 35% of the box in z, volume
fraction 0.02 over the box, float64) with the JAX init's stream key, and run
20 steps; the JAX engine runs them one block of one step at a time, which is
its n-step block, so that each step's BBPGD iteration count can be read.
- D = 0: the overlaps are resolved in the first steps (BBPGD iterates there
  and then has nothing to solve); the iteration counts are equal at every
  step, the positions agree within 1e-12, the own gid buffers are
  bit-equal, and the max overlap ends below the reference test's 1e-3.
- D = 0.05: the keyed Brownian drift enters the LCP's constant term, so
  BBPGD iterates at every step and the skin rebuilds rebalance several
  times; the iteration counts are equal at every step and the positions
  agree within 1e-7, the bound the two packages' Brownian normals allow
  (they differ by up to 2 float32 ulp on ~5% of draws,
  tests/test_torch_brownian.py).
Both runs share one process group, whose ranks import no JAX.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import torch_rank_bodies as bodies
from mundy_tpu.parallel.balanced_lcp import make_balanced_lcp_step as jax_make
from mundy_tpu_torch.parallel.comm import spawn_ranks

D = 4
N, RADIUS, STEPS = 1024, 0.3, 20
BOX = float((N * (4 / 3) * np.pi * RADIUS ** 3 / 0.02) ** (1 / 3))
KW = dict(n_total=N, box_size=BOX, radius=RADIUS, dt=1e-3, constraint_buffer=0.15)
NOISE = 0.05


def clustered_overlapping(seed, frac=0.35):
    rng = np.random.default_rng(seed)
    pos = np.zeros((N, 3))
    pos[:, 0] = rng.uniform(0, BOX, N)
    pos[:, 1] = rng.uniform(0, BOX, N)
    pos[:, 2] = rng.uniform(0, frac * BOX, N)
    return pos


def max_overlap(pos):
    d = pos[:, None, :] - pos[None, :, :]
    d -= BOX * np.round(d / BOX)
    dist = np.sqrt((d ** 2).sum(-1)) + np.eye(N) * 1e9
    return float(2 * RADIUS - dist.min())


def jax_run(mesh, pos0, diffusion):
    init_fn, step_fn = jax_make(mesh, "shard", dtype=jnp.float64,
                                **dict(KW, diffusion_coeff=diffusion))
    js = init_fn(jax.random.PRNGKey(0), pos=pos0)
    words = tuple(int(w) for w in np.asarray(jax.random.key_data(js["key"][0])))
    iters = []
    for _ in range(STEPS):
        js = step_fn(js, 1)
        iters.append(int(np.asarray(js["lcp_iters"])[0]))
    gid, valid = np.asarray(js["gid"]), np.asarray(js["valid"])
    pos = np.zeros((N, 3))
    pos[gid[valid]] = np.asarray(js["pos"])[valid]
    return {"iters": iters, "pos": pos, "gid": np.where(valid, gid, N), "valid": valid,
            "overflow": bool(np.any(np.asarray(js["overflow"]))), "words": words}


@pytest.fixture(scope="module")
def runs():
    torch.set_num_threads(1)
    pos0 = clustered_overlapping(7)
    mesh = Mesh(np.array(jax.devices()[:D]), ("shard",))
    ref = {name: jax_run(mesh, pos0, dc) for name, dc in (("dry", 0.0), ("noise", NOISE))}
    jobs = [(name, bodies.balanced_lcp, (dict(KW, diffusion_coeff=dc), ref[name]["words"],
                                          pos0, STEPS))
            for name, dc in (("dry", 0.0), ("noise", NOISE))]
    port = spawn_ranks(bodies.run_all, D, "cpu", args=(jobs,), timeout=240.0)[0]
    return ref, port, pos0


def _wrapped_err(a, b):
    d = a - b
    d -= BOX * np.round(d / BOX)
    return float(np.abs(d).max())


def test_ranks_import_no_jax(runs):
    assert not bool(runs[1]["jax_imported"])


@pytest.mark.parametrize("name", ["dry", "noise"])
def test_iterations_per_step_equal(runs, name):
    ref, port, _ = runs
    got = port[name]
    assert not got["init"]["overflow"] and not got["overflow"] and not ref[name]["overflow"]
    assert got["step"] == STEPS
    assert got["iters"] == ref[name]["iters"]
    assert got["iters"][0] > 0


@pytest.mark.parametrize("name,tol", [("dry", 1e-12), ("noise", 1e-7)])
def test_positions_and_owners_match(runs, name, tol):
    ref, port, _ = runs
    got = port[name]
    assert _wrapped_err(got["pos"], ref[name]["pos"]) <= tol
    np.testing.assert_array_equal(got["valid"], ref[name]["valid"])
    np.testing.assert_array_equal(got["gid"], ref[name]["gid"])


def test_overlaps_resolved(runs):
    _, port, pos0 = runs
    assert max_overlap(pos0) > 0.3
    assert max_overlap(port["dry"]["pos"]) < 1e-3


def test_keyed_noise_enters_the_solve(runs):
    _, port, _ = runs
    dry, noise = port["dry"], port["noise"]
    # without noise the solve has nothing left to do once the overlaps are
    # resolved; with it every step's drift is projected
    assert dry["iters"][-1] == 0
    assert min(noise["iters"]) > 0
    assert noise["rebuilds"] > dry["rebuilds"] >= 1
