"""LCP `hydro="rpy_ring"` over ranks: LCPSpheresSim(group=) against the JAX
app over a device mesh (driver/apps/lcp_spheres.py, parallel/ring_rpy.py).

The reference test's config (tests/test_parallel_lcp.py:101-150): 512
spheres at volume fraction 0.05, dt 1e-3, 10 steps, float64, no noise.
Both packages start from the JAX init's Hilbert-ordered positions; the port
runs over the first 2 and over all 4 of one spawned group of 4 gloo ranks
(a subgroup for d = 2), the JAX app over a mesh of as many devices.
- BBPGD iterations, active count, rebuilds and overflow are equal at every
  step, and the positions agree within 1e-8; every rank holds the same
  counters and the same positions bit for bit.
- The reference test's own checks: the drawn order is Hilbert-local
  (a rank's block spreads less than 0.7 of a random block), the initial
  overlaps (> 0.1) are resolved below 1e-4, and at the final state the ring
  mobility inside resolve_collisions gives the dense RPY operator's gamma
  within 1e-8.
- Over d ranks the spheres must split into d equal blocks.
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import torch_rank_bodies as bodies
from mundy_tpu.driver.apps.lcp_spheres import LCPSpheresConfig as JaxConfig
from mundy_tpu.driver.apps.lcp_spheres import LCPSpheresSim as JaxSim
from mundy_tpu_torch.driver.apps.lcp_spheres import LCPSpheresConfig, LCPSpheresSim
from mundy_tpu_torch.parallel.comm import Group, spawn_ranks

N, RADIUS, STEPS = 512, 0.5, 10
BOX = float((N * (4 / 3) * np.pi * RADIUS ** 3 / 0.05) ** (1 / 3))
KW = dict(num_spheres=N, box_size=BOX, radius=RADIUS, dt=1e-3, hydro="rpy_ring",
          dtype="float64", num_steps=STEPS, log_every=100)
SIZES = (2, 4)


def _counters(s):
    return (int(s.lcp_iters), int(s.act_count), int(s.rebuild_count), bool(s.overflow))


@pytest.fixture(scope="module")
def runs():
    torch.set_num_threads(1)
    ref = {}
    for d in SIZES:
        sim = JaxSim(JaxConfig(**KW), mesh=Mesh(np.array(jax.devices()[:d]), ("shard",)))
        s = sim.init()
        pos0, key = np.array(s.pos), np.asarray(jax.random.key_data(s.key))
        rows = []
        for _ in range(STEPS):
            s = sim.run_block(s, 1, resize=False)
            rows.append(_counters(s))
        ref[d] = {"pos0": pos0, "key": key, "rows": rows, "pos": np.array(s.pos)}
    assert np.array_equal(ref[2]["pos0"], ref[4]["pos0"])
    jobs = [("ring", bodies.ring_lcp, (KW, ref[2]["pos0"], ref[2]["key"], STEPS, SIZES))]
    port = spawn_ranks(bodies.run_all, 4, "cpu", args=(jobs,), timeout=170.0)[0]
    return ref, port


@pytest.mark.parametrize("d", SIZES)
def test_ring_lcp_counters_match_every_step(runs, d):
    ref, port = runs
    assert port["ring"][d]["rows"] == ref[d]["rows"]
    assert max(r[0] for r in ref[d]["rows"]) > 0


@pytest.mark.parametrize("d", SIZES)
def test_ring_lcp_positions_match(runs, d):
    ref, port = runs
    np.testing.assert_allclose(port["ring"][d]["pos"], ref[d]["pos"], rtol=0, atol=1e-8)


@pytest.mark.parametrize("d", SIZES)
def test_ring_lcp_ranks_agree(runs, d):
    """Counters and positions equal bit for bit on every rank, and the ring
    moved bytes."""
    _, port = runs
    assert port["ring"][d]["ranks_agree"]
    assert port["ring"][d]["bytes"] > 0


@pytest.mark.parametrize("d", SIZES)
def test_ring_lcp_resolves_overlaps(runs, d):
    _, port = runs
    r = port["ring"][d]
    assert r["over0"] > 0.1
    assert r["over1"] < 1e-4
    assert not r["rows"][-1][3]


@pytest.mark.parametrize("d", SIZES)
def test_ring_lcp_gamma_matches_dense(runs, d):
    _, port = runs
    assert port["ring"][d]["gamma_err"] <= 1e-8


def test_ring_lcp_ranks_import_no_jax(runs):
    assert not runs[1]["jax_imported"]


def test_ring_lcp_draws_hilbert_local_blocks():
    """The port's own draw (a torch.Generator) is Hilbert-ordered: the
    reference test's locality check on a block of N / 8."""
    pos = LCPSpheresSim(LCPSpheresConfig(**KW), device="cpu").init().pos.numpy()
    blk = pos[:N // 8]
    spread = np.linalg.norm(blk - blk.mean(0), axis=1).mean()
    rand = pos[np.random.default_rng(0).permutation(N)[:N // 8]]
    rand_spread = np.linalg.norm(rand - rand.mean(0), axis=1).mean()
    assert spread < 0.7 * rand_spread


def test_ring_lcp_needs_equal_blocks():
    with pytest.raises(ValueError, match="num_spheres % ranks"):
        LCPSpheresSim(LCPSpheresConfig(**dict(KW, num_spheres=N - 2)), device="cpu",
                      group=Group(0, 4, "cpu", "gloo"))
