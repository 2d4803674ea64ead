"""The sharded granular engine over 4 gloo ranks on the CPU against the JAX
engine over a 4-device mesh (parallel/granular_shard.py); its d = 2 run is
in tests/test_torch_sharded_balanced.py.

Both start from the same float64 cloud (300 spheres in the reference test's
box, z up to 9 so that four slabs stay thicker than the ghost margin) at
rest, with the reference test's damping, and run 150 steps in one block.
The overlaps of the random start push the spheres apart and the skin
rebuilds migrate bodies between slabs dozens of times, carrying the
tangential history across each. Every rank's own gid buffer is bit-equal to
the reference's, the tangential history is alive, and the positions and
velocities agree within 1e-9 and 1e-8: the two packages sum the pair forces
of a row alike but round rsqrt and pow differently in the last bits, which
the dashpots amplify over the block.

A start whose slabs are thinner than the ghost margin breaks the one-hop
ghost contract: ShardedSim's block overflows with the hop bit set, and
regrow raises, naming the contract, since no capacity cures it (ROADMAP
queue 3). All of it runs in one process group, whose ranks import no JAX.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import torch_rank_bodies as bodies
from mundy_tpu.parallel.granular_shard import make_granular_slab_step as jax_make
from mundy_tpu_torch.driver.apps.granular import GranularConfig
from mundy_tpu_torch.parallel.balanced_slab import OVF_HOP
from mundy_tpu_torch.parallel.comm import spawn_ranks

D = 4
N, BOX, STEPS = 300, 10.0, 150
KW = dict(n_total=N, box_size=BOX, radius=0.5, dt=5e-4, normal_damping=100.0,
          tang_damping=50.0, friction_coeff=0.5)
THIN = GranularConfig(num_spheres=N, box_size=BOX, dt=5e-4, dtype="float64", chunk=512,
                      log_every=10 ** 6)


def cloud(seed, zmax):
    rng = np.random.default_rng(seed)
    pos = np.zeros((N, 3))
    pos[:, 0] = rng.uniform(1.0, BOX - 1.0, N)
    pos[:, 1] = rng.uniform(1.0, BOX - 1.0, N)
    pos[:, 2] = rng.uniform(0.6, zmax, N)
    return pos


@pytest.fixture(scope="module")
def runs():
    torch.set_num_threads(1)
    pos0, vel0 = cloud(7, 9.0), np.zeros((N, 3))
    mesh = Mesh(np.array(jax.devices()[:D]), ("shard",))
    init_fn, step_fn, gather_fn = jax_make(mesh, "shard", dtype=jnp.float64, **KW)
    js = step_fn(init_fn(pos0, vel0), STEPS)
    p, v, ovf = gather_fn(js)
    ref = {"pos": p, "vel": v, "overflow": ovf, "gid": np.asarray(js["gid"]),
           "rebuilds": int(np.max(np.asarray(js["rebuild_count"]))),
           "tang_max": float(np.max(np.abs(np.asarray(js["tang"]))))}
    jobs = [("engine", bodies.granular_slab, (KW, pos0, vel0, STEPS)),
            ("thin", bodies.hop_fault, (THIN, cloud(8, 1.2)))]
    port = spawn_ranks(bodies.run_all, D, "cpu", args=(jobs,), timeout=240.0)[0]
    return ref, port


def test_ranks_import_no_jax(runs):
    assert not bool(runs[1]["jax_imported"])


def test_migrating_rebuilds_and_history(runs):
    ref, port = runs
    got = port["engine"]
    assert not got["init"]["overflow"] and not got["overflow"] and not ref["overflow"]
    assert got["step"] == STEPS
    assert got["rebuilds"] == ref["rebuilds"] >= 3
    assert got["tang_max"] > 0.0
    assert abs(got["tang_max"] - ref["tang_max"]) <= 1e-9
    np.testing.assert_array_equal(got["gid"], ref["gid"])


def test_positions_and_velocities_match(runs):
    ref, port = runs
    got = port["engine"]
    np.testing.assert_allclose(got["pos"], ref["pos"], rtol=0, atol=1e-9)
    np.testing.assert_allclose(got["vel"], ref["vel"], rtol=0, atol=1e-8)


def test_thin_slabs_break_the_one_hop_contract(runs):
    got = runs[1]["thin"]
    assert got["overflow"] and got["bits"] & OVF_HOP
    assert got["error"] is not None and "one-hop" in got["error"]
