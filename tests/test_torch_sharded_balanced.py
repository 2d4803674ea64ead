"""The balanced engines at d = 2 and their ShardedSim routes, the convex
solver over ranks and fieldops' reductions over a group, on 2 gloo ranks on
the CPU (one process group, whose ranks import no JAX).

- The granular engine at d = 2 against the JAX engine over a 2-device mesh
  (tests/test_torch_granular_shard.py runs d = 4): migrating rebuilds, live
  tangential history, own gid buffers bit-equal, positions within 1e-9 and
  velocities within 1e-8.
- ShardedSim("lcp_spheres") over the port's LCPSpheresSim state, 25 steps,
  against the single-device LCPSpheresSim within the reference's 1e-5
  (tests/test_driver_sharded.py:49-70's config).
- ShardedSim("granular") over two blocks of 60 steps against GranularSim
  within the reference's 1e-6 (positions) and 1e-5 (velocities)
  (tests/test_granular_shard.py:26-73's bars, test_driver_sharded.py's
  two-block config).
- Regrow of a balanced route: a tight own buffer and neighbor rows overflow,
  regrow grows max_neighbors, cell_capacity and own_slack, and the block
  then ends where the roomy run ends.
- solve_lcp over the 2 ranks (the group in PGDConfig) gives the one-rank
  solve's iterate within 1e-12 and its iteration count, on every rank.
- field_dot, nrm2, asum, amax and amin with the group match the reference's
  psum/pmax/pmin over a 2-device mesh.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

import torch_rank_bodies as bodies
from mundy_tpu.parallel.granular_shard import make_granular_slab_step as jax_make
from mundy_tpu.state import fieldops as jf
from mundy_tpu_torch.driver.apps.granular import GranularConfig, GranularSim
from mundy_tpu_torch.driver.apps.lcp_spheres import LCPSpheresConfig, LCPSpheresSim
from mundy_tpu_torch.math.convex import PGDConfig, solve_lcp
from mundy_tpu_torch.parallel.comm import spawn_ranks

D = 2
GN, GBOX, GSTEPS = 300, 10.0, 150
GKW = dict(n_total=GN, box_size=GBOX, radius=0.5, dt=5e-4, normal_damping=100.0,
           tang_damping=50.0, friction_coeff=0.5)
LCP = LCPSpheresConfig(num_spheres=512, box_size=float((512 * (4 / 3) * np.pi * 0.125 / 0.05)
                                                       ** (1 / 3)),
                       radius=0.5, dt=1e-3, max_allowable_overlap=1e-9, dtype="float64",
                       log_every=1000)
LCP_STEPS = 25
GRAN = GranularConfig(num_spheres=200, box_size=10.0, radius=0.5, dt=5e-4, normal_damping=100.0,
                      tang_damping=50.0, dtype="float64", chunk=512, log_every=10 ** 6)
BLOCKS = (60, 60)
NQ = 64  # the convex problem's size (32 entries a rank)


def cloud(seed, n, zmin, zmax, box):
    rng = np.random.default_rng(seed)
    pos = np.zeros((n, 3))
    pos[:, 0] = rng.uniform(1.0, box - 1.0, n)
    pos[:, 1] = rng.uniform(1.0, box - 1.0, n)
    pos[:, 2] = rng.uniform(zmin, zmax, n)
    return pos


def lcp_problem():
    rng = np.random.default_rng(11)
    a = rng.uniform(1.0, 2.0, NQ)
    q = rng.normal(size=NQ)
    mask = rng.uniform(size=NQ) > 0.1
    return a, q, mask


def single_lcp():
    """The one-rank solve of lcp_over_ranks' problem on the whole vector."""
    a, q, mask = (torch.as_tensor(v) for v in lcp_problem())

    def apply_A(x):
        return a * x - 0.25 * (torch.roll(x, 1) + torch.roll(x, -1))

    return solve_lcp(apply_A, q, config=PGDConfig(max_iters=500, tol=1e-12), mask=mask)


def gran_start():
    sim = GranularSim(GRAN, device="cpu")
    s = sim.init()
    pos = s.pos.numpy().copy()
    pos[:, 2] = np.random.default_rng(3).uniform(0.6, 5.0, GRAN.num_spheres)
    return pos


@pytest.fixture(scope="module")
def runs():
    torch.set_num_threads(1)
    pos0, vel0 = cloud(7, GN, 0.6, 9.0, GBOX), np.zeros((GN, 3))
    mesh = Mesh(np.array(jax.devices()[:D]), ("shard",))
    init_fn, step_fn, gather_fn = jax_make(mesh, "shard", dtype=jnp.float64, **GKW)
    js = step_fn(init_fn(pos0, vel0), GSTEPS)
    p, v, ovf = gather_fn(js)
    ref = {"pos": p, "vel": v, "overflow": ovf, "gid": np.asarray(js["gid"]),
           "rebuilds": int(np.max(np.asarray(js["rebuild_count"])))}
    x, y = np.random.default_rng(5).normal(size=(2, 40, 3))
    m = np.arange(40) % 3 != 0
    f = jax.shard_map(lambda a, b, c: tuple(
        fn(*args, axis_names=("shard",)) for fn, args in (
            (jf.field_dot, (a, b, c)), (jf.field_nrm2, (a, c)), (jf.field_asum, (a, c)),
            (jf.field_amax, (a, c)), (jf.field_amin, (a, c)))),
        mesh=mesh, in_specs=(P("shard"),) * 3, out_specs=(P(),) * 5)
    ref["fields"] = dict(zip(("dot", "nrm2", "asum", "amax", "amin"),
                             (float(v) for v in f(jnp.asarray(x), jnp.asarray(y),
                                                  jnp.asarray(m)))))
    start = gran_start()
    jobs = [("engine", bodies.granular_slab, (GKW, pos0, vel0, GSTEPS)),
            ("lcp", bodies.lcp_sharded, (LCP, LCP_STEPS)),
            ("granular", bodies.granular_sharded, (GRAN, start, BLOCKS)),
            ("regrow", bodies.regrow_balanced, (GRAN, start, 20, 0.6, 2)),
            ("roomy", bodies.granular_sharded, (GRAN, start, (20,))),
            ("solve", bodies.lcp_over_ranks, (*lcp_problem(), 1e-12)),
            ("fields", bodies.field_reductions, (x, y, m))]
    port = spawn_ranks(bodies.run_all, D, "cpu", args=(jobs,), timeout=240.0)[0]
    return ref, port, start


def test_ranks_import_no_jax(runs):
    assert not bool(runs[1]["jax_imported"])


def test_granular_engine_at_two_ranks(runs):
    ref, port, _ = runs
    got = port["engine"]
    assert not got["overflow"] and not ref["overflow"]
    assert got["rebuilds"] == ref["rebuilds"] >= 3 and got["tang_max"] > 0.0
    np.testing.assert_array_equal(got["gid"], ref["gid"])
    np.testing.assert_allclose(got["pos"], ref["pos"], rtol=0, atol=1e-9)
    np.testing.assert_allclose(got["vel"], ref["vel"], rtol=0, atol=1e-8)


def test_lcp_route_matches_single_device(runs):
    got = runs[1]["lcp"]
    assert "density-balanced z-slab lcp_spheres engine" in got["describe"]
    single = LCPSpheresSim(LCP, device="cpu")
    s = single.run_block(single.init(), LCP_STEPS)
    assert got["step"] == s.step == LCP_STEPS and not got["overflow"]
    diff = got["pos"] - s.pos.numpy()
    diff -= LCP.box_size * np.round(diff / LCP.box_size)
    assert np.abs(diff).max() < 1e-5


def test_granular_route_matches_single_device(runs):
    _, port, start = runs
    got = port["granular"]
    sim = GranularSim(GRAN, device="cpu")
    s = sim.init(pos=torch.as_tensor(start))
    for n in BLOCKS:
        s = sim.run_block(s, n)
    assert got["step"] == s.step == sum(BLOCKS) and not got["overflow"]
    assert np.abs(got["pos"] - s.pos.numpy()).max() < 1e-6
    assert np.abs(got["vel"] - s.vel.numpy()).max() < 1e-5


def test_regrow_grows_the_balanced_capacities(runs):
    from mundy_tpu_torch.parallel.balanced_slab import OVF_OWN, OVF_SEARCH

    _, port, _ = runs
    got, roomy = port["regrow"], port["roomy"]
    assert got["regrows"] >= 1 and got["step"] == roomy["step"] == 20
    assert got["bits"][0] & OVF_OWN and got["bits"][0] & OVF_SEARCH
    assert got["own_slack"] > 0.6 and got["max_neighbors"] > 2
    np.testing.assert_allclose(got["pos"], roomy["pos"], rtol=0, atol=1e-12)


def test_solve_over_ranks_matches_one_rank(runs):
    got = runs[1]["solve"]
    want = single_lcp()
    assert got["iters"] == [want.num_iters] * D and want.num_iters > 5
    np.testing.assert_allclose(got["x"], want.x.numpy(), rtol=0, atol=1e-12)
    assert got["residual"] < 1e-12


def test_field_reductions_over_a_group(runs):
    ref, port, _ = runs
    for k, v in ref["fields"].items():
        assert port["fields"][k] == pytest.approx(v, rel=1e-14, abs=0), k
