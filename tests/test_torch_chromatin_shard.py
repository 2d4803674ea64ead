"""The sharded chromatin engine (parallel/chromatin_shard.py) and the
chromatin route of ShardedSim on 2 gloo ranks on the CPU (one process group
for the file, whose ranks import no JAX), float64, at the reference tests'
sizes (tests/test_chromatin_shard.py), against the JAX engine over a 2-device
mesh and against the port's single-device ChromatinSim.

- Dry, no crosslinkers, confined: 40 steps bit-identical to the port's
  ChromatinSim (torch.equal; the same arithmetic on each rank's own rows),
  with its rebuild count.
- Dry with 32 crosslinkers: 6 steps within 1e-12 of the port's
  ChromatinSim with equal binding states and targets (the reference test's
  bar: the crosslinker psum sums in another order than the single-device
  scatter).
- The dry engine with crosslinkers, rpy_spectral (8 x 16 beads in a box of
  12) and rpy_periphery (8 x 16 beads, order 4): 6 steps within 1e-8 of the
  JAX engine, equal binding states and targets. 1e-8 is the single-device
  apps' bar (tests/test_torch_chromatin_app_free.py): the Brownian normals'
  erf_inv and the order of the sums round differently in the two packages
  (the crosslinker case lands at ~3e-9).
- ShardedSim("chromatin") over blocks of 3, 3 and 6 steps, the contact
  rows cut to 4 so that the first block overflows: the route regrows
  through the sim's own regrow and then ends within 1e-12 of the
  single-device sim over the same blocks, with its rebuild count and equal
  binding states (the engine keeps the sim's rebuild cadence across
  blocks, so the KMC candidate rows keep their order); the gathered state
  holds the positions of the last rebuild and the searches at them, as the
  single-device sim's state does.
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import torch_rank_bodies as bodies
from mundy_tpu.driver.apps.chromatin import ChromatinConfig as JConfig
from mundy_tpu.driver.apps.chromatin import ChromatinSim as JSim
from mundy_tpu.parallel.chromatin_shard import make_sharded_chromatin_step as jax_make
from mundy_tpu_torch.driver.apps.chromatin import ChromatinConfig, ChromatinSim
from mundy_tpu_torch.parallel.comm import spawn_ranks

D = 2
BASE = dict(num_chains=8, beads_per_chain=32, num_crosslinkers=32, periphery_radius=9.0,
            diffusion_coeff=0.05, binding_rate=50.0, unbinding_rate=2.0, dt=2e-4,
            max_neighbors=48, cell_capacity=48, dtype="float64", chunk=256, log_every=1000)
CASES = {
    "dry": dict(num_crosslinkers=0),
    "xl": {},
    "spectral": dict(beads_per_chain=16, num_crosslinkers=16, periphery_radius=0.0,
                     hydro="rpy_spectral", box_size=12.0, dt=1e-4),
    "periphery": dict(beads_per_chain=16, num_crosslinkers=16, hydro="rpy_periphery",
                      periphery_order=4, dt=1e-4),
}
STEPS = {"dry": 40, "xl": 6, "spectral": 6, "periphery": 6}
JAX_CASES = ("xl", "spectral", "periphery")
ROUTE_BLOCKS = (3, 3, 6)


def cfg(case, cls=ChromatinConfig):
    return cls(**{**BASE, **CASES[case]})


@pytest.fixture(scope="module")
def runs():
    torch.set_num_threads(1)
    jobs = [(case, bodies.chromatin_engine, (cfg(case), (STEPS[case],))) for case in CASES]
    jobs.append(("route", bodies.block_route, ("chromatin", cfg("xl"), ROUTE_BLOCKS, None, 4)))
    port = spawn_ranks(bodies.run_all, D, "cpu", args=(jobs,), timeout=240.0)[0]
    mesh = Mesh(np.array(jax.devices()[:D]), ("shard",))
    ref = {}
    for case in JAX_CASES:
        sim = JSim(cfg(case, JConfig))
        shard_fn, step_fn, gather_fn = jax_make(mesh, "shard", sim)
        pos, xs, bt = gather_fn(step_fn(shard_fn(sim.init()), STEPS[case]))
        ref[case] = {"pos": pos, "xl_state": xs, "bound_to": bt}
    return port, ref


def _single(case, steps):
    sim = ChromatinSim(cfg(case), device="cpu")
    return sim.run_block(sim.init(), steps)


def test_dry_without_crosslinkers_bit_identical(runs):
    got = runs[0]["dry"][0]
    st = _single("dry", STEPS["dry"])
    assert not got["overflow"] and not bool(st.overflow)
    assert got["step"] == STEPS["dry"] and got["rebuilds"] == st.rebuild_count >= 2
    assert np.array_equal(got["pos"], st.pos.numpy())


def test_dry_with_crosslinkers_matches_single_device(runs):
    got = runs[0]["xl"][0]
    st = _single("xl", STEPS["xl"])
    assert not got["overflow"] and not bool(st.overflow)
    assert np.abs(got["pos"] - st.pos.numpy()).max() < 1e-12
    np.testing.assert_array_equal(got["xl_state"], st.xl_state.numpy())
    np.testing.assert_array_equal(got["bound_to"], st.xl_bound_to.numpy())


@pytest.mark.parametrize("case,tol", [("xl", 1e-8), ("spectral", 1e-8), ("periphery", 1e-8)])
def test_engine_matches_the_jax_engine(runs, case, tol):
    got, ref = runs[0][case][0], runs[1][case]
    assert not got["overflow"] and got["step"] == STEPS[case]
    diff = got["pos"] - ref["pos"]
    box = CASES[case].get("box_size", 0.0)
    if box:
        diff -= box * np.round(diff / box)
    assert np.abs(diff).max() < tol
    np.testing.assert_array_equal(got["xl_state"], ref["xl_state"])
    np.testing.assert_array_equal(got["bound_to"], ref["bound_to"])
    if case != "spectral":
        assert (got["xl_state"] == 2).any()  # crosslinkers bound across the block
    if case == "periphery":
        assert np.linalg.norm(got["pos"], axis=1).max() < BASE["periphery_radius"] + 1.0


def test_route_regrows_and_matches_single_device(runs):
    got = runs[0]["route"]
    assert got["regrows"] >= 1 and got["k"] > 4 and got["step"] == sum(ROUTE_BLOCKS)
    assert got["describe"].startswith("sharded over 2 ranks: the whole-chain block")
    sim = ChromatinSim(cfg("xl"), device="cpu")
    st = sim.init()
    for n in ROUTE_BLOCKS:  # the rebuild cadence holds across blocks
        st = sim.run_block(st, n)
    assert got["rebuilds"] == st.rebuild_count
    assert np.abs(got["pos"] - st.pos.numpy()).max() < 1e-12
    np.testing.assert_array_equal(got["xl_state"], st.xl_state.numpy())
    np.testing.assert_array_equal(got["bound_to"], st.xl_bound_to.numpy())


def test_route_state_holds_the_last_rebuild(runs):
    """The gathered app state carries the engine's positions of its last
    rebuild and the searches at them, as an uninterrupted single-device run
    holds them, so a checkpoint taken at a block boundary resumes the same
    rebuild cadence and KMC rows."""
    got = runs[0]["route"]
    sim = ChromatinSim(cfg("xl"), device="cpu")
    st0 = sim.init()
    st = sim.run_block(st0, sum(ROUTE_BLOCKS))
    assert st.rebuild_count > st0.rebuild_count  # the last rebuild is not the first one
    assert np.abs(got["ref_pos"] - st.ref_pos.numpy()).max() < 1e-12
    # the route's regrow resized the contact and candidate rows, so they
    # differ in width from the sim's: the same hits, in the same order
    for name, want in (("nmat_idx", st.nmat.idx), ("kmc_idx", st.kmc_nmat.idx)):
        have, want = got[name], want.numpy()
        k = min(have.shape[1], want.shape[1])
        np.testing.assert_array_equal(have[:, :k], want[:, :k])
        assert (have[:, k:] == sim.N).all() and (want[:, k:] == sim.N).all()


def test_no_rank_imported_jax(runs):
    assert not runs[0]["jax_imported"]
