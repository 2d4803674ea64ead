"""The z-slab rods engine over 4 gloo ranks on the CPU against the JAX
engine over a 4-device mesh (parallel/slab_segments.py).

Both start from the same float64 centres and quaternions and the JAX init's
stream key. Over a block with a skin rebuild in the local mode and rods
crossing between slabs, the port's rows (gid, valid) are bit-equal to the
reference's, the centres agree within 1e-9 and the quaternions within 1e-9
up to sign; the port's local rebuild gives its global rebuild's state bit
for bit. D and D_rot are small for the reason tests/test_torch_slab_rows.py
gives (the two packages' Brownian normals differ by up to 2 float32 ulp on
~5% of draws); the contact forces of the random start drive the rebuilds.
ShardedSim over the same ranks, in two blocks, holds the single-device
RowRodsSim within 1e-7. All of it runs in one process group, whose ranks
import no JAX.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import torch_rank_bodies as bodies
from mundy_tpu.geom.randomize import random_unit_quaternions
from mundy_tpu.parallel.slab_segments import make_slab_rods_step as jax_make
from mundy_tpu_torch.driver.apps.rods import RodsConfig
from mundy_tpu_torch.driver.apps.rods_rows import RowRodsSim
from mundy_tpu_torch.parallel.comm import spawn_ranks

D = 4
N, BOX = 400, 24.0  # cutoff 2.6: nz = 9 -> 8 over 4 ranks, nzl = 2 (the local resort)
KW = dict(n_total=N, box_size=BOX, length=2.0, radius=0.25, youngs=1000.0, poisson=0.3,
          viscosity=1.0, diffusion=2e-4, rot_diffusion=2e-4, dt=2e-3, skin=0.1)
STEPS = 20
# config #3's physics at chip_smoke's float64 size, in two blocks of 5
SHARDED = RodsConfig(num_rods=400, box_size=24.0, diffusion_coeff=0.05,
                     rot_diffusion_coeff=0.05, dtype="float64", log_every=1000)


@pytest.fixture(scope="module")
def runs():
    torch.set_num_threads(1)
    mesh = Mesh(np.array(jax.devices()[:D]), ("shard",))
    init_fn, step_fn, grid = jax_make(mesh, "shard", dtype=jnp.float64, **KW)
    kp, kq = jax.random.split(jax.random.PRNGKey(5))
    pos0 = np.asarray(jax.random.uniform(kp, (N, 3), dtype=jnp.float64, maxval=BOX))
    quat0 = np.asarray(random_unit_quaternions(kq, N, dtype=jnp.float64))
    js = init_fn(jax.random.PRNGKey(7), pos=pos0, quat=quat0)
    words = tuple(int(w) for w in np.asarray(jax.random.key_data(js["key"])))
    js = step_fn(js, STEPS)
    ref = {k: np.asarray(js[k]) for k in ("pos", "quat", "valid", "gid")}
    ref["overflow"] = bool(js["overflow"])
    ref["grid"] = (grid.ny, grid.nz, grid.row_capacity)
    gen = torch.Generator().manual_seed(4)
    spos = torch.rand((400, 3), dtype=torch.float64, generator=gen) * 24.0
    squat = torch.nn.functional.normalize(torch.randn((400, 4), dtype=torch.float64,
                                                      generator=gen), dim=1)
    init = dict(pos=spos, quat=squat, key_words=(0, 9))
    jobs = [("slab", bodies.slab_pair, ("rods", KW, (pos0, words), {"quat": quat0}, STEPS)),
            ("sharded", bodies.sharded_blocks, ("rods", SHARDED, init, (5, 5)))]
    port = spawn_ranks(bodies.run_all, D, "cpu", args=(jobs,), timeout=240.0)[0]
    single = RowRodsSim(SHARDED, device="cpu")
    s = single.run_block(single.init(**init), 10)
    return ref, port, (single.positions(s).numpy(), single.quaternions(s).numpy())


def _sign_free(a, b):
    return np.minimum(np.abs(a - b).max(-1), np.abs(a + b).max(-1))


def test_ranks_import_no_jax(runs):
    assert not bool(runs[1]["jax_imported"])


def test_grid_and_local_mode(runs):
    ref, port, _ = runs
    loc = port["slab"]["local"]
    assert loc["grid"] == ref["grid"]
    assert (loc["mode"], loc["nzl"], loc["grid"][1]) == ("local", 2, 8)
    assert loc["step"] == STEPS


def test_rows_and_state_match_reference(runs):
    ref, port, _ = runs
    loc = port["slab"]["local"]
    assert loc["rebuilds"] >= 2  # the block's first rebuild and a skin rebuild
    assert not loc["overflow"] and not ref["overflow"]
    np.testing.assert_array_equal(loc["gid"], ref["gid"])
    np.testing.assert_array_equal(loc["valid"], ref["valid"])
    assert loc["valid"].sum() == N
    v = ref["valid"]
    np.testing.assert_allclose(loc["pos"][v], ref["pos"][v], rtol=0, atol=1e-9)
    # every slot: an empty one is reset to the identity at each rebuild and
    # then turned by gid 0's rotational noise, as in the reference
    assert _sign_free(loc["quat"], ref["quat"]).max() <= 1e-9


def test_rods_crossed_between_slabs(runs):
    _, port, _ = runs
    loc = port["slab"]["local"]

    def owner(gid, valid):
        own = np.full(N, -1)
        own[gid[valid]] = np.nonzero(valid)[1] // loc["nzl"]
        return own

    moved = owner(loc["gid"], loc["valid"]) != owner(loc["init_gid"], loc["init_valid"])
    assert moved.sum() >= 1


def test_local_rebuild_bit_equal_to_global(runs):
    _, port, _ = runs
    loc, glo = port["slab"]["local"], port["slab"]["global"]
    assert glo["mode"] == "global" and glo["rebuilds"] == loc["rebuilds"]
    for k in ("gid", "valid", "pos", "ref_pos", "quat"):
        np.testing.assert_array_equal(loc[k], glo[k], err_msg=k)


def test_sharded_sim_matches_single_device(runs):
    _, port, (pos, quat) = runs
    got = port["sharded"]
    assert got["step"] == 10 and not got["overflow"]
    diff = got["pos"] - pos
    diff -= SHARDED.box_size * np.round(diff / SHARDED.box_size)
    assert np.abs(diff).max() < 1e-7
    assert _sign_free(got["quat"], quat).max() < 1e-7
