"""The z-slab spheres engine over 4 gloo ranks on the CPU against the JAX
engine over a 4-device mesh (parallel/slab_rows.py).

Both start from the same float64 positions and the JAX init's stream key.
Over a block with skin rebuilds in the local mode and particles crossing
between slabs, the port's rows (gid, valid) are bit-equal to the
reference's and the positions agree within 1e-9; the port's local rebuild
gives its global rebuild's rows and positions bit for bit. The Brownian
normals of the two packages differ by up to 2 float32 ulp on ~5% of draws
(tests/test_torch_brownian.py), so D is small and the contact forces of
the random start drive the rebuilds: the positions then differ by 4.6e-10
at most over the block (1.8e-15 with D = 0, the noise alone). ShardedSim over the same ranks, in two blocks, holds the
single-device RowSpheresSim within 1e-7 (the reference's bound,
tests/test_driver_sharded.py:45) at that test's config. All of it runs in
one process group, whose ranks import no JAX.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import torch_rank_bodies as bodies
from mundy_tpu.parallel.slab_rows import make_slab_rows_spheres_step as jax_make
from mundy_tpu_torch.driver.apps.spheres import SpheresConfig
from mundy_tpu_torch.driver.apps.spheres_rows import RowSpheresSim
from mundy_tpu_torch.parallel.comm import spawn_ranks

D = 4
N, BOX = 600, 16.0
KW = dict(n_total=N, box_size=BOX, radius=0.5, youngs=1000.0, poisson=0.3, viscosity=1.0,
          diffusion=2e-4, dt=1e-3, skin=0.4)
STEPS = 30
# tests/test_driver_sharded.py's config, float64, in two blocks of 10
SHARDED = SpheresConfig(num_spheres=600, box_size=16.0, radius=0.5, youngs_modulus=200.0,
                        diffusion_coeff=0.05, dt=2e-4, skin=0.4, dtype="float64",
                        log_every=1000)


@pytest.fixture(scope="module")
def runs():
    torch.set_num_threads(1)
    mesh = Mesh(np.array(jax.devices()[:D]), ("shard",))
    init_fn, step_fn, grid = jax_make(mesh, "shard", dtype=jnp.float64, **KW)
    pos0 = np.asarray(jax.random.uniform(jax.random.PRNGKey(5), (N, 3), dtype=jnp.float64,
                                         maxval=BOX))
    js = init_fn(jax.random.PRNGKey(7), pos=pos0)
    words = tuple(int(w) for w in np.asarray(jax.random.key_data(js["key"])))
    js = step_fn(js, STEPS)
    ref = {k: np.asarray(js[k]) for k in ("pos", "valid", "gid")}
    ref["overflow"] = bool(js["overflow"])
    ref["grid"] = (grid.ny, grid.nz, grid.row_capacity)
    spos = torch.rand((600, 3), dtype=torch.float64,
                      generator=torch.Generator().manual_seed(3)) * 16.0
    init = dict(pos=spos, key_words=(0, 9))
    jobs = [("slab", bodies.slab_pair, ("rows", KW, (pos0, words), {}, STEPS)),
            ("sharded", bodies.sharded_blocks, ("spheres", SHARDED, init, (10, 10)))]
    port = spawn_ranks(bodies.run_all, D, "cpu", args=(jobs,), timeout=240.0)[0]
    single = RowSpheresSim(SHARDED, device="cpu")
    s = single.run_block(single.init(**init), 20)
    return ref, port, single.positions(s).numpy()


def test_ranks_import_no_jax(runs):
    assert not bool(runs[1]["jax_imported"])


def test_grid_and_local_mode(runs):
    ref, port, _ = runs
    loc = port["slab"]["local"]
    assert loc["grid"] == ref["grid"]
    assert (loc["mode"], loc["nzl"]) == ("local", ref["grid"][1] // D)
    assert loc["nzl"] >= 2 and loc["step"] == STEPS


def test_rows_and_positions_match_reference(runs):
    ref, port, _ = runs
    loc = port["slab"]["local"]
    assert loc["rebuilds"] >= 2  # the block's first rebuild and a skin rebuild
    assert not loc["overflow"] and not ref["overflow"]
    np.testing.assert_array_equal(loc["gid"], ref["gid"])
    np.testing.assert_array_equal(loc["valid"], ref["valid"])
    assert loc["valid"].sum() == N
    v = ref["valid"]
    np.testing.assert_allclose(loc["pos"][v], ref["pos"][v], rtol=0, atol=1e-9)


def test_particles_crossed_between_slabs(runs):
    _, port, _ = runs
    loc = port["slab"]["local"]
    nzl = loc["nzl"]

    def owner(gid, valid):
        own = np.full(N, -1)
        iz = np.nonzero(valid)[1]
        own[gid[valid]] = iz // nzl
        return own

    moved = owner(loc["gid"], loc["valid"]) != owner(loc["init_gid"], loc["init_valid"])
    assert moved.sum() >= 1


def test_local_rebuild_bit_equal_to_global(runs):
    _, port, _ = runs
    loc, glo = port["slab"]["local"], port["slab"]["global"]
    assert glo["mode"] == "global" and glo["rebuilds"] == loc["rebuilds"]
    for k in ("gid", "valid", "pos", "ref_pos"):
        np.testing.assert_array_equal(loc[k], glo[k], err_msg=k)


def test_sharded_sim_matches_single_device(runs):
    _, port, single = runs
    got = port["sharded"]
    assert got["step"] == 20 and not got["overflow"]
    diff = got["pos"] - single
    diff -= SHARDED.box_size * np.round(diff / SHARDED.box_size)
    assert np.abs(diff).max() < 1e-7
