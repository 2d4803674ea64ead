"""The x-slab primitives and the sharded spheres steps (parallel/slab.py,
parallel/sharded_step.py) over 4 gloo ranks on the CPU against the JAX
package over a 4-device mesh, float64, one process group for the file.

- v2 (`make_slab_spheres_step`) at the reference test's config
  (tests/test_parallel.py:37-62: 800 spheres, box 20, E 200, D 0.05,
  dt 2e-4): the port's init from the JAX init's draws equals the JAX init
  slot for slot (float32 staging included), and so does the JAX state
  carried through core.interop; from it, after a block of steps in which
  particles migrate, active, gid and the overflow flags are bit-equal per
  slot, the positions agree within 1e-9, and every particle is owned once.
- v1 (`make_sharded_spheres_step`, 512 spheres in box 16, its rank-keyed
  noise): the positions agree within 1e-9 after 5 steps.
- `halo_exchange` and `migrate` alone, on slots with spheres near every
  face, across the periodic wrap and past the halo capacity: every buffer
  and flag bit-equal.
- The per-gid keys of v2's noise: the words of fold_in(fold_in(key, step),
  gid) bit-equal to jax.random.key_data, and the normals of
  jax.random.normal(k, (3,)) within a few ulp (the erf_inv contract of
  dynamics/brownian.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

import torch_rank_bodies as bodies
from mundy_tpu.parallel import slab as jslab
from mundy_tpu.parallel.sharded_step import make_sharded_spheres_step as jax_v1
from mundy_tpu.parallel.sharded_step import make_slab_spheres_step as jax_v2
from mundy_tpu_torch.dynamics.brownian import fold_in, normal_per_key
from mundy_tpu_torch.parallel.comm import spawn_ranks

D = 4
V2 = dict(n_total=800, box_size=20.0, radius=0.5, youngs=200.0, diffusion=0.05, dt=2e-4,
          max_neighbors=32, cell_capacity=32)
V2_STEPS = 60
V1 = dict(n_total=512, box_size=16.0, radius=0.5, diffusion=0.05, dt=1e-4, max_neighbors=16,
          cell_capacity=32)
V1_STEPS = 5
PRIM_BOX, PRIM_C, PRIM_HW = 12.0, 48, 0.9


def _words(key):
    return tuple(int(w) for w in np.asarray(jax.random.key_data(key)))


def _jax_v2(mesh):
    step, init = jax_v2(mesh, "shard", dtype=jnp.float64, **V2)
    k0 = jax.random.PRNGKey(0)
    pos, active, gid, flags = init(k0)
    raw = np.asarray(jax.random.uniform(k0, (V2["n_total"], 3), dtype=jnp.float64,
                                        maxval=V2["box_size"]))
    start = {"raw": raw, "pos": np.asarray(pos), "active": np.asarray(active),
             "gid": np.asarray(gid), "flags": np.asarray(flags)}
    key = jax.random.PRNGKey(1)
    overlaps = []
    for s in range(V2_STEPS):
        pos, active, gid, flags, mo = step(pos, active, gid, flags, key,
                                           jnp.asarray(s, jnp.int32))
        overlaps.append(float(mo))
    end = {"pos": np.asarray(pos), "active": np.asarray(active), "gid": np.asarray(gid),
           "flags": int(flags), "overlaps": overlaps}
    return start, end, _words(key)


def _jax_v1(mesh):
    step, init = jax_v1(mesh, "shard", dtype=jnp.float64, **V1)
    k0 = jax.random.PRNGKey(3)
    pos = init(k0)
    raw = np.asarray(pos)
    key = jax.random.PRNGKey(4)
    for s in range(V1_STEPS):
        pos, _mo = step(pos, key, jnp.asarray(s, jnp.int32))
    return raw, np.asarray(pos), _words(key)


def _primitive_inputs():
    """Slots of 4 slabs of a 12-wide box: every rank's own spheres (some
    within the halo width of each face, some past a face after a move,
    some across the periodic wrap), enough near rank 1's left face to
    overflow a halo of capacity 16."""
    rng = np.random.default_rng(7)
    w = PRIM_BOX / D
    pos = np.zeros((D * PRIM_C, 3))
    active = np.zeros(D * PRIM_C, bool)
    gid = np.zeros(D * PRIM_C, np.int32)
    n = 0
    for r in range(D):
        k = 30 if r != 1 else 40
        x = rng.uniform(r * w - 0.4, (r + 1) * w + 0.4, k)
        if r == 1:
            x[:20] = rng.uniform(w, w + 0.5, 20)
        pos[r * PRIM_C:r * PRIM_C + k, 0] = np.mod(x, PRIM_BOX) if r != 0 else x
        pos[r * PRIM_C:r * PRIM_C + k, 1:] = rng.uniform(0, PRIM_BOX, (k, 2))
        active[r * PRIM_C:r * PRIM_C + k] = True
        gid[r * PRIM_C:r * PRIM_C + k] = np.arange(n, n + k)
        n += k
    return pos, active, gid


def _jax_primitives(mesh, halo_cap):
    pos, active, gid = _primitive_inputs()

    def body(p, a, g):
        hp, hm, hovf = jslab.halo_exchange(p, a, "shard", PRIM_BOX, PRIM_HW, halo_cap)
        m = jslab.migrate(jslab.ShardState(p, a, g, jnp.asarray(False)), "shard", PRIM_BOX)
        return hp, hm, hovf.reshape(1), m.pos, m.active, m.gid, m.overflow.reshape(1)

    fn = jax.jit(jax.shard_map(body, mesh=mesh, in_specs=(P("shard"),) * 3,
                               out_specs=(P("shard"),) * 7, check_vma=False))
    outs = fn(jnp.asarray(pos), jnp.asarray(active), jnp.asarray(gid))
    names = ("halo_pos", "halo_mask", "halo_ovf", "pos", "active", "gid", "ovf")
    return (pos, active, gid), {k: np.asarray(v) for k, v in zip(names, outs)}


@pytest.fixture(scope="module")
def runs():
    torch.set_num_threads(1)
    mesh = Mesh(np.array(jax.devices()[:D]), ("shard",))
    v2_start, v2_end, v2_key = _jax_v2(mesh)
    v1_raw, v1_end, v1_key = _jax_v1(mesh)
    prim = {cap: _jax_primitives(mesh, cap) for cap in (16, 64)}
    jobs = [("v2", bodies.slab_v2, (V2, v2_start, v2_key, V2_STEPS)),
            ("v1", bodies.slab_v1, (V1, v1_raw, v1_key, V1_STEPS))]
    jobs += [(f"prim{cap}", bodies.slab_primitives,
              (PRIM_BOX, PRIM_HW, cap) + prim[cap][0]) for cap in prim]
    port = spawn_ranks(bodies.run_all, D, "cpu", args=(jobs,), timeout=170.0)[0]
    return {"v2": (v2_start, v2_end), "v1": v1_end,
            "prim": {cap: p[1] for cap, p in prim.items()}}, port


def test_v2_init_matches_reference(runs):
    ref, port = runs
    start = ref["v2"][0]
    for got in (port["v2"]["own"], port["v2"]["carried"]):
        for k, slots in zip(("pos", "active", "gid"), got):
            assert np.array_equal(slots, start[k]), k


def test_v2_block_matches_reference(runs):
    ref, port = runs
    start, end = ref["v2"]
    got = port["v2"]
    assert np.array_equal(got["active"], end["active"])
    assert np.array_equal(got["gid"], end["gid"])
    assert got["flags"] == end["flags"] == 0
    a = end["active"]
    np.testing.assert_allclose(got["pos"][a], end["pos"][a], rtol=0, atol=1e-9)
    np.testing.assert_allclose(got["overlaps"], end["overlaps"], rtol=0, atol=1e-9)


def test_v2_block_migrates_and_conserves(runs):
    ref, port = runs
    start, _ = ref["v2"]
    got = port["v2"]
    n, c = V2["n_total"], got["gid"].shape[0] // D
    owner = np.repeat(np.arange(D), c)
    before = dict(zip(start["gid"][start["active"]], owner[start["active"]]))
    after = dict(zip(got["gid"][got["active"]], owner[got["active"]]))
    assert sorted(after) == list(range(n))
    assert sum(before[g] != after[g] for g in range(n)) > 0  # some migrated


def test_v1_matches_reference(runs):
    ref, port = runs
    np.testing.assert_allclose(port["v1"]["pos"], ref["v1"], rtol=0, atol=1e-9)


@pytest.mark.parametrize("cap", [16, 64])
def test_halo_and_migrate_bit_equal(runs, cap):
    ref, port = runs
    want, got = ref["prim"][cap], port[f"prim{cap}"]
    for k in want:
        assert np.array_equal(got[k], want[k]), k
    assert bool(want["halo_ovf"].any()) == (cap == 16)
    assert want["active"].sum() == _primitive_inputs()[1].sum()


def test_sharded_step_ranks_import_no_jax(runs):
    assert not runs[1]["jax_imported"]


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.float64])
def test_per_gid_keys_match_reference(dtype):
    key = jax.random.PRNGKey(11)
    gid = np.array([0, 1, 2, 799, 65_537, 1 << 30], np.int32)
    for step in (0, 7):
        keys = jax.vmap(lambda g: jax.random.fold_in(jax.random.fold_in(key, step), g))(
            jnp.asarray(gid))
        words = fold_in(fold_in(_words(key), step), torch.as_tensor(gid))
        want = np.asarray(jax.random.key_data(keys)).astype(np.int64)
        assert np.array_equal(np.stack([w.numpy() for w in words], 1), want)
        z = np.asarray(jax.vmap(lambda k: jax.random.normal(k, (3,), dtype))(keys))
        tdt = torch.float32 if dtype == jnp.float32 else torch.float64
        np.testing.assert_allclose(normal_per_key(words, tdt).numpy(), z, rtol=0,
                                   atol=8 * np.finfo(z.dtype).eps * 4)
