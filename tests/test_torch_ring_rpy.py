"""The ring-rotated dense RPY apply (parallel/ring_rpy.py) and the LCP
line's `rpy_ring` mode.

- The ring over 4 gloo ranks on the CPU, each holding a contiguous block of
  the (N, 3) positions and forces, gives mobility/rpy.rpy_apply_dense's
  velocities (free separations, the self pair excluded, the self term
  added) within rtol 1e-10 in float64, with and without the overlap
  branch; its ranks import no JAX (one process group for the file).
- hilbert_shard_permutation is the reference's, element for element.
- LCPSpheresSim(hydro="rpy_ring") on one rank against the JAX app on a
  one-device mesh (the reference's default mesh on a one-chip host): the
  JAX init's Hilbert order is the port's permutation of the same draws,
  and from the JAX initial state the BBPGD iterations, active counts,
  rebuilds and overflow are equal at every step of a block with a skin
  rebuild, the positions within 1e-8 (the Brownian normals, as in
  tests/test_torch_lcp_hydro.py). Over more than one rank the mode runs
  LCPSpheresSim over the ranks (tests/test_torch_ring_lcp.py) and refuses
  spheres that do not split into equal blocks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import torch_rank_bodies as bodies
from mundy_tpu.driver.apps.lcp_spheres import LCPSpheresConfig as JaxConfig
from mundy_tpu.driver.apps.lcp_spheres import LCPSpheresSim as JaxSim
from mundy_tpu.parallel.ring_rpy import hilbert_shard_permutation as jax_perm
from mundy_tpu_torch.driver.apps.lcp_spheres import LCPSpheresConfig, LCPSpheresSim
from mundy_tpu_torch.mobility.rpy import rpy_apply_dense
from mundy_tpu_torch.parallel.comm import Group, spawn_ranks
from mundy_tpu_torch.parallel.ring_rpy import hilbert_shard_permutation

D = 4
N_RING = 400
KW = dict(num_spheres=300, box_size=18.0, radius=0.5, dt=2e-3, diffusion_coeff=0.02,
          dtype="float64", chunk=256, max_allowable_overlap=1e-6,
          max_col_iterations=2000, log_every=1000, hydro="rpy_ring")
STEPS = 14


def _ring_inputs():
    rng = np.random.default_rng(17)
    pos = rng.uniform(0.0, 9.0, (N_RING, 3))  # dense enough for overlapping pairs
    forces = rng.normal(size=(N_RING, 3))
    return pos, forces


@pytest.fixture(scope="module")
def ring():
    torch.set_num_threads(1)
    pos, forces = _ring_inputs()
    jobs = [(f"oc{oc}", bodies.ring_apply, (pos, forces, 0.5, 1.3, oc)) for oc in (True, False)]
    return spawn_ranks(bodies.run_all, D, "cpu", args=(jobs,), timeout=120.0)[0]


@pytest.mark.parametrize("oc", [True, False])
def test_ring_matches_dense_apply(ring, oc):
    pos, forces = _ring_inputs()
    want = rpy_apply_dense(torch.as_tensor(pos), torch.as_tensor(forces), 0.5, 1.3,
                           metric=None, include_self=True, overlap_correction=oc).numpy()
    np.testing.assert_allclose(ring[f"oc{oc}"], want, rtol=1e-10, atol=1e-12 * np.abs(want).max())


def test_ring_ranks_import_no_jax(ring):
    assert not ring["jax_imported"]


def test_ring_on_one_rank_is_the_dense_apply():
    pos, forces = (torch.as_tensor(a) for a in _ring_inputs())
    from mundy_tpu_torch.parallel.ring_rpy import make_ring_rpy_apply

    got = make_ring_rpy_apply(Group.single("cpu"), 0.5, 1.3, overlap_correction=True)(pos, forces)
    want = rpy_apply_dense(pos, forces, 0.5, 1.3, include_self=True, overlap_correction=True)
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-14)


@pytest.mark.parametrize("bits", [10, 6])
def test_hilbert_permutation_matches_reference(bits):
    pos = np.random.default_rng(bits).uniform(-1.0, 21.0, (1000, 3))  # some outside the box
    np.testing.assert_array_equal(hilbert_shard_permutation(pos, [0.0] * 3, [20.0] * 3, bits),
                                  jax_perm(pos, [0.0] * 3, [20.0] * 3, bits))


def _counters(s):
    return (int(s.lcp_iters), int(s.act_count), int(s.act_block_max),
            int(s.rebuild_count), bool(s.overflow))


@pytest.fixture(scope="module")
def lcp():
    torch.set_num_threads(1)
    jsim = JaxSim(JaxConfig(**KW), mesh=Mesh(np.array(jax.devices()[:1]), ("shard",)))
    js = jsim.init()
    tsim = LCPSpheresSim(LCPSpheresConfig(**KW), device="cpu")
    ts = tsim.init(pos=torch.from_numpy(np.array(js.pos)),
                   key_words=np.asarray(jax.random.key_data(js.key)))
    return jsim, js, tsim, ts


def test_lcp_ring_init_order_matches(lcp):
    jsim, js, tsim, ts = lcp
    kpos, _ = jax.random.split(jax.random.PRNGKey(KW.get("seed", 1234)))
    raw = np.asarray(jax.random.uniform(kpos, (KW["num_spheres"], 3), dtype=jnp.float64,
                                        maxval=KW["box_size"]))
    perm = hilbert_shard_permutation(raw, [0.0] * 3, [KW["box_size"]] * 3)
    np.testing.assert_array_equal(perm, jax_perm(raw, [0.0] * 3, [KW["box_size"]] * 3))
    np.testing.assert_array_equal(raw[perm], np.asarray(js.pos))
    assert _counters(ts) == _counters(js)


def test_lcp_ring_trajectory_matches(lcp):
    jsim, js, tsim, ts = lcp
    for step in range(STEPS):
        js = jsim.run_block(js, 1, resize=False)
        ts = tsim.run_block(ts, 1, resize=False)
        assert _counters(ts) == _counters(js), step
    assert ts.step == int(js.step) == STEPS
    assert int(js.rebuild_count) >= 2  # a skin rebuild inside the block
    assert min(int(js.lcp_iters), ts.lcp_iters) > 0
    np.testing.assert_allclose(ts.pos.numpy(), np.asarray(js.pos), rtol=0, atol=1e-8)
    assert tsim.max_overlap(ts) < 1e-4


def test_lcp_ring_draws_hilbert_order():
    sim = LCPSpheresSim(LCPSpheresConfig(**dict(KW, num_spheres=64)), device="cpu")
    pos = sim.init().pos
    assert torch.equal(torch.as_tensor(hilbert_shard_permutation(pos, [0.0] * 3,
                                                                 [KW["box_size"]] * 3)),
                       torch.arange(64))


def test_lcp_ring_refuses_several_ranks():
    """Over ranks the spheres must split into equal blocks: 300 do over 2
    and 4 ranks (the wrapper is made without a collective) and not over 7."""
    for d in (2, 4):
        sim = LCPSpheresSim(LCPSpheresConfig(**KW), device="cpu", group=Group(0, d, "cpu", "gloo"))
        assert sim.group.size == d
    with pytest.raises(ValueError, match="num_spheres % ranks"):
        LCPSpheresSim(LCPSpheresConfig(**KW), device="cpu", group=Group(0, 7, "cpu", "gloo"))
