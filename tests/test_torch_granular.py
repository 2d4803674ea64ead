"""The granular slice: build_pair_list, frictional_hertzian_contact and the
GranularSim against the JAX package on the CPU.

The pair list is compared exactly (capacity overflow included), the
frictional contact in float64 on seeded overlapping pairs where some slide
(Coulomb-capped) and some stick, and the app in float64 for 300 spheres
and 200 steps from the JAX app's state: equal rebuilds and pair lists,
positions, velocities and tangential history within 1e-8.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mundy_tpu.driver.apps.granular import GranularConfig as JaxConfig
from mundy_tpu.driver.apps.granular import GranularSim as JaxSim
from mundy_tpu.driver.apps.granular import GranularState as JaxState
from mundy_tpu.forces.friction import frictional_hertzian_contact as jax_friction
from mundy_tpu.neighbor import cell_list as jcl
from mundy_tpu_torch.core.config import config_from_dict
from mundy_tpu_torch.core.interop import neighbor_matrix_from_numpy
from mundy_tpu_torch.driver.apps.granular import GranularConfig, GranularSim
from mundy_tpu_torch.forces.friction import frictional_hertzian_contact
from mundy_tpu_torch.neighbor import PairList, build_pair_list

torch.set_num_threads(1)


def _nmat(rng, n=120, box=6.0):
    """A JAX neighbor matrix of random spheres in a periodic box."""
    pos = rng.uniform(0, box, (n, 3))
    grid = jcl.make_cell_grid([0, 0, 0], [box] * 3, 1.2, (True,) * 3, jnp.float64)
    clist = jcl.build_cell_list(jnp.asarray(pos), grid, 32)
    return jcl.neighbor_matrix(jnp.asarray(pos), clist, jnp.asarray(0.6), max_neighbors=24)


@pytest.mark.parametrize("capacity", [4096, 100], ids=["fits", "overflows"])
def test_build_pair_list_matches(rng, capacity):
    jn = _nmat(rng)
    want = jcl.build_pair_list(jn, capacity)
    got = build_pair_list(neighbor_matrix_from_numpy(jn.idx, jn.mask, jn.overflow), capacity)
    for name in ("i", "j", "mask"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)))
    assert int(got.num_pairs) == int(want.num_pairs)
    assert bool(got.overflow) == bool(want.overflow) == (capacity == 100)
    assert got.i.dtype == got.j.dtype == torch.int32


def _pairs_np(n, rng):
    """Overlapping pairs (i < j) of n spheres, padded with masked (0, 0)."""
    i = rng.integers(0, n - 1, 60)
    j = i + rng.integers(1, 4, 60)
    j = np.minimum(j, n - 1)
    keep = i < j
    i, j = i[keep], j[keep]
    cap = len(i) + 8
    mask = np.zeros(cap, bool)
    mask[:len(i)] = True
    return (np.concatenate([i, np.zeros(8, int)]).astype(np.int32),
            np.concatenate([j, np.zeros(8, int)]).astype(np.int32), mask)


def test_frictional_contact_matches_stick_and_slip(rng):
    n = 40
    pos = np.cumsum(rng.uniform(0.3, 0.6, (n, 3)), axis=0) * 0.4
    vel = rng.normal(size=(n, 3))
    radius = rng.uniform(0.4, 0.6, n)
    i, j, mask = _pairs_np(n, rng)
    # histories from 1e-3 to ~2: the long ones pass the Coulomb cap
    tang = rng.normal(size=(len(i), 3)) * 10.0 ** rng.uniform(-3, 0.3, (len(i), 1))
    kw = dict(normal_spring=5e4, normal_damping=20.0, tang_spring=2e4, tang_damping=10.0,
              friction_coeff=0.5, density=1.0)
    jp = jcl.PairList(i=jnp.asarray(i), j=jnp.asarray(j), mask=jnp.asarray(mask),
                      num_pairs=jnp.asarray(int(mask.sum())), overflow=jnp.asarray(False))
    want = jax_friction(jnp.asarray(pos), jnp.asarray(vel), jnp.asarray(radius), jp,
                        jnp.asarray(tang), jnp.asarray(1e-3), **kw)
    tp = PairList(i=torch.from_numpy(i), j=torch.from_numpy(j), mask=torch.from_numpy(mask),
                  num_pairs=torch.tensor(int(mask.sum())), overflow=torch.tensor(False))
    got = frictional_hertzian_contact(torch.from_numpy(pos), torch.from_numpy(vel),
                                      torch.from_numpy(radius), tp, torch.from_numpy(tang),
                                      torch.tensor(1e-3, dtype=torch.float64), **kw)
    # both regimes occur: the uncapped law's history differs where the cap
    # rescaled it (slip) and equals it where the contact sticks
    free = jax_friction(jnp.asarray(pos), jnp.asarray(vel), jnp.asarray(radius), jp,
                        jnp.asarray(tang), jnp.asarray(1e-3), **dict(kw, friction_coeff=1e9))
    in_contact = np.asarray(want.normal_force_mag) > 0
    slid = np.any(np.asarray(free.tang_disp) != np.asarray(want.tang_disp), axis=1)
    assert (in_contact & slid).sum() >= 3 and (in_contact & ~slid).sum() >= 3
    assert (mask & ~in_contact).sum() >= 1
    for name in ("forces", "torques", "tang_disp", "normal_force_mag"):
        w, g = np.asarray(getattr(want, name)), getattr(got, name).numpy()
        assert np.abs(w).max() > 0
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-12 * np.abs(w).max(), err_msg=name)


# the reference settling test's config, with capacities that hold the
# shallow layer's contacts from the start
KW = dict(num_spheres=300, box_size=10.0, radius=0.5, dt=5e-4, num_steps=200,
          normal_damping=100.0, tang_damping=50.0, dtype="float64", chunk=512,
          log_every=100, cell_capacity=32, max_neighbors=32, pair_capacity_per_body=16)


@pytest.fixture(scope="module")
def granular():
    """The JAX app's state with a shallow layer (z in [0.6, 4], as the
    reference's settling test lays it), and that state after 200 steps."""
    jsim = JaxSim(JaxConfig(**KW))
    js = jsim.init()
    pos = np.array(js.pos)
    pos[:, 2] = np.random.default_rng(7).uniform(0.6, 4.0, pos.shape[0])
    pairs, ovf = jsim._broad_phase(jnp.asarray(pos))
    js0 = JaxState(pos=jnp.asarray(pos), vel=js.vel, key=js.key, step=js.step, pairs=pairs,
                   tang_disp=js.tang_disp, ref_pos=jnp.asarray(pos),
                   rebuild_count=js.rebuild_count, overflow=ovf)
    return jsim, js0, jsim.run_block(js0, 200)


def _start(js0):
    tsim = GranularSim(config_from_dict(GranularConfig, KW), device="cpu")
    ts = tsim.init(pos=torch.from_numpy(np.array(js0.pos)),
                   key_words=np.asarray(jax.random.key_data(js0.key)))
    return tsim, ts


def _assert_pairs_equal(tp, jp):
    for name in ("i", "j", "mask"):
        np.testing.assert_array_equal(getattr(tp, name).numpy(), np.asarray(getattr(jp, name)))
    assert int(tp.num_pairs) == int(jp.num_pairs)


def test_init_pairs_match(granular):
    _, js0, _ = granular
    tsim, ts = _start(js0)
    _assert_pairs_equal(ts.pairs, js0.pairs)
    assert ts.tang_disp.shape == (tsim.pair_capacity, 3) and not bool(ts.overflow)


def test_granular_trajectory_matches(granular):
    jsim, js0, js = granular
    tsim, ts = _start(js0)
    ts = tsim.run_block(ts, 200)
    assert int(js.rebuild_count) >= 3  # init + block start + >= 1 skin rebuild
    assert ts.rebuild_count == int(js.rebuild_count) and ts.step == 200
    assert bool(ts.overflow) == bool(js.overflow) is False
    _assert_pairs_equal(ts.pairs, js.pairs)
    td = np.asarray(js.tang_disp)
    assert np.abs(td).max() > 0  # history carried across the rebuilds
    for got, want in ((ts.pos, js.pos), (ts.vel, js.vel), (ts.tang_disp, js.tang_disp)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-8)
    assert abs(tsim.kinetic_energy(ts) - jsim.kinetic_energy(js)) <= 1e-8 * max(
        1.0, jsim.kinetic_energy(js))


def test_regrow_carries_history(granular):
    """regrow grows every capacity (pairs 1024-aligned) and keeps each
    contact's history, as the reference's does."""
    _, _, js = granular
    tsim, ts = _start(js)
    ts = ts.replace(pairs=PairList(*(torch.from_numpy(np.array(getattr(js.pairs, f)))
                                     for f in PairList._fields)),
                    tang_disp=torch.from_numpy(np.array(js.tang_disp)))
    cap = tsim.pair_capacity
    tg = tsim.regrow(ts)
    assert tsim.pair_capacity > cap and tsim.pair_capacity % 1024 == 0
    assert tg.tang_disp.shape == (tsim.pair_capacity, 3)
    old = {(int(a), int(b)): v.numpy() for a, b, m, v in
           zip(ts.pairs.i, ts.pairs.j, ts.pairs.mask, ts.tang_disp) if m}
    for a, b, m, v in zip(tg.pairs.i, tg.pairs.j, tg.pairs.mask, tg.tang_disp):
        if m:
            np.testing.assert_array_equal(v.numpy(), old.get((int(a), int(b)), np.zeros(3)))
    assert bool((tg.tang_disp != 0).any())


def test_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        GranularSim(GranularConfig(num_spheres=100, box_size=10.0))
