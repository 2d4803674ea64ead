"""The density-balanced settling engine over 4 gloo ranks on the CPU against
the JAX engine over a 4-device mesh (parallel/balanced_slab.py).

- `balanced_bounds` and `uniform_bounds` are bit-equal to the reference's
  (the boundaries decide ownership), and so is the cell list built with a
  valid mask (the engines' padded slots enter no cell).
- From the reference test's clustered start (1024 spheres in the bottom
  half of the (10, 10, 24) box, float64), over two blocks whose skin
  rebuilds rebalance the slabs and move their boundaries, every rank's own
  gid buffer and valid mask are bit-equal to the reference's and the
  positions agree within 1e-12 (the two packages' Hertz sums differ in the
  last bits); no body is lost or owned twice.
- Uniform slabs overflow their own buffers on that start, in both packages;
  balanced slabs complete.
- `reference_settling_step` agrees with the reference's within 1e-12 over
  10 steps, and the balanced engine with the reference's single-device step
  within 1e-8 over the two blocks (the reference test's bar).
dt is 15x the reference test's, so that two blocks of 40 steps rebuild three
times. All of the multi-rank work runs in one process group, whose ranks
import no JAX.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import torch_rank_bodies as bodies
from mundy_tpu.parallel import balanced_slab as jb
from mundy_tpu_torch.parallel import balanced_slab as tb
from mundy_tpu_torch.parallel.comm import spawn_ranks

D = 4
N, BOX = 1024, (10.0, 10.0, 24.0)
KW = dict(radius=0.3, skin=0.24, dt=1.5e-3, max_neighbors=16, cell_capacity=12)
BLOCKS = (40, 40)
SINGLE_STEPS = 10  # reference_settling_step's own parity run


def clustered(seed, n=N, frac=0.5):
    rng = np.random.default_rng(seed)
    pos = np.empty((n, 3))
    pos[:, 0] = rng.uniform(0.6, BOX[0] - 0.6, n)
    pos[:, 1] = rng.uniform(0.6, BOX[1] - 0.6, n)
    pos[:, 2] = rng.uniform(0.6, frac * BOX[2], n)
    return pos


@pytest.fixture(scope="module")
def runs():
    torch.set_num_threads(1)
    pos0 = clustered(12345)
    mesh = Mesh(np.array(jax.devices()[:D]), ("shard",))
    init_fn, step_fn, gather = jb.make_balanced_settling_step(
        mesh, "shard", N, BOX, dtype=jnp.float64, **KW)
    js = init_fn(pos0)
    for n in BLOCKS:
        js = step_fn(js, n)
    ref = {k: np.asarray(js[k]) for k in ("gid", "valid", "pos", "overflow")}
    ref["gathered"], ref["seen"] = gather(js)
    init_u, _, _ = jb.make_balanced_settling_step(mesh, "shard", N, BOX, dtype=jnp.float64,
                                                  balance="uniform", **KW)
    ref["uniform_overflow"] = bool(np.any(np.asarray(init_u(pos0)["overflow"])))
    jstep = jb.reference_settling_step(N, BOX, dtype=jnp.float64, **KW)
    tstep = tb.reference_settling_step(N, BOX, dtype=torch.float64, device="cpu", **KW)
    jp, tp = jnp.asarray(pos0), torch.as_tensor(pos0)
    single = {}
    for i in range(sum(BLOCKS)):
        jp, _ = jstep(jp)
        if i < SINGLE_STEPS:
            tp, _ = tstep(tp)
        if i == SINGLE_STEPS - 1:
            single["jax_short"], single["port_short"] = np.asarray(jp), tp.numpy()
    single["jax"] = np.asarray(jp)
    kw = dict(KW, n_total=N, box=BOX)
    jobs = [("balanced", bodies.balanced_settling, (kw, pos0, BLOCKS)),
            ("uniform", bodies.balanced_settling, (dict(kw, balance="uniform"), pos0, ()))]
    port = spawn_ranks(bodies.run_all, D, "cpu", args=(jobs,), timeout=240.0)[0]
    return ref, port, single


@pytest.mark.parametrize("d,dtype", [(8, "float64"), (4, "float64"), (4, "float32"),
                                     (2, "float32")])
def test_balanced_bounds_bit_equal(d, dtype):
    rng = np.random.default_rng(d)
    # the reference test's shape: 700 bodies in [0, 3), 100 in [3, 24), and
    # a few invalid ones that must not count
    z = np.concatenate([rng.uniform(0, 3, 700), rng.uniform(3, 24, 100),
                        rng.uniform(0, 1, 40)]).astype(dtype)
    valid = np.arange(z.size) < 800
    want = np.asarray(jb.balanced_bounds(jnp.asarray(z), jnp.asarray(valid), d, 0.0, 24.0))
    got = tb.balanced_bounds(torch.as_tensor(z), torch.as_tensor(valid), d, 0.0, 24.0)
    assert got.numpy().dtype == want.dtype
    np.testing.assert_array_equal(got.numpy(), want)
    counts = np.histogram(z[valid], bins=got.numpy())[0]
    assert counts.max() <= 1.3 * 800 / d and counts.min() >= 0.7 * 800 / d


@pytest.mark.parametrize("cap,periodic", [(24, False), (24, True), (3, True)],
                         ids=["free", "periodic", "overflows"])
def test_cell_list_with_valid_mask_bit_equal(cap, periodic):
    """build_cell_list(..., valid=): masked rows enter no cell and no count
    (the engines' padded own and ghost slots), as in the reference."""
    from mundy_tpu.neighbor import cell_list as jcl
    from mundy_tpu_torch.neighbor import cell_list as tcl

    rng = np.random.default_rng(cap)
    pos = rng.uniform(0, 6.0, (300, 3))
    valid = rng.uniform(size=300) > 0.3
    pos[~valid] = 0.0  # the engines' empty slots sit at the origin
    jg = jcl.make_cell_grid([0, 0, 0], [6.0] * 3, 1.1, (periodic,) * 3, jnp.float64)
    tg = tcl.make_cell_grid([0, 0, 0], [6.0] * 3, 1.1, (periodic,) * 3, torch.float64)
    want = jcl.build_cell_list(jnp.asarray(pos), jg, cap, valid=jnp.asarray(valid))
    got = tcl.build_cell_list(torch.as_tensor(pos), tg, cap, valid=torch.as_tensor(valid))
    for name in ("entries", "counts", "cell_of"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)))
    assert bool(got.overflow) == bool(want.overflow) == (cap == 3)
    assert int(got.counts.sum()) == valid.sum()
    if not periodic or cap != 24:
        return
    jn = jcl.neighbor_matrix(jnp.asarray(pos), want, jnp.asarray(0.55), max_neighbors=16)
    tn = tcl.neighbor_matrix(torch.as_tensor(pos), got, 0.55, max_neighbors=16)
    np.testing.assert_array_equal(tn.idx.numpy(), np.asarray(jn.idx))
    np.testing.assert_array_equal(tn.mask.numpy(), np.asarray(jn.mask))


@pytest.mark.parametrize("d", [2, 3, 4, 8])
def test_uniform_bounds_bit_equal(d):
    for jd, td in ((jnp.float32, torch.float32), (jnp.float64, torch.float64)):
        want = np.asarray(jb.uniform_bounds(d, 0.0, 23.7, jd))
        np.testing.assert_array_equal(tb.uniform_bounds(d, 0.0, 23.7, td).numpy(), want)


def test_ranks_import_no_jax(runs):
    assert not bool(runs[1]["jax_imported"])


def test_own_buffers_bit_equal_after_rebalances(runs):
    ref, port, _ = runs
    got = port["balanced"]
    assert not got["overflow"] and not bool(np.any(ref["overflow"]))
    assert got["rebuilds"] >= 2
    # the rebalance moved every inner boundary
    assert np.all(got["bounds"][1:-1] != got["bounds0"][1:-1])
    np.testing.assert_array_equal(got["valid"], ref["valid"])
    np.testing.assert_array_equal(got["gid"], np.where(ref["valid"], ref["gid"], N))


def test_positions_match_reference(runs):
    ref, port, _ = runs
    got = port["balanced"]
    v = ref["valid"]
    np.testing.assert_allclose(got["pos"][v], ref["pos"][v], rtol=0, atol=1e-12)
    np.testing.assert_array_equal(got["seen"], np.ones(N))
    np.testing.assert_allclose(got["gathered"], ref["gathered"], rtol=0, atol=1e-12)


def test_uniform_slabs_overflow_balanced_complete(runs):
    ref, port, _ = runs
    assert ref["uniform_overflow"]
    uni = port["uniform"]
    assert uni["init"]["overflow"] and uni["init"]["ovf_bits"] & tb.OVF_OWN
    assert uni["counts0"].max() == port["balanced"]["n_cap"]  # a full own buffer
    assert not port["balanced"]["init"]["overflow"]
    assert port["balanced"]["counts0"].max() <= port["balanced"]["n_cap"]


def test_reference_settling_step(runs):
    _, port, single = runs
    np.testing.assert_allclose(single["port_short"], single["jax_short"], rtol=0, atol=1e-12)
    np.testing.assert_allclose(port["balanced"]["gathered"], single["jax"], rtol=0, atol=1e-8)
