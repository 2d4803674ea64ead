"""The chromatin app's building blocks: the port vs the JAX package, float64
on the CPU from the same seeded numpy inputs.

- springs (Hookean crosslinkers with repeated targets, FENE-WCA chains)
  and Hertzian contact over a neighbor matrix: within 1e-12 of the max
  (the same arithmetic; repeated targets summed in index order);
- neighbor-RPY mobility: within 1e-12 of the max;
- the KMC candidate stencil (`neighbor_candidates`) and the Hilbert chain
  layout: equal;
- the selector algebra over bead parts: equal masks, the same errors;
- the KMC sweep: `uniform_keyed` draws bit-equal (threefry words and the
  23-bit float map), hence equal bind/unbind decisions and targets;
- the run key: the port's fold_in(key, 1) is jax.random.split(key)[1].
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mundy_tpu.forces import contact as jct
from mundy_tpu.forces import springs as jsp
from mundy_tpu.geom import periodic as jperiodic
from mundy_tpu.kmc import crosslinkers as jk
from mundy_tpu.math.spacefill import hilbert_positions_and_directors as jhilbert
from mundy_tpu.mobility import rpy as jrpy
from mundy_tpu.neighbor import cell_list as jcl
from mundy_tpu.state.select import select as jselect
from mundy_tpu.state import world as jw
from mundy_tpu_torch.core.errors import MundyError
from mundy_tpu_torch.dynamics.brownian import fold_in
from mundy_tpu_torch.forces import contact as tct
from mundy_tpu_torch.forces import springs as tsp
from mundy_tpu_torch.geom.periodicity import periodic as tperiodic
from mundy_tpu_torch.kmc import crosslinkers as tk
from mundy_tpu_torch.math.spacefill import hilbert_positions_and_directors as thilbert
from mundy_tpu_torch.mobility import rpy as trpy
from mundy_tpu_torch.neighbor import cell_list as tcl
from mundy_tpu_torch.state.select import select as tselect
from mundy_tpu_torch.state import world as tw

torch.set_num_threads(1)

BOX = 12.0
TOL = 1e-12


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def _metrics(periodic_box):
    if not periodic_box:
        return None, None
    return (jperiodic(np.array([BOX] * 3), dtype=jnp.float64),
            tperiodic([BOX] * 3, dtype=torch.float64))


def _chains(n_chains=3, per=40, seed=1):
    """Bead chains of unit bonds with random turns, wrapped into the box."""
    rng = np.random.default_rng(seed)
    steps = rng.normal(size=(n_chains, per, 3))
    steps /= np.linalg.norm(steps, axis=-1, keepdims=True)
    steps *= rng.uniform(0.8, 1.3, (n_chains, per, 1))
    pos = np.cumsum(steps, axis=1) + rng.uniform(0, BOX, (n_chains, 1, 3))
    return np.mod(pos.reshape(-1, 3), BOX)


@pytest.mark.parametrize("periodic_box", [False, True], ids=["free", "periodic"])
def test_springs_match(periodic_box):
    pos = _chains()
    n = pos.shape[0]
    jm, tm = _metrics(periodic_box)
    rng = np.random.default_rng(2)
    i = rng.integers(0, n, 50).astype(np.int32)
    j = rng.integers(0, n, 50).astype(np.int32)
    j[:10] = 7  # many crosslinkers on one bead
    mask = rng.uniform(size=50) < 0.7
    want = jsp.hookean_spring_forces(jnp.asarray(pos), jnp.asarray(i), jnp.asarray(j), 10.0,
                                     1.5, mask=jnp.asarray(mask), metric=jm)
    got = tsp.hookean_spring_forces(torch.as_tensor(pos), torch.as_tensor(i),
                                    torch.as_tensor(j), 10.0, 1.5,
                                    mask=torch.as_tensor(mask), metric=tm)
    assert _rel(got.numpy(), want) <= TOL
    want = jsp.fenewca_chain_forces(jnp.asarray(pos), 40, 30.0, 1.5, 1.0, 1.0, metric=jm)
    got = tsp.fenewca_chain_forces(torch.as_tensor(pos), 40, torch.tensor(30.0, dtype=torch.float64),
                                   torch.tensor(1.5, dtype=torch.float64),
                                   torch.tensor(1.0, dtype=torch.float64),
                                   torch.tensor(1.0, dtype=torch.float64), metric=tm)
    assert _rel(got.numpy(), want) <= TOL
    # chain ends carry one bond: forces sum to zero over each chain
    assert float(got.reshape(3, 40, 3).sum(1).abs().max()) < 1e-9


def test_wca_pair_force_matches():
    r = np.linspace(0.05, 1.5, 301)
    want = jct.wca_pair_force(jnp.asarray(r), 1.0, 1.0)
    got = tct.wca_pair_force(torch.as_tensor(r), 1.0, 1.0)
    # the two pow() implementations differ by a few ulp
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-13, atol=0)


def _nmats(pos, periodic_box, radius=0.7, K=24):
    """The same cell-list neighbor matrix on both sides (equal ids)."""
    per = (periodic_box,) * 3
    jg = jcl.make_cell_grid([0, 0, 0], [BOX] * 3, 2 * radius, per, jnp.float64)
    tg = tcl.make_cell_grid([0, 0, 0], [BOX] * 3, 2 * radius, per, dtype=torch.float64)
    jm, tm = _metrics(periodic_box)
    jn = jcl.neighbor_matrix(jnp.asarray(pos), jcl.build_cell_list(jnp.asarray(pos), jg, 32),
                             jnp.asarray(radius), metric=jm, max_neighbors=K, chunk=64)
    tn = tcl.neighbor_matrix(torch.as_tensor(pos), tcl.build_cell_list(torch.as_tensor(pos),
                                                                       tg, 32),
                             radius, metric=tm, max_neighbors=K, chunk=64)
    np.testing.assert_array_equal(tn.idx.numpy(), np.asarray(jn.idx))
    return jn, tn, jm, tm


@pytest.mark.parametrize("periodic_box", [False, True], ids=["free", "periodic"])
def test_contact_and_neighbor_rpy_match(periodic_box):
    pos = _chains(seed=3)
    jn, tn, jm, tm = _nmats(pos, periodic_box)
    want = jct.hertzian_contact_forces(jnp.asarray(pos), jnp.asarray(0.5), jnp.asarray(1000.0),
                                       jnp.asarray(0.3), jn, metric=jm)
    got = tct.hertzian_contact_forces(torch.as_tensor(pos), 0.5, 1000.0, 0.3, tn, metric=tm)
    assert float(np.abs(np.asarray(want)).max()) > 1.0  # beads overlap
    assert _rel(got.numpy(), want) <= TOL
    F = np.random.default_rng(4).normal(size=pos.shape)
    for overlap in (False, True):
        want = jrpy.rpy_apply_neighbors(jnp.asarray(pos), jnp.asarray(F), jn, 0.5, 1.0,
                                        metric=jm, overlap_correction=overlap)
        got = trpy.rpy_apply_neighbors(torch.as_tensor(pos), torch.as_tensor(F), tn, 0.5, 1.0,
                                       metric=tm, overlap_correction=overlap)
        assert _rel(got.numpy(), want) <= TOL


@pytest.mark.parametrize("periodic_box", [False, True], ids=["free", "periodic"])
def test_neighbor_candidates_match(periodic_box):
    pos = _chains(seed=5)
    per = (periodic_box,) * 3
    jg = jcl.make_cell_grid([0, 0, 0], [BOX] * 3, 3.0, per, jnp.float64)
    tg = tcl.make_cell_grid([0, 0, 0], [BOX] * 3, 3.0, per, dtype=torch.float64)
    jl = jcl.build_cell_list(jnp.asarray(pos), jg, 24)
    tl = tcl.build_cell_list(torch.as_tensor(pos), tg, 24)
    q = pos[::7]
    want = jcl.neighbor_candidates(jnp.asarray(q), jl)
    got = tcl.neighbor_candidates(torch.as_tensor(q), tl)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # every bead within one cell edge of a query is a candidate
    for k in range(q.shape[0]):
        d = np.linalg.norm(pos - q[k], axis=1) if not periodic_box else np.linalg.norm(
            (pos - q[k] + BOX / 2) % BOX - BOX / 2, axis=1)
        assert set(np.nonzero(d < 3.0)[0]) <= set(got[k].numpy().tolist())


def _beads(per=10, n_chains=3):
    chain_pos = np.arange(per * n_chains) % per
    hetero = chain_pos < 6
    ends = (chain_pos == 0) | (chain_pos == per - 1)
    active = np.ones(per * n_chains, bool)
    active[-2:] = False
    parts = {"hetero": hetero, "euchro": ~hetero, "chain_end": ends}
    je = jw.EntitySet(fields={}, parts={k: jnp.asarray(v) for k, v in parts.items()},
                      active=jnp.asarray(active), capacity=active.size)
    te = tw.EntitySet(fields={}, parts={k: torch.as_tensor(v) for k, v in parts.items()},
                      active=torch.as_tensor(active), capacity=active.size)
    return je, te


@pytest.mark.parametrize("expr", ["hetero", "hetero & !chain_end", "!hetero | chain_end",
                                  "(euchro | chain_end) & !(hetero & chain_end)",
                                  "hetero|euchro&chain_end"])
def test_select_matches(expr):
    je, te = _beads()
    np.testing.assert_array_equal(tselect(te, expr).numpy(),
                                  np.asarray(jselect(je, expr)))


@pytest.mark.parametrize("expr", ["hetero &", "nucleus", "hetero $ euchro", "(hetero",
                                  "hetero euchro"])
def test_select_rejects_bad_expressions(expr):
    _, te = _beads()
    with pytest.raises(MundyError):
        tselect(te, expr)


def test_link_set():
    idx = torch.tensor([[0, 1], [2, 2], [3, 4]], dtype=torch.int32)
    ls = tw.LinkSet(indices=idx, active=torch.tensor([True, False, True]),
                    fields={"state": torch.ones(3, dtype=torch.int32)},
                    targets=("beads", "beads"))
    assert (ls.capacity, ls.arity, ls.targets) == (3, 2, ("beads", "beads"))
    ls2 = ls.replace(active=torch.zeros(3, dtype=torch.bool))
    assert not bool(ls2.active.any()) and bool(ls.active[0])


def test_hilbert_positions_match():
    for n, side in ((64, 1.0), (512, 1.0), (100, 0.5)):
        want = jhilbert(n, side_length=side)
        got = thilbert(n, side_length=side)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        thilbert(0)


def test_run_key_is_jax_split():
    for seed in (0, 1234, 2**31 + 5):
        key = jax.random.PRNGKey(seed)
        words = tuple(int(w) for w in np.asarray(jax.random.key_data(key)))
        want = np.asarray(jax.random.key_data(jax.random.split(key)[1]))
        assert fold_in(words, 1) == tuple(int(w) for w in want)


def _kmc_inputs(X=64, K=12, seed=6):
    rng = np.random.default_rng(seed)
    rates = rng.uniform(0, 40.0, (X, K))
    mask = rng.uniform(size=(X, K)) < 0.6
    cand = rng.integers(0, 500, (X, K)).astype(np.int32)
    state = rng.choice([1, 2], X).astype(np.int32)
    bound = np.where(state == 2, rng.integers(0, 500, X), -1).astype(np.int32)
    return rates, mask, cand, state, bound


@pytest.mark.parametrize("step", [0, 7, 123456])
def test_kmc_matches(step):
    key = jax.random.PRNGKey(77)
    words = tuple(int(w) for w in np.asarray(jax.random.key_data(key)))
    rates, mask, cand, state, bound = _kmc_inputs()
    X = state.shape[0]
    gid = np.arange(X, dtype=np.int32) * 3 + 1
    for salt in (0x0B1D, 0xB1ED):
        want = jk.uniform_keyed(key, step, jnp.asarray(gid), salt, dtype=jnp.float64)
        got = tk.uniform_keyed(words, step, torch.as_tensor(gid), salt, dtype=torch.float64)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    dt = 0.004  # some crosslinkers bind, some do not
    jb, jc = jk.kmc_bind_events(key, step, jnp.asarray(rates), jnp.asarray(mask), dt,
                                gid=jnp.asarray(gid))
    tb, tcol = tk.kmc_bind_events(words, step, torch.as_tensor(rates), torch.as_tensor(mask),
                                  dt, torch.as_tensor(gid))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(tcol.numpy(), np.asarray(jc))
    assert 0 < int(tb.sum()) < X
    want = jk.crosslinker_kmc_step(key, step, jnp.asarray(state), jnp.asarray(bound),
                                   jnp.asarray(cand), jnp.asarray(rates), jnp.asarray(mask),
                                   koff=5.0, dt=dt, gid=jnp.asarray(gid))
    got = tk.crosslinker_kmc_step(words, step, torch.as_tensor(state), torch.as_tensor(bound),
                                  torch.as_tensor(cand), torch.as_tensor(rates),
                                  torch.as_tensor(mask), koff=5.0, dt=dt,
                                  gid=torch.as_tensor(gid))
    np.testing.assert_array_equal(got.state.numpy(), np.asarray(want.state))
    np.testing.assert_array_equal(got.bound_to.numpy(), np.asarray(want.bound_to))
    assert got.state.dtype == got.bound_to.dtype == torch.int32
    changed = got.state.numpy() != state
    assert changed.any()
    rate = np.linspace(0, 3, 7)
    np.testing.assert_allclose(
        tk.binding_rate_gaussian(torch.as_tensor(rate), 10.0, 1.5, 1.0, 10.0).numpy(),
        np.asarray(jk.binding_rate_gaussian(jnp.asarray(rate), 10.0, 1.5, 1.0, 10.0)),
        rtol=1e-15, atol=0)
