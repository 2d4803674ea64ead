"""The periphery BIE and the all-pairs RPY: the port vs the JAX package,
float64 on the CPU from the same seeded numpy inputs.

- `gen_sphere_quadrature`, `skfie_matrix` and M^-1 are the same numpy code
  on both sides: within 1e-13 relative of the max (found equal). The
  `.npy` cache written by either package is read by the other.
- `surface_densities`, `double_layer_flow` and `no_slip_correction`:
  within 1e-12 of the max (the order of the sums); a uniform ambient flow
  is cancelled inside, as tests/test_periphery.py holds the reference.
- `rpy_apply_dense` (with and without a periodic metric, the self term and
  the overlap branch, N not a multiple of the chunk) and `rpy_flow_at`:
  within 1e-12 of the max.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mundy_tpu.geom import periodic as jperiodic
from mundy_tpu.mobility import periphery as jpe
from mundy_tpu.mobility import rpy as jrpy
from mundy_tpu_torch.geom.periodicity import periodic
from mundy_tpu_torch.mobility import periphery as tpe
from mundy_tpu_torch.mobility import rpy as trpy

torch.set_num_threads(1)

TOL = 1e-12


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _t(a):
    return torch.as_tensor(np.array(a), dtype=torch.float64)


def test_quadrature_matches():
    j = jpe.gen_sphere_quadrature(12, 2.5, center=(0.3, -0.1, 0.2))
    t = tpe.gen_sphere_quadrature(12, 2.5, center=(0.3, -0.1, 0.2))
    assert t[0].shape == (2 * 13 ** 2, 3)
    for a, b in zip(t, j):
        assert _rel(a, b) <= 1e-13
    with pytest.raises(ValueError, match="order"):
        tpe.gen_sphere_quadrature(0, 1.0)


def test_skfie_matrix_and_inverse_match():
    pts, wts, nrm = tpe.gen_sphere_quadrature(8, 3.0)
    assert _rel(tpe.skfie_matrix(pts, nrm, wts), jpe.skfie_matrix(pts, nrm, wts)) <= 1e-13
    T = tpe.stokes_double_layer_matrix(pts, nrm, wts, pts[:7] * 0.5, 1.0, False)
    assert _rel(T, jpe.stokes_double_layer_matrix(pts, nrm, wts, pts[:7] * 0.5, 1.0,
                                                   False)) <= 1e-13
    tp = tpe.build_sphere_periphery(8, 3.0, dtype=torch.float64)
    jp = jpe.build_sphere_periphery(8, 3.0, dtype=jnp.float64)
    for a, b in zip(tp, jp):
        assert _rel(a.numpy(), b) <= 1e-13
    assert tp.m_inv.shape == (3 * 162, 3 * 162) and tp.m_inv.dtype == torch.float64


def test_cache_is_read_across(tmp_path):
    """A cache written by either package is what the other returns: a
    scaled copy of the file comes back scaled."""
    jcache, tcache = str(tmp_path / "j.npy"), str(tmp_path / "t.npy")
    jp = jpe.build_sphere_periphery(4, 1.0, cache_path=jcache, dtype=jnp.float64)
    tp = tpe.build_sphere_periphery(4, 1.0, cache_path=tcache, dtype=torch.float64)
    assert np.array_equal(np.load(jcache), np.load(tcache))
    assert not (tmp_path / "t.npy.tmp.npy").exists()
    np.save(jcache, 2.0 * np.load(jcache))
    np.save(tcache, 3.0 * np.load(tcache))
    from_j = tpe.build_sphere_periphery(4, 1.0, cache_path=jcache, dtype=torch.float64)
    from_t = jpe.build_sphere_periphery(4, 1.0, cache_path=tcache, dtype=jnp.float64)
    np.testing.assert_array_equal(from_j.m_inv.numpy(), 2.0 * np.asarray(jp.m_inv))
    np.testing.assert_array_equal(np.asarray(from_t.m_inv), 3.0 * tp.m_inv.numpy())
    # a cache of another order is ignored and rewritten
    again = tpe.build_sphere_periphery(5, 1.0, cache_path=jcache, dtype=torch.float64)
    assert again.m_inv.shape == (3 * 72, 3 * 72) and np.load(jcache).shape == (216, 216)


def test_densities_and_flows_match():
    rng = np.random.default_rng(5)
    tp = tpe.build_sphere_periphery(10, 4.0, dtype=torch.float64)
    jp = jpe.build_sphere_periphery(10, 4.0, dtype=jnp.float64)
    u_slip = rng.normal(size=(tp.points.shape[0], 3))
    targets = rng.uniform(-2.5, 2.5, (60, 3))
    q_t = tpe.surface_densities(tp, _t(u_slip))
    q_j = jpe.surface_densities(jp, jnp.asarray(u_slip))
    assert _rel(q_t.numpy(), q_j) <= TOL
    assert _rel(tpe.double_layer_flow(tp, _t(q_j), _t(targets)).numpy(),
                jpe.double_layer_flow(jp, q_j, jnp.asarray(targets))) <= TOL
    assert _rel(tpe.no_slip_correction(tp, _t(u_slip), _t(targets)).numpy(),
                jpe.no_slip_correction(jp, jnp.asarray(u_slip), jnp.asarray(targets))) <= TOL


def test_uniform_flow_cancelled_inside():
    """The reference's check on the port: a no-slip sphere in a uniform
    ambient flow U has the interior correction -U."""
    per = tpe.build_sphere_periphery(12, 1.0, dtype=torch.float64)
    U = torch.tensor([1.0, 0.0, 0.0], dtype=torch.float64)
    targets = _t([[0.0, 0.0, 0.0], [0.3, 0.2, -0.1], [0.0, 0.5, 0.0], [-0.4, 0.1, 0.3]])
    corr = tpe.no_slip_correction(per, U.expand(per.points.shape[0], 3), targets)
    np.testing.assert_allclose(corr.numpy(), np.tile(-U.numpy(), (4, 1)), atol=2e-3)


def _beads(n=150, seed=9):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0.0, 9.0, (n, 3))
    pos[1] = pos[0] + [0.3, 0.2, 0.0]  # an overlapping pair (r < 2a)
    return pos, rng.normal(size=(n, 3))


@pytest.mark.parametrize("metric,include_self,overlap", [
    (False, True, False), (False, False, True), (True, True, True), (True, False, False)])
def test_rpy_apply_dense_matches(metric, include_self, overlap):
    """150 beads in chunks of 64 targets (the last one short), 0.5 radius."""
    pos, f = _beads()
    tm = periodic([9.0] * 3, dtype=torch.float64) if metric else None
    jm = jperiodic(np.array([9.0] * 3), dtype=jnp.float64) if metric else None
    u_t = trpy.rpy_apply_dense(_t(pos), _t(f), 0.5, 1.3, metric=tm, include_self=include_self,
                               overlap_correction=overlap, chunk=64)
    u_j = jrpy.rpy_apply_dense(jnp.asarray(pos), jnp.asarray(f), 0.5, 1.3, metric=jm,
                               include_self=include_self, overlap_correction=overlap,
                               chunk=64)
    assert u_t.shape == (150, 3)
    assert _rel(u_t.numpy(), u_j) <= TOL


def test_rpy_flow_at_matches():
    pos, f = _beads()
    targets = np.random.default_rng(3).uniform(-1.0, 10.0, (70, 3))
    targets[0] = pos[5]  # a node on a bead: the overlap branch at r = 0
    u_t = trpy.rpy_flow_at(_t(targets), _t(pos), _t(f), 0.5, 1.3, chunk=32)
    u_j = jrpy.rpy_flow_at(jnp.asarray(targets), jnp.asarray(pos), jnp.asarray(f), 0.5, 1.3,
                           chunk=32)
    assert _rel(u_t.numpy(), u_j) <= TOL
