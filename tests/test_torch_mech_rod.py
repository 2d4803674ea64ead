"""Kirchhoff rod mechanics of the torch port vs the JAX reference.

Same numpy inputs to both: random bent chains in float64. The frames,
curvatures and the energy take the same operations in the same order, and
the forces are the same gradient taken by torch.autograd and by jax.grad
(each a chain rule through the same expression, the backward passes
associating a few products differently), so everything agrees within
1e-12 of each output's largest magnitude.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mundy_tpu.math import linalg as jl
from mundy_tpu.math import quaternion as jq
from mundy_tpu.mech import rod as jr
from mundy_tpu_torch.math import linalg as tl
from mundy_tpu_torch.math import quaternion as tq
from mundy_tpu_torch.mech import rod as tr

torch.set_num_threads(1)
TOL = 1e-12


def _close(got, ref):
    ref = np.asarray(ref)
    got = got.detach().numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=TOL * max(np.abs(ref).max(), 1e-300))


def _chains(seed, F=6, M=9, bend=0.35):
    """F bent chains of M nodes with unit-ish edges, one of them straight
    along z (the frame seeding's parallel-tangent branch)."""
    rng = np.random.default_rng(seed)
    steps = rng.normal(size=(F, M - 1, 3)) * bend + np.array([1.0, 0.3, -0.2])
    steps /= np.linalg.norm(steps, axis=-1, keepdims=True)
    steps[0] = (0.0, 0.0, 1.0)
    start = rng.uniform(0.0, 20.0, (F, 1, 3))
    return np.concatenate([start, start + np.cumsum(steps, axis=1)], axis=1), rng


def _state_pair(pos):
    return jr.init_rod_edges(jnp.asarray(pos)), tr.init_rod_edges(torch.as_tensor(pos))


def test_dot_conjugate_from_matrix_match():
    rng = np.random.default_rng(1)
    a, b, q = rng.normal(size=(40, 3)), rng.normal(size=(40, 3)), rng.normal(size=(40, 4))
    _close(tl.dot(torch.as_tensor(a), torch.as_tensor(b)), jl.dot(jnp.asarray(a), jnp.asarray(b)))
    _close(tq.quat_conjugate(torch.as_tensor(q)), jq.quat_conjugate(jnp.asarray(q)))
    # rotation matrices from unit quaternions, every Shepperd pivot among
    # them: near-identity, and half turns about x, y and z
    u = q.copy()
    u[:4] = [[1.0, 1e-3, 0.0, 0.0], [1e-3, 1.0, 0.0, 0.0], [0.0, 1e-3, 1.0, 0.0],
             [0.0, 0.0, 1e-3, 1.0]]
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    m = np.array(jq.quat_to_matrix(jnp.asarray(u)))
    got = tq.quat_from_matrix(torch.as_tensor(m))
    _close(got, jq.quat_from_matrix(jnp.asarray(m)))
    # the matrix's rotation comes back (up to sign)
    assert np.minimum(np.abs(got.numpy() - u).max(1), np.abs(got.numpy() + u).max(1)).max() < 1e-12


@pytest.mark.parametrize("seed", [3, 4])
def test_frames_curvature_energy_match(seed):
    pos, rng = _chains(seed)
    js, ts = _state_pair(pos)
    for g, r in zip(ts, js):
        _close(g, r)
    # a moved configuration with a twist rate
    pos2 = pos + 0.05 * rng.normal(size=pos.shape)
    rate = rng.normal(size=pos.shape[:2])
    js2 = jr.update_rod_edges(js, jnp.asarray(pos2), twist_rate=jnp.asarray(rate), dt=1e-2)
    ts2 = tr.update_rod_edges(ts, torch.as_tensor(pos2), twist_rate=torch.as_tensor(rate),
                              dt=1e-2)
    for g, r in zip(ts2, js2):
        _close(g, r)
    for g, r in zip(tr.rod_curvature(ts2), jr.rod_curvature(js2)):
        _close(g, r)
    pos3 = pos2 + 0.05 * rng.normal(size=pos.shape)
    phi = 0.1 * rng.normal(size=pos.shape[:2])
    k0 = 0.2 * rng.normal(size=(pos.shape[0], pos.shape[1] - 2, 3))
    args = (5.0, 200.0, 1.0)
    e_j = jr.rod_energy(js2, jnp.asarray(pos3), jnp.asarray(phi), jnp.asarray(k0), *args)
    e_t = tr.rod_energy(ts2, torch.as_tensor(pos3), torch.as_tensor(phi), torch.as_tensor(k0),
                        *args)
    assert abs(float(e_t) - float(e_j)) <= TOL * abs(float(e_j))


@pytest.mark.parametrize("seed,rest", [(5, False), (6, True), (7, True)])
def test_internal_forces_match_jax_grad(seed, rest):
    """-grad of the energy at phi = 0: autograd against jax.grad, with and
    without a rest curvature, after a transport step (frames off the
    current tangents, so the transport quaternion is not the identity)."""
    pos, rng = _chains(seed)
    js, ts = _state_pair(pos)
    pos2 = pos + 0.04 * rng.normal(size=pos.shape)
    k0 = (0.3 * rng.normal(size=(pos.shape[0], pos.shape[1] - 2, 3)) if rest
          else np.zeros((pos.shape[0], pos.shape[1] - 2, 3)))
    args = (2.0, 100.0, 1.0)
    fj, tj = jr.rod_internal_forces(js, jnp.asarray(pos2), jnp.asarray(k0), *args)
    ft, tt = tr.rod_internal_forces(ts, torch.as_tensor(pos2), torch.as_tensor(k0), *args)
    _close(ft, fj)
    _close(tt, tj)
    # internal forces carry no net force
    assert abs(ft.sum(dim=(0, 1))).max() < 1e-10 * abs(ft).max()


def test_internal_forces_inside_no_grad_leave_no_graph():
    pos, _ = _chains(8)
    ts = tr.init_rod_edges(torch.as_tensor(pos))
    p = torch.as_tensor(pos + 0.01)
    k0 = torch.zeros((pos.shape[0], pos.shape[1] - 2, 3), dtype=torch.float64)
    with torch.no_grad():
        f, tau = tr.rod_internal_forces(ts, p, k0, 2.0, 100.0, 1.0)
    f2, tau2 = tr.rod_internal_forces(ts, p, k0, 2.0, 100.0, 1.0)
    assert not (f.requires_grad or tau.requires_grad or p.requires_grad)
    assert f.grad_fn is None and f2.grad_fn is None
    assert torch.equal(f, f2) and torch.equal(tau, tau2)
    assert float(abs(f).max()) > 0
