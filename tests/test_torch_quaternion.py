"""Quaternion algebra, rigid Euler step and random rotations of the torch
port vs the JAX reference.

Same numpy inputs to both, float64, within 1e-14: the two sides take the
same operations in the same order, so only libm's sin/cos/sqrt may differ
(by an ulp). The small-angle case puts |omega dt / 2| below the 1e-8
switch of quat_from_omega_dt.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mundy_tpu.dynamics.integrators import euler_step_rigid as j_step
from mundy_tpu.geom import periodic as j_periodic
from mundy_tpu.math import linalg as jl
from mundy_tpu.math import quaternion as jq
from mundy_tpu_torch.dynamics.integrators import euler_step_rigid
from mundy_tpu_torch.geom.periodicity import periodic
from mundy_tpu_torch.geom.randomize import random_unit_quaternions
from mundy_tpu_torch.math import linalg as tl
from mundy_tpu_torch.math import quaternion as tq

torch.set_num_threads(1)
TOL = 1e-14


def _draw(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s) for s in shapes]


def _eq(got, ref):
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=TOL)


@pytest.mark.parametrize("name", ["cross", "norm"])
def test_linalg_matches(name):
    a, b = _draw(1, (50, 3), (50, 3))
    if name == "norm":
        _eq(tl.norm(torch.as_tensor(a)), jl.norm(jnp.asarray(a)))
    else:
        _eq(getattr(tl, name)(torch.as_tensor(a), torch.as_tensor(b)),
            getattr(jl, name)(jnp.asarray(a), jnp.asarray(b)))


def test_multiply_normalize_rotate_match():
    q1, q2, v = _draw(2, (64, 4), (64, 4), (64, 3))
    t1, t2, tv = (torch.as_tensor(x) for x in (q1, q2, v))
    _eq(tq.quat_multiply(t1, t2), jq.quat_multiply(jnp.asarray(q1), jnp.asarray(q2)))
    _eq(tq.quat_normalize(t1), jq.quat_normalize(jnp.asarray(q1)))
    u = tq.quat_normalize(t1)
    _eq(tq.quat_rotate(u, tv), jq.quat_rotate(jnp.asarray(u.numpy()), jnp.asarray(v)))
    # broadcast of one vector against a batch, as the rods app rotates zhat
    z = np.array([0.0, 0.0, 1.0])
    _eq(tq.quat_rotate(u, torch.as_tensor(z)),
        jq.quat_rotate(jnp.asarray(u.numpy()), jnp.asarray(z)))


@pytest.mark.parametrize("scale", [1.0, 1e-3, 1e-9, 0.0])
def test_omega_dt_and_integrate_match(scale):
    """scale 1e-9 and 0 put every |omega dt / 2| below the 1e-8 switch."""
    q, w = _draw(3, (64, 4), (64, 3))
    w = w * scale
    dt = 0.01
    got = tq.quat_from_omega_dt(torch.as_tensor(w), dt)
    ref = jq.quat_from_omega_dt(jnp.asarray(w), dt)
    if scale < 1e-8:
        assert (np.linalg.norm(0.5 * dt * w, axis=1) < 1e-8).all()
    _eq(got, ref)
    _eq(tq.quat_integrate(torch.as_tensor(q), torch.as_tensor(w), dt),
        jq.quat_integrate(jnp.asarray(q), jnp.asarray(w), dt))


def test_euler_step_rigid_matches():
    pos, q, v, w = _draw(4, (40, 3), (40, 4), (40, 3), (40, 3))
    pos = np.abs(pos) * 5.0
    q = q / np.linalg.norm(q, axis=1, keepdims=True)
    box = [6.0, 6.0, 6.0]
    dt = 0.05
    tp, tqq = euler_step_rigid(*(torch.as_tensor(x) for x in (pos, q, v, w)),
                               torch.tensor(dt, dtype=torch.float64),
                               metric=periodic(box, dtype=torch.float64))
    jp, jqq = j_step(*(jnp.asarray(x) for x in (pos, q, v, w)), jnp.asarray(dt),
                     metric=j_periodic(np.array(box), dtype=jnp.float64))
    _eq(tp, jp)
    _eq(tqq, jqq)


def test_random_unit_quaternions():
    """torch.Generator draws cannot match jax.random's bits: unit norm,
    reproducible from the seed, and roughly uniform signs."""
    a = random_unit_quaternions(torch.Generator().manual_seed(3), 4000,
                                dtype=torch.float64)
    b = random_unit_quaternions(torch.Generator().manual_seed(3), 4000,
                                dtype=torch.float64)
    assert a.shape == (4000, 4) and torch.equal(a, b)
    assert (a.norm(dim=1) - 1).abs().max() < 1e-15
    assert (a.mean(dim=0).abs() < 0.05).all()
