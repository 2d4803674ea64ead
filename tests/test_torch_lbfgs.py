"""math/lbfgs.py of the torch port (one batch of lanes) vs jax.vmap of the
JAX reference's minimize_lbfgs, float64 on the CPU, starts drawn from numpy
with a seed.

Each lane's iteration count must be equal (a finished lane keeps its state
in both), and x and f agree within 1e-10: the arithmetic is the
reference's, and the residual is the rounding of the objectives and their
autodiff gradients (central differences: 1e-8, the step differences of eps
= 1e-7 amplify the objectives' rounding).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mundy_tpu.geom.distance import _foot_point_from_normal as jax_foot
from mundy_tpu.geom.primitives import Ellipsoid as JaxEllipsoid
from mundy_tpu.math.lbfgs import minimize_lbfgs as jax_lbfgs
from mundy_tpu_torch.geom.distance import _foot_point_from_normal as torch_foot
from mundy_tpu_torch.geom.primitives import Ellipsoid as TorchEllipsoid
from mundy_tpu_torch.math.lbfgs import minimize_lbfgs

torch.set_num_threads(1)

_A = np.diag([1.0, 10.0, 100.0])
_b = np.array([1.0, -2.0, 3.0])


def _quadratic_jax(x):
    return 0.5 * x @ jnp.asarray(_A) @ x - jnp.asarray(_b) @ x


def _quadratic_torch(x):
    A, b = torch.from_numpy(_A), torch.from_numpy(_b)
    return 0.5 * ((x @ A) * x).sum(-1) - (x * b).sum(-1)


def _rosenbrock_jax(x):
    return (1 - x[0]) ** 2 + 100.0 * (x[1] - x[0] ** 2) ** 2


def _rosenbrock_torch(x):
    return (1 - x[..., 0]) ** 2 + 100.0 * (x[..., 1] - x[..., 0] ** 2) ** 2


def _compare(jf, tf, x0, tol=1e-10, **kw):
    ref = jax.vmap(lambda a: jax_lbfgs(jf, a, **kw))(jnp.asarray(x0))
    got = minimize_lbfgs(tf, torch.from_numpy(x0), **kw)
    np.testing.assert_array_equal(got.num_iters.numpy(), np.asarray(ref.num_iters))
    np.testing.assert_array_equal(got.converged.numpy(), np.asarray(ref.converged))
    np.testing.assert_allclose(got.x.numpy(), np.asarray(ref.x), rtol=0, atol=tol)
    np.testing.assert_allclose(got.f.numpy(), np.asarray(ref.f), rtol=0, atol=tol)
    return got


@pytest.mark.parametrize("autodiff", [True, False], ids=["autodiff", "central_differences"])
def test_quadratic(autodiff):
    x0 = np.random.default_rng(0).normal(size=(12, 3))
    got = _compare(_quadratic_jax, _quadratic_torch, x0, tol=1e-10 if autodiff else 1e-8,
                   max_iters=100, f_delta_tol=1e-14, use_autodiff=autodiff)
    np.testing.assert_allclose(got.x.numpy(), np.tile(np.linalg.solve(_A, _b), (12, 1)),
                               atol=1e-6)


def test_rosenbrock():
    """Lanes finish after 18-49 iterations: the finished ones keep their
    state while the rest go on, as under vmap."""
    x0 = np.random.default_rng(1).normal(size=(16, 2)) * 1.5
    got = _compare(_rosenbrock_jax, _rosenbrock_torch, x0, max_iters=200, f_delta_tol=1e-16)
    assert len(set(got.num_iters.tolist())) > 5
    np.testing.assert_allclose(got.x.numpy(), np.ones((16, 2)), atol=1e-4)


def test_max_iters_and_memory():
    """A budget that stops lanes before they converge, with a short history
    ring (memory 3 wraps after 3 iterations)."""
    x0 = np.random.default_rng(2).normal(size=(8, 2)) * 1.5
    got = _compare(_rosenbrock_jax, _rosenbrock_torch, x0, max_iters=7, memory=3,
                   f_delta_tol=1e-16)
    assert (got.num_iters == 7).all() and not got.converged.any()


def test_ellipsoid_chart_objective():
    """The objective the ellipsoid polish minimizes (geom/distance.py): the
    squared foot-point gap on the chart n(t) ~ n0 + t0 u + t1 v, memory 4,
    8 iterations, as distance_ellipsoid_ellipsoid runs it."""
    rng = np.random.default_rng(3)
    B = 24
    c1 = rng.uniform(-0.5, 0.5, (B, 3))
    c2 = c1 + rng.uniform(0.8, 2.0, (B, 1)) * rng.normal(size=(B, 3)) / np.sqrt(3)
    q1, q2 = rng.normal(size=(B, 4)), rng.normal(size=(B, 4))
    q1 /= np.linalg.norm(q1, axis=1, keepdims=True)
    q2 /= np.linalg.norm(q2, axis=1, keepdims=True)
    radii = np.broadcast_to([0.25, 0.25, 0.5], (B, 3)).copy()
    n0 = (c2 - c1) / np.linalg.norm(c2 - c1, axis=1, keepdims=True)
    u = np.cross(n0, [0.0, 0.0, 1.0])
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    v = np.cross(n0, u)

    def jax_obj(t, n0, u, v, c1, q1, c2, q2, r):
        n = n0 + t[0] * u + t[1] * v
        n = n / jnp.linalg.norm(n)
        e1 = JaxEllipsoid(center=c1, orientation=q1, radii=r)
        e2 = JaxEllipsoid(center=c2, orientation=q2, radii=r)
        return jnp.sum((jax_foot(-n, e2) - jax_foot(n, e1)) ** 2)

    lanes = [jnp.asarray(a) for a in (n0, u, v, c1, q1, c2, q2, radii)]
    ref = jax.vmap(lambda t, *p: jax_lbfgs(lambda tv: jax_obj(tv, *p), t, max_iters=8,
                                           memory=4))(jnp.zeros((B, 2)), *lanes)
    T = [torch.from_numpy(np.array(a)) for a in (n0, u, v, c1, q1, c2, q2, radii)]

    def torch_obj(t):
        n = T[0] + t[..., 0, None] * T[1] + t[..., 1, None] * T[2]
        n = n / torch.linalg.vector_norm(n, dim=-1, keepdim=True)
        e1 = TorchEllipsoid(center=T[3], orientation=T[4], radii=T[7])
        e2 = TorchEllipsoid(center=T[5], orientation=T[6], radii=T[7])
        return ((torch_foot(-n, e2) - torch_foot(n, e1)) ** 2).sum(-1)

    got = minimize_lbfgs(torch_obj, torch.zeros((B, 2), dtype=torch.float64), max_iters=8,
                         memory=4)
    np.testing.assert_array_equal(got.num_iters.numpy(), np.asarray(ref.num_iters))
    np.testing.assert_allclose(got.x.numpy(), np.asarray(ref.x), rtol=0, atol=1e-10)
    np.testing.assert_allclose(got.f.numpy(), np.asarray(ref.f), rtol=0, atol=1e-12)
