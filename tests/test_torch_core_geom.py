"""Core, geometry and contact-law modules of the torch port vs the JAX
reference: config parsing, periodic metrics and the Hertzian scalar law.
Float64 throughout: the orthorhombic maps agree bit for bit, the contact
law to a few ulp, and the triclinic maps to 1e-12 (a matrix product may
sum in another order)."""

import dataclasses
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mundy_tpu.core.config import config_from_dict as jax_config_from_dict
from mundy_tpu.driver.apps.spheres import SpheresConfig as JaxConfig
from mundy_tpu.forces import contact as jc
from mundy_tpu.geom import periodicity as jp
from mundy_tpu_torch.core.config import (ConfigError, config_from_dict,
                                         config_to_dict, load_yaml)
from mundy_tpu_torch.core.containers import frozen_dataclass
from mundy_tpu_torch.core.errors import MundyError, require
from mundy_tpu_torch.driver.apps.spheres import SpheresConfig
from mundy_tpu_torch.forces import contact as tc
from mundy_tpu_torch.geom import periodicity as tp

torch.set_num_threads(1)


def test_spheres_yaml_parses_like_the_reference():
    root = pathlib.Path(__file__).resolve().parents[1]
    params = load_yaml(str(root / "examples" / "spheres_10k.yaml"))["params"]
    got = config_from_dict(SpheresConfig, params)
    ref = jax_config_from_dict(JaxConfig, params)
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    assert config_to_dict(got) == dataclasses.asdict(ref)


@pytest.mark.parametrize("bad", [{"num_spheres": 10, "bogus": 1},
                                 {"num_spheres": 0},
                                 {"box_size": 1.0}])
def test_config_errors(bad):
    with pytest.raises(ConfigError):
        config_from_dict(SpheresConfig, bad)


def test_containers_and_require():
    @frozen_dataclass
    class Pair:
        a: int
        b: int = 2

    p = Pair(a=1)
    q = p.replace(b=5)
    assert (p.b, q.a, q.b) == (2, 1, 5)
    with pytest.raises(dataclasses.FrozenInstanceError):
        p.a = 3
    require(torch.ones(3, dtype=torch.bool))
    with pytest.raises(MundyError, match="negative"):
        require(torch.tensor([1.0, -1.0]) > 0, "negative entry")


def _metrics(kind):
    if kind == "periodic":
        return (jp.periodic(np.array([7.0, 9.0, 11.0]), dtype=jnp.float64),
                tp.periodic([7.0, 9.0, 11.0], dtype=torch.float64))
    if kind == "partial":
        return (jp.periodic(np.array([7.0, 9.0, 11.0]), (True, False, True),
                            dtype=jnp.float64),
                tp.periodic([7.0, 9.0, 11.0], (True, False, True),
                            dtype=torch.float64))
    if kind == "free":
        return jp.free_space(jnp.float64), tp.free_space(torch.float64)
    cell = np.array([[8.0, 1.5, 0.5], [0.0, 9.0, -1.0], [0.0, 0.0, 10.0]])
    return jp.triclinic(jnp.asarray(cell)), tp.triclinic(torch.as_tensor(cell))


@pytest.mark.parametrize("kind", ["periodic", "partial", "free", "triclinic"])
def test_metric_sep_wrap_match(kind):
    jm, tm = _metrics(kind)
    rng = np.random.default_rng(2)
    p1 = rng.uniform(-15, 25, (500, 3))
    p2 = rng.uniform(-15, 25, (500, 3))
    t1, t2 = torch.as_tensor(p1), torch.as_tensor(p2)
    pairs = [(tm.sep(t1, t2), jm.sep(jnp.asarray(p1), jnp.asarray(p2))),
             (tm.wrap(t1), jm.wrap(jnp.asarray(p1))),
             (tm.distance(t1, t2), jm.distance(jnp.asarray(p1), jnp.asarray(p2)))]
    for got, ref in pairs:
        if kind == "triclinic":
            np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                                       atol=1e-12)
        else:
            np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_round_half_even_minimum_image():
    """Exact half-box separations round to even in both frameworks."""
    jm, tm = _metrics("periodic")
    p2 = np.array([[3.5, 4.5, 5.5], [10.5, 13.5, 16.5]])
    got = tm.sep(torch.zeros(2, 3, dtype=torch.float64), torch.as_tensor(p2))
    ref = jm.sep(jnp.zeros((2, 3)), jnp.asarray(p2))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_contact_law_matches():
    rng = np.random.default_rng(3)
    sep = rng.uniform(-0.6, 0.4, 1000)
    ref = jc.hertzian_pair_force(jnp.asarray(sep), jnp.float64(0.25),
                                 jnp.float64(549.45))
    got = tc.hertzian_pair_force(torch.as_tensor(sep),
                                 torch.tensor(0.25, dtype=torch.float64),
                                 torch.tensor(549.45, dtype=torch.float64))
    # the same operation order, but XLA's CPU code generation may contract
    # a product: agreement to a few ulp, not bit for bit
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-15, atol=0)
    assert tc.effective_youngs(1000.0, 800.0, 0.3, 0.25) == \
        float(jc.effective_youngs(1000.0, 800.0, 0.3, 0.25))
    assert tc.effective_radius(0.5, 0.7) == float(jc.effective_radius(0.5, 0.7))
