"""Counter-based Brownian noise of the torch port vs the JAX reference.

The threefry words and the folded keys must match bit for bit. The normals
go through Giles' float32 erf_inv polynomial, the one XLA evaluates, which
must lie within 2 ulp of jax.lax.erf_inv on the same draws; `torch.erfinv`
would not (checked below, so the reason for the polynomial stays on
record). The velocities carry that bound through their two products.

The positional draws of the (N, K) rods engine (brownian_velocity,
brownian_angular_velocity: jax.random.normal's stream) take their uniforms
bit for bit from the same words; the normals are within 4 ulp in float32
and 64 ulp in float64 (Giles' float64 polynomial as XLA evaluates it, but
XLA's log1p and its fused products round differently: 30 ulp measured).
"""

import jax
import jax.extend as jex
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mundy_tpu.dynamics import brownian as jb
from mundy_tpu.dynamics.brownian import brownian_velocity_keyed as jax_brownian
from mundy_tpu_torch.dynamics import brownian as tb

torch.set_num_threads(1)


def _ulp_diff(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Distance in float32 units in the last place (same-sign values)."""
    ia = a.view(np.int32).astype(np.int64)
    ib = b.view(np.int32).astype(np.int64)
    return np.abs(ia - ib)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_threefry_words_bit_equal(seed):
    rng = np.random.default_rng(seed)
    key = tuple(int(k) for k in rng.integers(0, 2**32, 2, dtype=np.uint64))
    count = rng.integers(0, 2**32, 2 * 777, dtype=np.uint64).astype(np.uint32)
    ref = np.asarray(jex.random.threefry_2x32(
        (jnp.uint32(key[0]), jnp.uint32(key[1])), jnp.asarray(count)))
    c = torch.from_numpy(count.astype(np.int64))
    y0, y1 = tb.threefry_2x32(key, c[:777], c[777:])
    got = torch.cat([y0, y1]).numpy().astype(np.uint32)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("data", [0, 1, 59, 2**31 - 1, 2**31 + 5])
def test_fold_in_bit_equal(data):
    for seed in (0, 1234, 2**32 - 1):
        key = jax.random.PRNGKey(seed)
        ref = np.asarray(jax.random.key_data(
            jax.random.fold_in(key, jnp.uint32(data))))
        kd = tuple(int(w) for w in np.asarray(jax.random.key_data(key)))
        assert tb.fold_in(kd, data) == tuple(int(w) for w in ref)


def _assert_within_erf_inv_bound(got, ref, scale):
    """v = scale * (f32(sqrt 2) * erf_inv(x)): a 2-ulp erf_inv difference,
    carried through the two products, each of which rounds once more."""
    e = np.abs(ref / (scale * np.sqrt(2.0))).astype(np.float32)
    z = np.abs(ref / scale).astype(np.float32)
    bound = (scale * np.sqrt(2.0) * 2 * np.spacing(e).astype(np.float64)
             + scale * np.spacing(z).astype(np.float64)
             + np.spacing(np.abs(ref).astype(got.dtype)))
    assert np.all(np.abs(got.astype(np.float64) - ref) <= bound)


@pytest.mark.parametrize("shape", [(5000,), (8, 8, 56)])
@pytest.mark.parametrize("step", [0, 7, 1000])
def test_brownian_velocity_keyed_matches(shape, step):
    """D = dt / 2 makes the scale exactly 1: the velocities are the normals."""
    rng = np.random.default_rng(step)
    gid = rng.permutation(10 * int(np.prod(shape)))[:int(np.prod(shape))]
    gid = gid.reshape(shape).astype(np.int32)
    key = jax.random.PRNGKey(42)
    ref = np.asarray(jax_brownian(key, jnp.int32(step), jnp.asarray(gid),
                                  jnp.float32(0.5), 1.0, dtype=jnp.float32))
    got = tb.brownian_velocity_keyed((0, 42), step, torch.from_numpy(gid),
                                     0.5, 1.0).numpy()
    assert got.shape == ref.shape == shape + (3,)
    assert (got == ref).mean() > 0.9
    _assert_within_erf_inv_bound(got, ref, 1.0)


def test_brownian_velocity_scaled_and_f64():
    """At a real scale sqrt(2 D / dt), and for float64 configs, which cast the
    float32 normals."""
    rng = np.random.default_rng(5)
    gid = rng.permutation(20000)[:6000].astype(np.int32)
    key = jax.random.PRNGKey(7)
    for dtype_j, dtype_t in ((jnp.float32, torch.float32),
                             (jnp.float64, torch.float64)):
        ref = np.asarray(jax_brownian(key, jnp.int32(3), jnp.asarray(gid),
                                      jnp.asarray(0.1, dtype_j), 1e-4,
                                      dtype=dtype_j))
        got = tb.brownian_velocity_keyed((0, 7), 3, torch.from_numpy(gid),
                                         0.1, 1e-4, dtype=dtype_t).numpy()
        assert got.dtype == ref.dtype
        _assert_within_erf_inv_bound(got, ref, np.sqrt(2 * 0.1 / 1e-4))


def test_torch_erfinv_misses_the_bound():
    """Why the port carries its own polynomial: torch.erfinv differs from
    jax.lax.erf_inv by far more than 2 ulp on the same uniform draws."""
    rng = np.random.default_rng(0)
    w = rng.integers(0, 2**32, 200_000, dtype=np.uint64).astype(np.uint32)
    u = (w >> 9).astype(np.float32) * np.float32(2.0 ** -23) + np.float32(2.0 ** -24)
    x = (np.float32(2.0) * u - np.float32(1.0)).astype(np.float32)
    ref = np.asarray(jax.lax.erf_inv(jnp.asarray(x)))
    xt = torch.from_numpy(x)
    assert _ulp_diff(torch.erfinv(xt).numpy(), ref).max() > 2
    assert _ulp_diff(tb._erf_inv_f32(xt).numpy(), ref).max() <= 2


_DT = ((jnp.float32, torch.float32, 4), (jnp.float64, torch.float64, 64))


def _ulps(got, ref):
    return np.abs(got - ref) / np.spacing(np.abs(ref).astype(ref.dtype))


@pytest.mark.parametrize("seed", [0, 1234])
@pytest.mark.parametrize("dtypes", _DT, ids=["float32", "float64"])
def test_jax_normal_stream(dtypes, seed):
    """The words of the flat index (32 or 64 bits wide) are
    jax.random.bits' bit for bit; uniform_pm1 is jax.random.uniform(key,
    (n, 3), dtype, nextafter(-1, 0), 1) bit for bit; normal is
    jax.random.normal within the stated ulps."""
    jdt, tdt, ulp = dtypes
    key = jax.random.fold_in(jax.random.PRNGKey(seed), 11)
    kd = tuple(int(w) for w in np.asarray(jax.random.key_data(key)))
    # the words: threefry2x32 of the counters (0, flat index)
    i = torch.arange(3 * 20000, dtype=torch.int64)
    y0, y1 = (w.numpy().astype(np.uint64) for w in tb.threefry_2x32(kd, 0 * i, i))
    wide = jdt == jnp.float64
    words = (y0 << np.uint64(32)) | y1 if wide else (y0 ^ y1).astype(np.uint32)
    ref_w = np.asarray(jax.random.bits(key, (20000, 3), jnp.uint64 if wide else jnp.uint32))
    np.testing.assert_array_equal(words.reshape(20000, 3), ref_w)
    lo = np.nextafter(np.array(-1.0, jdt), np.array(0.0, jdt))
    ref_u = np.asarray(jax.random.uniform(key, (20000, 3), jdt, lo, 1.0))
    np.testing.assert_array_equal(tb.uniform_pm1(kd, 20000, tdt).numpy(), ref_u)
    ref_z = np.asarray(jax.random.normal(key, (20000, 3), jdt))
    got_z = tb.normal(kd, 20000, tdt).numpy()
    assert got_z.dtype == ref_z.dtype
    assert _ulps(got_z, ref_z).max() <= ulp


@pytest.mark.parametrize("step", [0, 9])
@pytest.mark.parametrize("dtypes", _DT, ids=["float32", "float64"])
def test_brownian_velocity_and_angular(dtypes, step):
    """The rods engine's two streams, fold_in(key, step) and its fold_in
    with 0x5EED, at the rods YAML's D = D_rot = 0.05, dt = 1e-4; one more
    rounding for the scale."""
    jdt, tdt, ulp = dtypes
    key = jax.random.split(jax.random.PRNGKey(1234), 3)[2]
    kd = tuple(int(w) for w in np.asarray(jax.random.key_data(key)))
    for jfn, tfn in ((jb.brownian_velocity, tb.brownian_velocity),
                     (jb.brownian_angular_velocity, tb.brownian_angular_velocity)):
        ref = np.asarray(jfn(key, step, 5000, jnp.asarray(0.05, jdt), 1e-4, dtype=jdt))
        got = tfn(kd, step, 5000, 0.05, 1e-4, dtype=tdt).numpy()
        assert got.shape == ref.shape == (5000, 3)
        assert _ulps(got, ref).max() <= ulp + 1
