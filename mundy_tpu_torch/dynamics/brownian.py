"""Brownian velocity from counter-based RNG, bit-compatible with the reference.

Port of mundy_tpu/dynamics/brownian.py (ref: ComputeBrownianVelocity
SpheresKernel, `SpheresKernel.cpp:119-123`: v += sqrt(2 D / dt) * randn()
per component). The stream is JAX's: the step is folded into the key with
threefry2x32, then one threefry2x32 call hashes the counters.
`brownian_velocity_keyed` hashes the per-entity counter planes (gid, gid,
0, 1). `brownian_velocity` and `brownian_angular_velocity` draw as
`jax.random.normal((n, 3))` does with partitionable threefry: the words of
the flat index i are y0 ^ y1 of threefry2x32 over the counters (0, i) in
float32, and (y0 << 32) | y1 in float64. The words match the reference bit
for bit; the normals come from Giles' erf_inv polynomials, the ones XLA
evaluates (`torch.erfinv` differs by up to 64 ulp in float32), and agree to
a few ulp.

PyTorch has no uint32 add or shifts on every backend, so the 32-bit words
live in int64 tensors (or python ints) and every sum is masked to 32 bits.
"""

from __future__ import annotations

import math

import numpy as np
import torch

_SQRT2 = math.sqrt(2.0)
_MASK = 0xFFFFFFFF
_NP = {torch.float32: np.float32, torch.float64: np.float64}
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))

# Giles, "Approximating the erfinv function" (GPU Computing Gems, 2011):
# single-precision branches in w - 2.5 (w < 5) and sqrt(w) - 3 (w >= 5),
# w = -log(1 - x^2), highest-degree coefficient first.
_ERFINV_W_LT_5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                  -4.39150654e-06, 0.00021858087, -0.00125372503,
                  -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_W_GE_5 = (-0.000200214257, 0.000100950558, 0.00134934322,
                  -0.00367342844, 0.00573950773, -0.0076224613,
                  0.00943887047, 1.00167406, 2.83297682)


def _rotl(v, r: int):
    return ((v << r) | (v >> (32 - r))) & _MASK


def threefry_2x32(key, x0, x1):
    """Threefry-2x32 (20 rounds) of the counter words (x0, x1) under `key`.

    key: two uint32 words, as python ints or int64 tensors (one key per
    element, broadcastable against the counters); x0, x1: python ints or
    int64 tensors holding uint32 values (broadcastable). Returns the two
    output words, tensors where any input is one."""
    k0, k1 = key
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _MASK
    return x0, x1


def fold_in(key, data):
    """jax.random.fold_in for a raw threefry key: hash of the seed words
    (0, uint32(data)) under `key`. With python ints it returns two python
    ints; with an integer tensor of data (or tensor key words) one key per
    element, as `vmap(fold_in)` gives them, in one vectorised hash."""
    if isinstance(data, torch.Tensor):
        data = data.to(torch.int64) & _MASK
    else:
        data = int(data) & _MASK
    return threefry_2x32(key, 0, data)


def _erf_inv_f32(x: torch.Tensor) -> torch.Tensor:
    """Giles' single-precision erf_inv for |x| < 1 (float32 in and out)."""
    w = -torch.log1p(-x * x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)
    p_lt = torch.full_like(w, _ERFINV_W_LT_5[0])
    p_ge = torch.full_like(w, _ERFINV_W_GE_5[0])
    for c_lt, c_ge in zip(_ERFINV_W_LT_5[1:], _ERFINV_W_GE_5[1:]):
        p_lt = c_lt + p_lt * w
        p_ge = c_ge + p_ge * w
    return torch.where(lt, p_lt, p_ge) * x


# XLA's float64 erf_inv (Giles): branches in w - 3.125 (w < 6.25),
# sqrt(w) - 3.25 (w < 16) and sqrt(w) - 5, highest degree first; the two
# shorter polynomials align with the longest at the highest degree
_ERFINV64_W_LT_6_25 = (
    -3.6444120640178196996e-21, -1.685059138182016589e-19, 1.2858480715256400167e-18,
    1.115787767802518096e-17, -1.333171662854620906e-16, 2.0972767875968561637e-17,
    6.6376381343583238325e-15, -4.0545662729752068639e-14, -8.1519341976054721522e-14,
    2.6335093153082322977e-12, -1.2975133253453532498e-11, -5.4154120542946279317e-11,
    1.051212273321532285e-09, -4.1126339803469836976e-09, -2.9070369957882005086e-08,
    4.2347877827932403518e-07, -1.3654692000834678645e-06, -1.3882523362786468719e-05,
    0.0001867342080340571352, -0.00074070253416626697512, -0.0060336708714301490533,
    0.24015818242558961693, 1.6536545626831027356)
_ERFINV64_W_LT_16 = (
    2.2137376921775787049e-09, 9.0756561938885390979e-08, -2.7517406297064545428e-07,
    1.8239629214389227755e-08, 1.5027403968909827627e-06, -4.013867526981545969e-06,
    2.9234449089955446044e-06, 1.2475304481671778723e-05, -4.7318229009055733981e-05,
    6.8284851459573175448e-05, 2.4031110387097893999e-05, -0.0003550375203628474796,
    0.00095328937973738049703, -0.0016882755560235047313, 0.0024914420961078508066,
    -0.0037512085075692412107, 0.005370914553590063617, 1.0052589676941592334,
    3.0838856104922207635)
_ERFINV64_W_GE_16 = (
    -2.7109920616438573243e-11, -2.5556418169965252055e-10, 1.5076572693500548083e-09,
    -3.7894654401267369937e-09, 7.6157012080783393804e-09, -1.4960026627149240478e-08,
    2.9147953450901080826e-08, -6.7711997758452339498e-08, 2.2900482228026654717e-07,
    -9.9298272942317002539e-07, 4.5260625972231537039e-06, -1.9681778105531670567e-05,
    7.5995277030017761139e-05, -0.00021503011930044477347, -0.00013871931833623122026,
    1.0103004648645343977, 4.8499064014085844221)


def _erf_inv_f64(x: torch.Tensor) -> torch.Tensor:
    """XLA's float64 erf_inv for |x| < 1 (float64 in and out)."""
    w = -torch.log1p(-x * x)
    lt6 = w < 6.25
    lt16 = w < 16.0
    w = torch.where(lt6, w - 3.125, torch.sqrt(w) - torch.where(lt16, 3.25, 5.0))

    def coef(i):
        c = torch.full_like(x, _ERFINV64_W_LT_6_25[i])
        if i < 19:
            c = torch.where(lt6, c, _ERFINV64_W_LT_16[i])
        if i < 17:
            c = torch.where(lt16, c, _ERFINV64_W_GE_16[i])
        return c

    p = coef(0)
    for i in range(1, 17):
        p = coef(i) + p * w
    for i in range(17, 19):
        p = torch.where(lt16, coef(i) + p * w, p)
    for i in range(19, 23):
        p = torch.where(lt6, coef(i) + p * w, p)
    return p * x


def uniform_pm1(key, n: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """(n, 3) draws of jax.random.uniform(key, (n, 3), dtype, nextafter(-1,
    0), 1): the words of the flat index (see the module docstring), their
    mantissa bits over [1, 2) minus 1, scaled onto [nextafter(-1, 0), 1) and
    floored there."""
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"the JAX stream draws float32 or float64, not {dtype}")
    i = torch.arange(3 * n, dtype=torch.int64, device=device)
    y0, y1 = threefry_2x32(key, torch.zeros_like(i), i)
    return _pm1_of_words(y0, y1, dtype).reshape(n, 3)


def _pm1_of_words(y0, y1, dtype) -> torch.Tensor:
    """uniform_pm1's map of the threefry words of each element."""
    if dtype == torch.float32:
        bits = ((y0 ^ y1) >> 9) | 0x3F800000
        floats = bits.to(torch.int32).view(torch.float32) - 1.0
    else:
        # the top 52 bits of the 64-bit word (y0 << 32) | y1
        bits = (y0 << 20) | (y1 >> 12) | 0x3FF0000000000000
        floats = bits.view(torch.float64) - 1.0
    lo = torch.tensor(np.nextafter(-1.0, 0.0, dtype=_NP[dtype]), dtype=dtype,
                      device=floats.device)
    return torch.maximum(lo, floats * (1.0 - lo) + lo)


def normal(key, n: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """(n, 3) standard normals as jax.random.normal(key, (n, 3), dtype)
    draws them: sqrt(2) erf_inv of uniform_pm1."""
    erf_inv = _erf_inv_f32 if dtype == torch.float32 else _erf_inv_f64
    return _SQRT2 * erf_inv(uniform_pm1(key, n, dtype, device))


def normal_per_key(keys, dtype=torch.float32) -> torch.Tensor:
    """(G, 3) standard normals, row g as jax.random.normal(k_g, (3,), dtype)
    draws them from the g-th key: `keys` holds the two words of G keys as
    (G,) int64 tensors (fold_in of a tensor of data gives them), so G draws
    cost one vectorised hash."""
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"the JAX stream draws float32 or float64, not {dtype}")
    k0, k1 = (k[:, None] for k in keys)
    i = torch.arange(3, dtype=torch.int64, device=k0.device)[None, :]
    y0, y1 = threefry_2x32((k0, k1), torch.zeros_like(i), i)
    erf_inv = _erf_inv_f32 if dtype == torch.float32 else _erf_inv_f64
    return _SQRT2 * erf_inv(_pm1_of_words(y0, y1, dtype))


def _scaled(z: torch.Tensor, diffusion, dt) -> torch.Tensor:
    scale = torch.sqrt(2.0 * torch.as_tensor(diffusion, dtype=z.dtype, device=z.device) / dt)
    return (scale[:, None] if scale.ndim else scale) * z


def brownian_velocity(key, step: int, n: int, diffusion, dt, dtype=torch.float32,
                      device=None) -> torch.Tensor:
    """(n, 3) Brownian velocities sqrt(2 D / dt) N(0, 1): the normals of
    fold_in(key, step), in positions 0..n-1 (the reference's
    brownian_velocity). `diffusion` is a scalar or (n,)."""
    return _scaled(normal(fold_in(key, step), n, dtype, device), diffusion, dt)


def brownian_angular_velocity(key, step: int, n: int, rot_diffusion, dt,
                              dtype=torch.float32, device=None) -> torch.Tensor:
    """(n, 3) rotational Brownian angular velocities, from the stream
    fold_in(fold_in(key, step), 0x5EED)."""
    k = fold_in(fold_in(key, step), 0x5EED)
    return _scaled(normal(k, n, dtype, device), rot_diffusion, dt)


def brownian_velocity_keyed(key, step: int, gid: torch.Tensor, diffusion,
                            dt, dtype=torch.float32) -> torch.Tensor:
    """(..., 3) Brownian velocities keyed by per-entity global id.

    key: the run's two uint32 key words (python ints); step: python int;
    gid: integer tensor of any shape; diffusion: python scalar, 0-d tensor
    or a tensor shaped like gid (a per-entity coefficient).
    Entity e draws the threefry blocks A = (gid, 0) and B = (gid, 1) and uses
    words A0, A1, B0, so the stream depends only on (key, step, gid), never
    on where the entity sits in a permuted layout. Normals come from the
    23-bit inverse-CDF map with a half-ulp center offset, in float32, then
    cast to `dtype`, as in the reference."""
    kd = fold_in(key, step)
    g = gid.reshape(-1).to(torch.int64)
    x1 = torch.arange(2, dtype=torch.int64, device=g.device)[:, None]
    y0, y1 = threefry_2x32(kd, g.expand(2, -1), x1)
    w = torch.stack([y0[0], y1[0], y0[1]], dim=-1)
    u = (w >> 9).to(torch.float32) * 2.0 ** -23 + 2.0 ** -24
    z = _SQRT2 * _erf_inv_f32(2.0 * u - 1.0)
    z = z.reshape(gid.shape + (3,)).to(dtype)
    # a python diffusion gives a 0-d host tensor: no copy to the device
    scale = torch.sqrt(2.0 * torch.as_tensor(diffusion, dtype=dtype) / dt)
    if scale.ndim:
        scale = scale[..., None]
    return scale * z
