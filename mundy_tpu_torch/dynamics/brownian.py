"""Brownian velocity from counter-based RNG, bit-compatible with the reference.

Port of mundy_tpu/dynamics/brownian.py::brownian_velocity_keyed (ref:
ComputeBrownianVelocity SpheresKernel, `SpheresKernel.cpp:119-123`:
v += sqrt(2 D / dt) * randn() per component). The stream is JAX's: the step
is folded into the key with threefry2x32, then one threefry2x32 call hashes
the per-entity counter planes (gid, gid, 0, 1). The words match the
reference bit for bit; the normals come from Giles' single-precision erf_inv
polynomial, the one XLA evaluates, and agree to <= 2 ulp (`torch.erfinv`
differs by up to 64 ulp).

PyTorch has no uint32 add or shifts on every backend, so the 32-bit words
live in int64 tensors (or python ints) and every sum is masked to 32 bits.
"""

from __future__ import annotations

import math

import torch

_SQRT2 = math.sqrt(2.0)
_MASK = 0xFFFFFFFF
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

    key: two uint32 words as python ints; x0, x1: python ints or int64
    tensors holding uint32 values (broadcastable). Returns the two output
    words in the same representation."""
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


def fold_in(key, data: int):
    """jax.random.fold_in for a raw threefry key: hash of the seed words
    (0, uint32(data)) under `key`. Returns two uint32 words as python ints."""
    return threefry_2x32(key, 0, int(data) & _MASK)


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
