"""Plain pieces shared by the references: the keyed noise stream, periodic
geometry and an all-pairs search by cells.

Written from the definitions, in plain PyTorch, for the benchmark alone: it
imports nothing of the program under test. The noise stream is the one the
configurations state: JAX's threefry2x32 (20 rounds, key injection every 4),
the step folded into the run's key, each body's normals hashed from its id,
mapped to float32 normals by Giles' single-precision erf_inv.
"""

from __future__ import annotations

import math

import torch

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
# Giles, "Approximating the erfinv function" (GPU Computing Gems, 2011),
# single precision: w = -log(1 - x^2), branch w < 5 in w - 2.5, else in
# sqrt(w) - 3; highest degree first
_GILES_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
              0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_GILES_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
              0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32, 20 rounds, of counter words (x0, x1) under key (k0,
    k1). Words are python ints or int64 tensors holding uint32 values."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & MASK
    x1 = (x1 + ks[1]) & MASK
    for block in range(5):
        for r in _ROTATIONS[block % 2]:
            x0 = (x0 + x1) & MASK
            x1 = (((x1 << r) | (x1 >> (32 - r))) & MASK) ^ x0
        x0 = (x0 + ks[(block + 1) % 3]) & MASK
        x1 = (x1 + ks[(block + 2) % 3] + block + 1) & MASK
    return x0, x1


def step_key(key_words, step: int):
    """The run's key with the step folded in: threefry of (0, step)."""
    return threefry2x32(int(key_words[0]), int(key_words[1]), 0, int(step) & MASK)


def _giles_erfinv_f32(x: torch.Tensor) -> torch.Tensor:
    w = -torch.log1p(-x * x)
    low = w < 5.0
    w = torch.where(low, w - 2.5, torch.sqrt(w) - 3.0)
    p_lo = torch.full_like(w, _GILES_LT5[0])
    p_hi = torch.full_like(w, _GILES_GE5[0])
    for a, b in zip(_GILES_LT5[1:], _GILES_GE5[1:]):
        p_lo = a + p_lo * w
        p_hi = b + p_hi * w
    return torch.where(low, p_lo, p_hi) * x


def keyed_normals(key_words, step: int, ids: torch.Tensor) -> torch.Tensor:
    """(n, 3) float32 standard normals of bodies `ids` at `step`: body g
    takes the words (A0, A1, B0) of the blocks A = (g, 0) and B = (g, 1),
    each word's top 23 bits u = (w >> 9) 2^-23 + 2^-24, z = sqrt(2)
    erfinv(2u - 1)."""
    k0, k1 = step_key(key_words, step)
    g = ids.to(torch.int64)
    a0, a1 = threefry2x32(k0, k1, g, torch.zeros_like(g))
    b0, _ = threefry2x32(k0, k1, g, torch.ones_like(g))
    words = torch.stack([a0, a1, b0], dim=-1)
    u = (words >> 9).to(torch.float32) * 2.0 ** -23 + 2.0 ** -24
    return math.sqrt(2.0) * _giles_erfinv_f32(2.0 * u - 1.0)


def brownian(key_words, step: int, n: int, diffusion: float, dt: float,
             dtype, device) -> torch.Tensor:
    """(n, 3) Brownian velocities sqrt(2 D / dt) z of bodies 0..n-1, the
    float32 normals cast to `dtype`."""
    z = keyed_normals(key_words, step, torch.arange(n, device=device)).to(dtype)
    return math.sqrt(2.0 * diffusion / dt) * z


def min_image(d: torch.Tensor, box: float) -> torch.Tensor:
    return d - box * torch.round(d / box)


def wrap(p: torch.Tensor, box: float) -> torch.Tensor:
    return p - box * torch.floor(p / box)


def max_gap(a: torch.Tensor, b: torch.Tensor, box: float) -> float:
    """Largest distance, minimum image, between matching rows of two (n, 3)
    position sets, in float64."""
    d = min_image(a.to(torch.float64) - b.to(torch.float64), box)
    return float(torch.linalg.vector_norm(d, dim=-1).max())


def pairs_within(pos: torch.Tensor, box: float, cut: float,
                 chunk: int = 1 << 20) -> tuple:
    """Unordered pairs (i, j), i < j, of bodies closer than `cut` (minimum
    image) in a cubic periodic box: bodies binned into cells of edge >= cut
    (at least 3 a side), each body against the bodies of its 27 cells."""
    n = pos.shape[0]
    dev = pos.device
    nc = int(box // cut)
    if nc < 3:
        raise ValueError(f"box {box} holds fewer than 3 cells of {cut}")
    p = wrap(pos, box)
    c = torch.clamp((p * (nc / box)).to(torch.int64), 0, nc - 1)
    cid = (c[:, 0] * nc + c[:, 1]) * nc + c[:, 2]
    order = torch.argsort(cid)
    counts = torch.bincount(cid, minlength=nc ** 3)
    starts = torch.cumsum(counts, 0) - counts
    occ = int(counts.max())
    lanes = torch.arange(occ, device=dev)
    offs = [(a, b, e) for a in (-1, 0, 1) for b in (-1, 0, 1) for e in (-1, 0, 1)]
    out_i, out_j = [], []
    cut2 = cut * cut
    for lo in range(0, n, chunk):
        i = torch.arange(lo, min(n, lo + chunk), device=dev)
        ci = c[i]
        for a, b, e in offs:
            cn = (ci + torch.tensor([a, b, e], device=dev)) % nc
            nid = (cn[:, 0] * nc + cn[:, 1]) * nc + cn[:, 2]
            slot = starts[nid][:, None] + lanes
            ok = lanes < counts[nid][:, None]
            j = order[torch.clamp(slot, max=n - 1)]
            ok &= j > i[:, None]
            d = min_image(pos[j] - pos[i][:, None], box)
            ok &= (d * d).sum(-1) < cut2
            ii, kk = torch.nonzero(ok, as_tuple=True)
            out_i.append(i[ii])
            out_j.append(j[ii, kk])
    return torch.cat(out_i), torch.cat(out_j)
