"""Space-filling-curve keys and lattice layouts.

Port of mundy_tpu/math/spacefill.py: the Morton and row-major cell keys
(`morton_key_3d`, `cell_linear_index`, torch, on the indices' device; ref:
the float-Morton comparators of `zmort.hpp:167-230`, replaced by integer
keys), hilbert_key_3d (the keys the native IO library's
`mundy_hilbert_keys` computes, io/trajectory.py) and
hilbert_positions_and_directors for chain initialisation (ref:
`mundy/math/src/mundy_math/Hilbert.hpp:90`, create_hilbert_positions_and_
directors), the last two plain numpy on the host.
"""

from __future__ import annotations

import numpy as np
import torch


def _part1by2(x: torch.Tensor) -> torch.Tensor:
    """Spread the low 10 bits of x so two zero bits sit between each (int64;
    torch has no uint32 shifts)."""
    x = x.to(torch.int64) & 0x3FF
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def morton_key_3d(ix: torch.Tensor, iy: torch.Tensor, iz: torch.Tensor) -> torch.Tensor:
    """Interleave three 10-bit cell indices into a 30-bit Morton key: the
    reference's uint32 value, as int64."""
    return _part1by2(ix) | (_part1by2(iy) << 1) | (_part1by2(iz) << 2)


def cell_linear_index(ix: torch.Tensor, iy: torch.Tensor, iz: torch.Tensor,
                      dims) -> torch.Tensor:
    """Plain row-major cell id ix + nx (iy + ny iz), int32: the cheapest key
    where locality does not matter."""
    nx, ny = dims[0], dims[1]
    return (ix + nx * (iy + ny * iz)).to(torch.int32)


def hilbert_key_3d(ix, iy, iz, bits: int = 10) -> np.ndarray:
    """uint32 3-D Hilbert index of integer cell coordinates (Skilling's
    transform, `bits` <= 10 per axis), axis 0 most significant."""
    if bits > 10:
        raise ValueError("hilbert_key_3d supports at most 10 bits per axis (uint32 keys)")
    x = np.stack([np.asarray(v).astype(np.uint32) for v in (ix, iy, iz)])  # (3, ...)
    # the inverse undo of Skilling's Hilbert transpose: coords -> transposed key
    q = np.uint32(1 << (bits - 1))
    for _ in range(bits - 1):
        p = np.uint32(q - 1)
        for i in range(3):
            cond = (x[i] & q) > 0
            if i == 0:
                x[0] = np.where(cond, x[0] ^ p, x[0])
            else:  # bit set: invert x[0]'s low bits; else exchange them with x[i]'s
                t = (x[0] ^ x[i]) & p
                x0 = np.where(cond, x[0] ^ p, x[0] ^ t)
                x[i] = np.where(cond, x[i], x[i] ^ t)
                x[0] = x0
        q = np.uint32(q >> 1)
    # Gray encode
    x[1] ^= x[0]
    x[2] ^= x[1]
    t = np.zeros_like(x[0])
    q = np.uint32(1 << (bits - 1))
    for _ in range(bits - 1):
        t = np.where((x[2] & q) > 0, t ^ np.uint32(q - 1), t)
        q = np.uint32(q >> 1)
    x ^= t[None]
    # interleave the transposed bits into one key
    key = np.zeros_like(x[0])
    for b in range(bits - 1, -1, -1):
        for i in range(3):
            key = (key << np.uint32(1)) | ((x[i] >> np.uint32(b)) & np.uint32(1))
    return key


def hilbert_positions_and_directors(num_points: int, orientation=(1.0, 0.0, 0.0),
                                    side_length: float = 1.0):
    """Hilbert-curve lattice positions and unit directors.

    Consecutive points are lattice neighbours, so chains laid out along the
    curve are spatially local. Returns `(positions, directors)` with
    `len(positions) = s^3 >= num_points` (s a power of two) and
    `len(directors) = s^3 - 1`."""
    if num_points <= 0:
        raise ValueError("num_points must be > 0")
    s = 2
    while s * s * s < num_points:
        s *= 2

    orientation = np.asarray(orientation, dtype=np.float64)
    zhat = np.array([0.0, 0.0, 1.0])
    d1 = orientation / np.linalg.norm(orientation)
    d2 = np.cross(zhat, d1)
    if np.linalg.norm(d2) < 1e-12:  # orientation parallel to z: pick x
        d2 = np.cross(np.array([1.0, 0.0, 0.0]), d1)
    d2 /= np.linalg.norm(d2)
    d3 = np.cross(d1, d2)
    d3 /= np.linalg.norm(d3)

    positions = np.zeros((s * s * s, 3))
    idx = [0]

    def rec(side, pos, dr1, dr2, dr3):
        if side == 1:
            positions[idx[0]] = pos
            idx[0] += 1
            return
        h = side // 2
        pos = pos.copy()
        for dr in (dr1, dr2, dr3):
            stencil = (dr < 0.0).astype(np.float64)
            pos -= h * stencil * dr
        rec(h, pos, dr2, dr3, dr1)
        rec(h, pos + h * dr1, dr3, dr1, dr2)
        rec(h, pos + h * (dr1 + dr2), dr3, dr1, dr2)
        rec(h, pos + h * dr2, -dr1, -dr2, dr3)
        rec(h, pos + h * (dr2 + dr3), -dr1, -dr2, dr3)
        rec(h, pos + h * (dr1 + dr2 + dr3), -dr3, dr1, -dr2)
        rec(h, pos + h * (dr1 + dr3), -dr3, dr1, -dr2)
        rec(h, pos + h * dr3, dr2, -dr3, -dr1)

    rec(s, np.zeros(3), side_length * d1, side_length * d2, side_length * d3)

    directors = positions[1:] - positions[:-1]
    directors /= np.linalg.norm(directors, axis=1, keepdims=True)
    return positions, directors
