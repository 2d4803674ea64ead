"""Hilbert-curve lattice layouts for chain initialisation (host numpy).

Port of mundy_tpu/math/spacefill.py::hilbert_positions_and_directors (ref:
`mundy/math/src/mundy_math/Hilbert.hpp:90`, create_hilbert_positions_and_
directors). Plain numpy, run once at init; the port keeps its own copy.
"""

from __future__ import annotations

import numpy as np


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
