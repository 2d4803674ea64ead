"""BASELINE config #1: spheres in a periodic box — Hertzian contact,
overdamped (Stokes drag) dynamics, optional Brownian motion, explicit Euler.

Port of the config schema of mundy_tpu/driver/apps/spheres.py. The row-grid
engine that runs it is driver/apps/spheres_rows.py; the flat cell-list
`SpheresSim` comes with a later slice.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class SpheresConfig:
    """Validated config (ref: the ParameterList sublists of the drivers)."""

    num_spheres: int = 10_000
    box_size: float = 40.0  # cubic periodic box edge
    radius: float = 0.5
    # relative half-width of a uniform radius distribution: r_i = radius *
    # (1 + U(-p, p)); 0 keeps every engine on the uniform fast paths
    polydispersity: float = 0.0
    youngs_modulus: float = 1000.0
    poissons_ratio: float = 0.3
    viscosity: float = 1.0
    diffusion_coeff: float = 0.0  # 0 disables Brownian motion
    dt: float = 1e-4
    num_steps: int = 1000
    skin: float = 0.25  # neighbor-list margin (distance units)
    max_neighbors: int = 48
    cell_capacity: int = 24
    chunk: int = 8192
    seed: int = 1234
    dtype: str = "float32"
    log_every: int = 100

    def __validate__(self):
        assert self.num_spheres > 0, "num_spheres must be positive"
        assert self.box_size > 4 * (self.radius + self.skin), "box too small"
        assert self.dt > 0 and self.num_steps >= 0
        assert 0.0 <= self.polydispersity < 1.0


def polydisperse_radii(config) -> np.ndarray:
    """(num_spheres,) float64 radii of a polydisperse sphere config (this
    one or LCPSpheresConfig), drawn as the reference draws them for every
    engine: numpy's default_rng(seed + 777), radius (1 + p U(-1, 1))."""
    rng = np.random.default_rng(config.seed + 777)
    return config.radius * (1.0 + config.polydispersity
                            * rng.uniform(-1.0, 1.0, config.num_spheres))
