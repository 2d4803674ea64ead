"""BASELINE config #3: spherocylinder (rod) suspension: segment-segment
narrow phase, Hertzian contact with torques, Brownian motion, rigid-body
Euler/quaternion update.

Port of the config schema of mundy_tpu/driver/apps/rods.py. The engine that
runs it is driver/apps/rods_rows.py (the row engine); the flat (N, K)
`RodsSim` comes with a later slice.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class RodsConfig:
    num_rods: int = 10_000
    box_size: float = 60.0
    radius: float = 0.25
    length: float = 2.0  # cylindrical length between cap centers
    youngs_modulus: float = 1000.0
    poissons_ratio: float = 0.3
    viscosity: float = 1.0
    diffusion_coeff: float = 0.0  # translational
    rot_diffusion_coeff: float = 0.0
    dt: float = 1e-4
    num_steps: int = 1000
    skin: float = 0.3
    max_neighbors: int = 32
    cell_capacity: int = 16
    chunk: int = 16384
    seed: int = 1234
    dtype: str = "float32"
    log_every: int = 100
    # "rows" = the dense row-block narrow phase (RowRodsSim), "nmat" = the
    # (N, K) neighbor-matrix engine, "auto" picks rows when the box admits
    # >= 5 cells per axis
    engine: str = "auto"
    # "spherocylinder" (segment-segment narrow phase) or "ellipsoid"
    # (prolate ellipsoids, semi-axes (radius, radius, length/2 + radius))
    shape: str = "spherocylinder"
    ellipsoid_pgd_iters: int = 24
    ellipsoid_refine_iters: int = 8
    ellipsoid_warm_start: bool = True
    ellipsoid_warm_pgd_iters: int = 6
    # frictional segment-segment contact (tangential spring on the
    # accumulated contact-point slip, Coulomb-capped)
    friction: bool = False
    friction_coeff: float = 0.5
    tang_spring: float = 100.0
    tang_damping: float = 0.0

    def __validate__(self):
        assert self.length >= 0 and self.radius > 0
        assert self.box_size > 2 * (self.length + 2 * self.radius + self.skin)
        assert self.engine in ("auto", "rows", "nmat")
        assert self.shape in ("spherocylinder", "ellipsoid")
        if self.friction:
            assert self.shape == "spherocylinder", \
                "friction runs on the segment narrow phase"
