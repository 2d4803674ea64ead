"""BASELINE config #1: spheres in a periodic box — Hertzian contact,
overdamped (Stokes drag) dynamics, optional Brownian motion, explicit Euler.

Port of mundy_tpu/driver/apps/spheres.py: the config schema and the flat
cell-list engine `SpheresSim`, the one the configurator runs for `app:
spheres` (the row-grid engine is driver/apps/spheres_rows.py). Each step
sums Hertzian contact forces over an (N, K) neighbor matrix
(neighbor/cell_list.py), adds gid-keyed Brownian noise and takes a wrapped
Euler step; a skin trigger rebuilds the cell list and the matrix. With
`polydispersity > 0` the radii are drawn as the reference draws them, every
sphere searches with its own radius + skin/2, and contact, drag and noise
take each sphere's radius.

The reference runs a block as a nested while loop on the device; here the
host runs it, reading the skin flag once per step, so the rebuilds fall on
the reference's steps (as in spheres_rows.py).
"""

from __future__ import annotations

import dataclasses
import math as _math
from typing import Optional

import numpy as np
import torch

from mundy_tpu_torch.core.config import validate_config
from mundy_tpu_torch.core.containers import frozen_dataclass
from mundy_tpu_torch.driver.regrow import grow_int, run_blocks
from mundy_tpu_torch.dynamics.brownian import brownian_velocity_keyed
from mundy_tpu_torch.dynamics.integrators import euler_step
from mundy_tpu_torch.forces.contact import hertzian_contact_forces
from mundy_tpu_torch.geom.periodicity import periodic
from mundy_tpu_torch.io.telemetry import at_step, host_read, trace
from mundy_tpu_torch.neighbor.cell_list import (
    NeighborMatrix,
    build_cell_list,
    make_cell_grid,
    neighbor_matrix,
)

DTYPES = {"float32": torch.float32, "float64": torch.float64}


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


def cuda_device(device, name: str) -> torch.device:
    """torch.device(device), raising for a CUDA device when torch sees no
    card: no entry point falls back to the CPU on its own."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{name}(device='cuda') needs a CUDA device, and torch "
                           "sees none (pass device='cpu' to run on the CPU)")
    return device


@frozen_dataclass
class SpheresState:
    pos: torch.Tensor  # (N, 3)
    key: tuple  # the run's two uint32 key words (python ints)
    step: int
    nmat: NeighborMatrix
    ref_pos: torch.Tensor  # positions at the last rebuild
    rebuild_count: int
    overflow: torch.Tensor  # () bool, sticky


class SpheresSim:
    """The flat cell-list engine for SpheresConfig on one device (the card
    unless the caller asks for "cpu")."""

    def __init__(self, config: SpheresConfig, device="cuda"):
        self.config = c = config
        validate_config(config)
        self.device = cuda_device(device, "SpheresSim")
        self.dtype = DTYPES[c.dtype]
        kw = dict(dtype=self.dtype, device=self.device)
        box = [c.box_size] * 3
        self.metric = periodic(box, dtype=self.dtype, device=self.device)
        # search radius = radius + skin/2 per body, so the pair cutoff is
        # r_i + r_j + skin; the cell edge covers the largest pair cutoff
        self.radii = None
        self.search_radii = None
        if c.polydispersity > 0:
            rr = polydisperse_radii(c)
            self.radii = torch.as_tensor(rr, **kw)
            self.search_radius = float(rr.max()) + 0.5 * c.skin
            self.search_radii = self.radii + torch.tensor(0.5 * c.skin, **kw)
        else:
            self.search_radius = c.radius + 0.5 * c.skin
        self.grid = make_cell_grid([0, 0, 0], box, min_cell_size=2 * self.search_radius,
                                   periodic=(True,) * 3, **kw)
        self.inv_drag = 1.0 / (6.0 * _math.pi * c.viscosity * c.radius)
        self.radius = torch.tensor(c.radius, **kw)
        self.diffusion = torch.tensor(c.diffusion_coeff, **kw)
        if self.radii is not None:
            self.inv_drag = (1.0 / (6.0 * _math.pi * c.viscosity * self.radii))[:, None]
            self.radius = self.radii
            # Stokes-Einstein per particle: D_i = D0 r0 / r_i
            self.diffusion = self.diffusion * torch.tensor(c.radius, **kw) / self.radii
        self.youngs = torch.tensor(c.youngs_modulus, **kw)
        self.poisson = torch.tensor(c.poissons_ratio, **kw)
        self.dt = torch.tensor(c.dt, **kw)
        self.skin_sq = torch.tensor((0.5 * c.skin) ** 2, **kw)
        self.gids = torch.arange(c.num_spheres, dtype=torch.int32, device=self.device)

    # ------------------------------------------------------------------
    def _build_nmat(self, pos: torch.Tensor):
        c = self.config
        clist = build_cell_list(pos, self.grid, c.cell_capacity)
        sr = self.search_radii if self.search_radii is not None else self.search_radius
        nmat = neighbor_matrix(pos, clist, sr, metric=self.metric,
                               max_neighbors=c.max_neighbors,
                               chunk=min(c.chunk, max(256, c.num_spheres)))
        return nmat, clist.overflow | nmat.overflow

    def init(self, pos: Optional[torch.Tensor] = None,
             key_words: Optional[tuple] = None) -> SpheresState:
        """Initial state. With no arguments the positions are drawn uniformly
        in the box from a torch.Generator seeded with config.seed, and the
        key is (0, seed), what jax.random.PRNGKey(seed) holds. Pass `pos`
        (N, 3) and `key_words` to start from another engine's state (the
        reference's state keeps the second half of a split of its key:
        pass `jax.random.key_data(state.key)`)."""
        c = self.config
        if pos is None:
            gen = torch.Generator(device=self.device).manual_seed(c.seed)
            pos = torch.rand((c.num_spheres, 3), generator=gen, dtype=self.dtype,
                             device=self.device) * c.box_size
        if key_words is None:
            key_words = (0, c.seed & 0xFFFFFFFF)
        pos = torch.as_tensor(pos, dtype=self.dtype, device=self.device)
        nmat, ovf = self._build_nmat(pos)
        return SpheresState(pos=pos, key=tuple(int(k) for k in key_words), step=0,
                            nmat=nmat, ref_pos=pos, rebuild_count=1, overflow=ovf)

    # ------------------------------------------------------------------
    def _inner_step(self, state: SpheresState) -> SpheresState:
        """Force, Brownian velocity and Euler step against the current
        neighbor matrix (no rebuild)."""
        c = self.config
        at_step(state.step)
        with trace("step"):
            with trace("forces"):
                force = hertzian_contact_forces(state.pos, self.radius, self.youngs,
                                                self.poisson, state.nmat, metric=self.metric)
                vel = self.inv_drag * force
            if c.diffusion_coeff > 0.0:
                with trace("noise"):
                    vel = vel + brownian_velocity_keyed(state.key, state.step, self.gids,
                                                        self.diffusion, c.dt, dtype=self.dtype)
            with trace("integrate"):
                pos = euler_step(state.pos, vel, self.dt, metric=self.metric)
        return state.replace(pos=pos, step=state.step + 1)

    def _rebuild(self, state: SpheresState) -> SpheresState:
        at_step(state.step)
        with trace("rebuild"):
            nmat, ovf = self._build_nmat(state.pos)
        return state.replace(nmat=nmat, ref_pos=state.pos,
                             rebuild_count=state.rebuild_count + 1,
                             overflow=state.overflow | ovf)

    def _moved(self, state: SpheresState) -> torch.Tensor:
        disp = self.metric.sep(state.ref_pos, state.pos)
        return (disp * disp).sum(-1).max() > self.skin_sq

    def step(self, state: SpheresState) -> SpheresState:
        """One step, rebuilding first when a sphere has moved beyond skin/2."""
        if host_read("skin", self._moved(state)):
            state = self._rebuild(state)
        return self._inner_step(state)

    def run_block(self, state: SpheresState, n_steps: int) -> SpheresState:
        """n_steps steps: a rebuild at the start of the block and after every
        step that moved a sphere beyond skin/2, as in the reference."""
        done = 0
        while done < n_steps:
            state = self._rebuild(state)
            fired = False
            while done < n_steps and not fired:
                state = self._inner_step(state)
                done += 1
                # the flag only decides the next iteration: skip the read
                # (and its sync) once the block is complete
                fired = done < n_steps and host_read("skin", self._moved(state))
        return state

    def regrow(self, state: SpheresState) -> SpheresState:
        """Grow the cell capacity and K, and rebuild the neighbor matrix
        from the state's positions (driver/regrow.py)."""
        c = self.config
        c.cell_capacity = grow_int(c.cell_capacity)
        c.max_neighbors = grow_int(c.max_neighbors)
        nmat, ovf = self._build_nmat(state.pos)
        return state.replace(nmat=nmat, ref_pos=state.pos, overflow=ovf)

    def run(self, state: Optional[SpheresState] = None, log=print) -> SpheresState:
        """Block loop with tps telemetry and overflow-triggered regrow."""
        c = self.config
        if state is None:
            state = self.init()

        def status(s, done, tps):
            return (f"step {done}/{c.num_steps}  tps={tps:.1f}  "
                    f"rebuilds={s.rebuild_count}  overflow={bool(s.overflow)}")

        return run_blocks(self, state, c.num_steps, c.log_every, log, status)

    # diagnostics ------------------------------------------------------
    def max_overlap(self, state: SpheresState) -> float:
        """Worst pair overlap 2 radius - d over the neighbor matrix
        (positive = penetration), with the config's radius for every pair,
        as the reference measures it."""
        c = self.config
        idx = torch.clamp(state.nmat.idx, max=c.num_spheres - 1).long()
        sep = self.metric.sep(state.pos[:, None, :], state.pos[idx])
        d = torch.sqrt((sep * sep).sum(-1)) - 2 * c.radius
        d = torch.where(state.nmat.mask, d, torch.inf)
        return float(-d.min())
