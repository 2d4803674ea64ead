"""Granular DEM: inertial spheres with frictional Hertzian contact.

Port of mundy_tpu/driver/apps/granular.py (the app-level exercise of the
reference's FrictionalHertzianContact family,
`CollidingFrictionalSperm.cpp`): spring-dashpot normal force, a tangential
spring on each contact's accumulated displacement with a Coulomb cap
(forces/friction.py), gravity settling into a box of Hertzian-spring walls,
and a symplectic Euler step (velocity first, then position).

The broad phase bins a non-periodic (L, L, 2L) cell grid and compacts the
neighbor matrix into the unique i < j pair list (build_pair_list). Each
contact's tangential history lives in its pair-list slot and follows the
contact across a rebuild by pair identity (constraints/collision.
remap_gamma). As in the other apps the host runs the block loop and reads
the skin flag once per step, so the rebuilds fall on the reference's steps.
"""

from __future__ import annotations

import dataclasses
import math as _math
from typing import Optional

import torch

from mundy_tpu_torch.constraints.collision import remap_gamma
from mundy_tpu_torch.core.config import validate_config
from mundy_tpu_torch.core.containers import frozen_dataclass
from mundy_tpu_torch.driver.apps.spheres import DTYPES, cuda_device
from mundy_tpu_torch.driver.regrow import grow_int, run_blocks
from mundy_tpu_torch.forces.friction import frictional_hertzian_contact
from mundy_tpu_torch.neighbor.cell_list import (
    PairList,
    build_cell_list,
    build_pair_list,
    make_cell_grid,
    neighbor_matrix,
)


@dataclasses.dataclass
class GranularConfig:
    num_spheres: int = 2000
    box_size: float = 20.0  # x/y walls; z floor at 0, ceiling at 2 box_size
    radius: float = 0.5
    density: float = 1.0
    gravity: float = 10.0  # -z
    friction_coeff: float = 0.5
    normal_spring: float = 5e4
    normal_damping: float = 20.0
    tang_spring: float = 2e4
    tang_damping: float = 10.0
    wall_spring: float = 5e4
    dt: float = 1e-4
    num_steps: int = 1000
    skin: float = 0.3
    max_neighbors: int = 16
    cell_capacity: int = 16
    pair_capacity_per_body: int = 8
    chunk: int = 16384
    seed: int = 1234
    dtype: str = "float32"
    log_every: int = 200

    def __validate__(self):
        assert self.friction_coeff >= 0 and self.num_spheres > 0
        assert self.box_size > 4 * (self.radius + self.skin)


@frozen_dataclass
class GranularState:
    pos: torch.Tensor  # (N, 3)
    vel: torch.Tensor  # (N, 3)
    key: tuple  # the run's two uint32 key words (python ints)
    step: int
    pairs: PairList  # unique i < j, skin-buffered
    tang_disp: torch.Tensor  # (C, 3) per-pair tangential history
    ref_pos: torch.Tensor  # positions at the last rebuild
    rebuild_count: int
    overflow: torch.Tensor  # () bool, sticky


class GranularSim:
    """The granular app on one device (the card unless the caller asks for
    "cpu")."""

    def __init__(self, config: GranularConfig, device="cuda"):
        self.config = c = config
        validate_config(config)
        self.device = cuda_device(device, "GranularSim")
        self.dtype = DTYPES[c.dtype]
        kw = dict(dtype=self.dtype, device=self.device)
        self.search_radius = c.radius + 0.5 * c.skin
        ext = [c.box_size, c.box_size, 2.0 * c.box_size]
        self.grid = make_cell_grid([0, 0, 0], ext, 2 * self.search_radius,
                                   (False,) * 3, **kw)
        self.pair_capacity = c.pair_capacity_per_body * c.num_spheres
        self.mass = (4.0 / 3.0) * _math.pi * c.density * c.radius ** 3
        self.radius = torch.tensor(c.radius, **kw)
        self.dt = torch.tensor(c.dt, **kw)
        self.skin_sq = torch.tensor((0.5 * c.skin) ** 2, **kw)

    def _broad_phase(self, pos: torch.Tensor):
        c = self.config
        clist = build_cell_list(pos, self.grid, c.cell_capacity)
        nmat = neighbor_matrix(pos, clist, self.search_radius,
                               max_neighbors=c.max_neighbors,
                               chunk=min(c.chunk, max(256, c.num_spheres)))
        pairs = build_pair_list(nmat, self.pair_capacity)
        return pairs, clist.overflow | nmat.overflow | pairs.overflow

    def init(self, pos: Optional[torch.Tensor] = None,
             key_words: Optional[tuple] = None) -> GranularState:
        """Initial state at rest: a loose cloud 2 radii inside the walls,
        drawn from a torch.Generator seeded with config.seed, and the key
        (0, seed), unless `pos` (N, 3) and `key_words` are given (the
        reference's state keeps the second half of a split of its key)."""
        c = self.config
        if pos is None:
            gen = torch.Generator(device=self.device).manual_seed(c.seed)
            lo = torch.tensor([2 * c.radius] * 3, dtype=self.dtype, device=self.device)
            hi = torch.tensor([c.box_size - 2 * c.radius, c.box_size - 2 * c.radius,
                               2.0 * c.box_size - 2 * c.radius],
                              dtype=self.dtype, device=self.device)
            u = torch.rand((c.num_spheres, 3), generator=gen, dtype=self.dtype,
                           device=self.device)
            pos = lo + (hi - lo) * u
        if key_words is None:
            key_words = (0, c.seed & 0xFFFFFFFF)
        pos = torch.as_tensor(pos, dtype=self.dtype, device=self.device)
        pairs, ovf = self._broad_phase(pos)
        return GranularState(
            pos=pos, vel=torch.zeros_like(pos), key=tuple(int(k) for k in key_words),
            step=0, pairs=pairs, tang_disp=pos.new_zeros((self.pair_capacity, 3)),
            ref_pos=pos, rebuild_count=1, overflow=ovf)

    def _wall_force(self, pos: torch.Tensor) -> torch.Tensor:
        """Hertzian-spring walls: the floor z = 0, the ceiling and the four
        sides (frictionless), their six terms added in the reference's
        order."""
        c = self.config
        r, k = c.radius, c.wall_spring

        def spring(over):
            return k * torch.clamp(over, min=0.0) ** 1.5

        f = torch.zeros_like(pos)
        f[:, 2] += spring(r - pos[:, 2])  # floor
        f[:, 2] += -spring(pos[:, 2] - (2.0 * c.box_size - r))
        for ax in (0, 1):
            f[:, ax] += spring(r - pos[:, ax])
            f[:, ax] += -spring(pos[:, ax] - (c.box_size - r))
        return f

    def _inner_step(self, state: GranularState) -> GranularState:
        c = self.config
        res = frictional_hertzian_contact(
            state.pos, state.vel, self.radius, state.pairs, state.tang_disp, self.dt,
            normal_spring=c.normal_spring, normal_damping=c.normal_damping,
            tang_spring=c.tang_spring, tang_damping=c.tang_damping,
            friction_coeff=c.friction_coeff, density=c.density)
        f = res.forces + self._wall_force(state.pos)
        f[:, 2] += -self.mass * c.gravity
        vel = state.vel + (self.dt / self.mass) * f
        pos = state.pos + self.dt * vel
        return state.replace(pos=pos, vel=vel, tang_disp=res.tang_disp,
                             step=state.step + 1)

    def _rebuild(self, state: GranularState) -> GranularState:
        pairs, ovf = self._broad_phase(state.pos)
        # the tangential history follows its contact by (i, j) identity
        tang = remap_gamma(state.pairs, state.tang_disp, pairs,
                           probes=self.config.max_neighbors)
        return state.replace(pairs=pairs, tang_disp=tang, ref_pos=state.pos,
                             rebuild_count=state.rebuild_count + 1,
                             overflow=state.overflow | ovf)

    def _moved(self, state: GranularState) -> bool:
        disp = state.pos - state.ref_pos
        return bool((disp * disp).sum(-1).max() > self.skin_sq)

    def run_block(self, state: GranularState, n_steps: int) -> GranularState:
        """n_steps steps: a rebuild at the start of the block and after every
        step that moved a sphere beyond skin/2, as in the reference."""
        done = 0
        while done < n_steps:
            state = self._rebuild(state)
            fired = False
            while done < n_steps and not fired:
                state = self._inner_step(state)
                done += 1
                fired = done < n_steps and self._moved(state)
        return state

    def regrow(self, state: GranularState) -> GranularState:
        """Grow the cell capacity, K and the pair capacity (1024-aligned),
        rebuild the pair list and carry the history across."""
        c = self.config
        c.cell_capacity = grow_int(c.cell_capacity)
        c.max_neighbors = grow_int(c.max_neighbors)
        self.pair_capacity = grow_int(self.pair_capacity, align=1024)
        pairs, ovf = self._broad_phase(state.pos)
        tang = remap_gamma(state.pairs, state.tang_disp, pairs, probes=c.max_neighbors)
        return state.replace(pairs=pairs, tang_disp=tang, ref_pos=state.pos, overflow=ovf)

    def run(self, state: Optional[GranularState] = None, log=print) -> GranularState:
        c = self.config
        if state is None:
            state = self.init()

        def status(s, done, tps):
            return (f"step {done}/{c.num_steps}  tps={tps:.1f}  "
                    f"KE={self.kinetic_energy(s):.3e}  rebuilds={s.rebuild_count}  "
                    f"overflow={bool(s.overflow)}")

        return run_blocks(self, state, c.num_steps, c.log_every, log, status)

    def kinetic_energy(self, state: GranularState) -> float:
        return float(0.5 * self.mass * (state.vel * state.vel).sum())
