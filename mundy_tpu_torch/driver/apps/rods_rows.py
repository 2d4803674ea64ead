"""Row-engine spherocylinder suspension (BASELINE config #3).

Port of mundy_tpu/driver/apps/rods_rows.py. Rod centers live in the dense
(ny, nz, R) row layout with the orientation quaternion riding beside them
as a payload; each step computes the segment-segment Hertzian force and
torque with kernel K4 (ops/kernels/row_segments.py), adds gid-keyed
translational and rotational Brownian noise, and takes a rigid-body Euler
step (periodic wrap, exponential-map quaternion update). A skin
displacement trigger re-sorts the rows.

The control flow is the reference's, step for step: every block begins with
a rebuild, and the skin test after every inner step ends the inner loop;
the host reads the trigger once per step, as RowSpheresSim does.
Rotational noise draws from the key fold_in(key, 0x5EED). Noise goes to
every slot; positions of invalid slots are kept, and their quaternions are
reset to the identity at the next rebuild, as in the reference.
"""

from __future__ import annotations

import math as _math
from typing import Optional

import numpy as np
import torch

from mundy_tpu_torch.core.config import validate_config
from mundy_tpu_torch.core.containers import frozen_dataclass
from mundy_tpu_torch.core.interop import key_words, row_state_from_numpy
from mundy_tpu_torch.driver.apps.rods import RodsConfig
from mundy_tpu_torch.driver.regrow import grow_int, run_blocks
from mundy_tpu_torch.dynamics.brownian import brownian_velocity_keyed, fold_in
from mundy_tpu_torch.dynamics.integrators import euler_step_rigid
from mundy_tpu_torch.forces.contact import effective_youngs
from mundy_tpu_torch.geom.periodicity import periodic
from mundy_tpu_torch.geom.randomize import random_unit_quaternions
from mundy_tpu_torch.math.quaternion import quat_rotate
from mundy_tpu_torch.neighbor.rows import (
    RowState,
    build_rows,
    make_row_grid,
    moved_beyond_skin,
    orthorhombic_lengths,
    rows_to_flat,
)
from mundy_tpu_torch.ops.kernels.row_segments import row_segment_pairs_sym

_DTYPES = {"float32": torch.float32, "float64": torch.float64}
_ROT_KEY = 0x5EED  # fold_in data of the rotational noise stream


@frozen_dataclass
class RowRodsState:
    rows: RowState  # centers
    quat: torch.Tensor  # (ny, nz, R, 4) orientations (body z = axis)
    key: tuple  # the run's two uint32 key words (python ints)
    step: int
    rebuild_count: int
    overflow: torch.Tensor  # () bool, sticky


def row_rods_state_from_numpy(grid: RowGrid, pos, gid, valid, ref_pos,
                              rows_overflow, quat, key, step, rebuild_count,
                              overflow, device="cpu") -> RowRodsState:
    """A RowRodsState from the reference RowRodsState's arrays: the row
    fields as for spheres_rows.row_spheres_state_from_numpy, and quat, the
    (ny, nz, R, 4) orientation payload in the positions' dtype."""
    rows = row_state_from_numpy(grid, pos, gid, valid, ref_pos, rows_overflow, device)
    quat = torch.as_tensor(np.array(quat), device=device)
    if quat.dtype != rows.pos.dtype:
        raise TypeError(f"quaternions are {quat.dtype}, positions {rows.pos.dtype}")
    return RowRodsState(rows=rows, quat=quat, key=key_words(key), step=int(step),
                        rebuild_count=int(rebuild_count),
                        overflow=torch.as_tensor(bool(overflow), device=device))


class RowRodsSim:
    """Row-engine simulation for RodsConfig on one device (the card unless
    the caller asks for "cpu")."""

    def __init__(self, config: RodsConfig, capacity_slack: float = 1.9,
                 device="cuda"):
        self.config = c = config
        validate_config(config)
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("RowRodsSim(device='cuda') needs a CUDA device, "
                               "and torch sees none")
        if c.engine == "nmat" or c.shape == "ellipsoid" or c.friction:
            # the reference's row engine ignores these options and runs plain
            # spherocylinders; the port refuses them (ROADMAP queue 3)
            raise ValueError(
                "RowRodsSim runs the frictionless spherocylinder narrow phase only; "
                "engine='nmat', shape='ellipsoid' and friction run on "
                "driver/apps/rods.RodsSim (make_rods_sim picks it)")
        self.dtype = _DTYPES[c.dtype]
        box = [c.box_size] * 3
        self.metric = periodic(box, dtype=self.dtype, device=self.device)
        # pair cutoff between centers = 2 * bounding radius + skin
        self.cutoff = c.length + 2 * c.radius + c.skin
        self.capacity_slack = capacity_slack
        # align=8 keeps the reference's slot layout (its TPU kernel needs
        # nz % 8 == 0; the CUDA kernel does not)
        self.grid = make_row_grid([0, 0, 0], box, self.cutoff, c.num_rods,
                                  capacity_slack=capacity_slack,
                                  dtype=self.dtype, align=8, device=self.device)
        if self.grid.ny < 5 or self.grid.nz < 5:
            raise ValueError("box too small for the row engine "
                             "(need >= 5 cells per periodic axis)")
        self.box_static = orthorhombic_lengths(self.metric)
        a_eff = (0.75 * (0.5 * c.length + c.radius) * c.radius * c.radius) ** (1.0 / 3.0)
        self.inv_drag_t = 1.0 / (6.0 * _math.pi * c.viscosity * a_eff)
        self.inv_drag_r = 1.0 / (8.0 * _math.pi * c.viscosity * a_eff ** 3)
        self.e_eff = effective_youngs(c.youngs_modulus, c.youngs_modulus,
                                      c.poissons_ratio, c.poissons_ratio)
        self.dt = torch.tensor(c.dt, dtype=self.dtype, device=self.device)
        self._zhat = torch.tensor([0.0, 0.0, 1.0], dtype=self.dtype, device=self.device)
        self._ident = torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=self.dtype,
                                   device=self.device)

    def _gids(self) -> torch.Tensor:
        return torch.arange(self.config.num_rods, dtype=torch.int32,
                            device=self.device)

    def init(self, pos: Optional[torch.Tensor] = None,
             quat: Optional[torch.Tensor] = None,
             key_words: Optional[tuple] = None) -> RowRodsState:
        """Initial state. With no arguments the centers are drawn uniformly
        in the box and the orientations as random unit quaternions, from a
        torch.Generator seeded with config.seed, and the key is (0, seed),
        what jax.random.PRNGKey(seed) holds; that is not the key the JAX
        `init` splits off for its run, so the default trajectories differ.
        Pass `pos` (N, 3), `quat` (N, 4) and `key_words` to start from
        another engine's state."""
        c = self.config
        gen = torch.Generator(device=self.device).manual_seed(c.seed)
        if pos is None:
            pos = torch.rand((c.num_rods, 3), generator=gen, dtype=self.dtype,
                             device=self.device) * c.box_size
        if quat is None:
            quat = random_unit_quaternions(gen, c.num_rods, dtype=self.dtype,
                                           device=self.device)
        if key_words is None:
            key_words = (0, c.seed & 0xFFFFFFFF)
        pos = torch.as_tensor(pos, dtype=self.dtype, device=self.device)
        quat = torch.as_tensor(quat, dtype=self.dtype, device=self.device)
        rows = build_rows(pos, self._gids(), self.grid)
        # right-size R from the measured occupancy (work scales with R)
        R = self.grid.row_capacity
        max_occ = int(rows.valid.reshape(-1, R).sum(dim=1).max())
        tight = ((int(max_occ * 1.125) + 4 + 7) // 8) * 8
        if tight < R:
            self.grid = self.grid.replace(row_capacity=tight)
            rows = build_rows(pos, self._gids(), self.grid)
        return RowRodsState(rows=rows, quat=self._payload_to_rows(quat, rows),
                            key=tuple(int(k) for k in key_words), step=0,
                            rebuild_count=1, overflow=rows.overflow)

    def _payload_to_rows(self, flat: torch.Tensor, rows: RowState) -> torch.Tensor:
        """Gather a flat gid-ordered quaternion payload into the row layout
        (identity on invalid slots)."""
        safe = torch.clamp(rows.gid.to(torch.int64), max=self.config.num_rods - 1)
        return torch.where(rows.valid[..., None], flat[safe], self._ident)

    def _payload_to_flat(self, state: RowRodsState) -> torch.Tensor:
        """The row quaternions in gid order (zeros for rods a build dropped)."""
        n = self.config.num_rods
        idx = torch.where(state.rows.valid.reshape(-1),
                          state.rows.gid.reshape(-1).to(torch.int64), n)
        out = torch.zeros((n + 1, 4), dtype=self.dtype, device=self.device)
        out[idx] = state.quat.reshape(-1, 4)
        return out[:n]

    # ------------------------------------------------------------------
    def half_edges(self, rows: RowState, quat: torch.Tensor) -> torch.Tensor:
        """(ny, nz, R, 3) half-edge vectors: the axis R(q) z times length/2,
        zero on invalid slots."""
        axes = quat_rotate(quat, self._zhat)
        return (0.5 * self.config.length) * torch.where(rows.valid[..., None], axes, 0.0)

    def _forces_torques(self, rows: RowState, quat: torch.Tensor):
        """Segment-segment Hertzian force and torque on the row layout
        (kernel K4)."""
        c = self.config
        return row_segment_pairs_sym(rows.pos, self.half_edges(rows, quat),
                                     rows.valid, self.box_static[0], c.radius,
                                     self.e_eff)

    def _inner_step(self, state: RowRodsState) -> RowRodsState:
        c = self.config
        rows = state.rows
        force, torque = self._forces_torques(rows, state.quat)
        vel = self.inv_drag_t * force
        omega = self.inv_drag_r * torque
        if c.diffusion_coeff > 0:
            vel = vel + brownian_velocity_keyed(state.key, state.step, rows.gid,
                                                c.diffusion_coeff, c.dt,
                                                dtype=self.dtype)
        if c.rot_diffusion_coeff > 0:
            omega = omega + brownian_velocity_keyed(fold_in(state.key, _ROT_KEY),
                                                    state.step, rows.gid,
                                                    c.rot_diffusion_coeff, c.dt,
                                                    dtype=self.dtype)
        pos, quat = euler_step_rigid(rows.pos, state.quat, vel, omega, self.dt,
                                     metric=self.metric)
        pos = torch.where(rows.valid[..., None], pos, rows.pos)
        return state.replace(rows=rows.replace(pos=pos), quat=quat,
                             step=state.step + 1)

    def _rebuild(self, state: RowRodsState) -> RowRodsState:
        n = self.config.num_rods
        flat_pos = rows_to_flat(state.rows, n)
        flat_quat = self._payload_to_flat(state)
        rows = build_rows(flat_pos, self._gids(), self.grid)
        return state.replace(rows=rows, quat=self._payload_to_rows(flat_quat, rows),
                             rebuild_count=state.rebuild_count + 1,
                             overflow=state.overflow | rows.overflow)

    def _skin_fired(self, state: RowRodsState) -> bool:
        return bool(moved_beyond_skin(state.rows, self.metric,
                                      self.config.skin).item())

    def run_block(self, state: RowRodsState, n_steps: int) -> RowRodsState:
        """n_steps steps: a rebuild at the start of the block and after every
        step that moved a rod center beyond skin/2, as in the reference."""
        done = 0
        while done < n_steps:
            state = self._rebuild(state)
            fired = False
            while done < n_steps and not fired:
                state = self._inner_step(state)
                done += 1
                # the trigger only decides the next iteration: skip the
                # read (and its sync) once the block is complete
                fired = done < n_steps and self._skin_fired(state)
        return state

    def regrow(self, state: RowRodsState) -> RowRodsState:
        """Grow the row slot capacity and re-sort the current centers and
        quaternions into the bigger layout (driver/regrow.py)."""
        c = self.config
        if int(state.rows.valid.sum()) != c.num_rods:
            raise RuntimeError("row state lost particles; cannot regrow")
        flat_pos = rows_to_flat(state.rows, c.num_rods)
        flat_quat = self._payload_to_flat(state)
        self.grid = self.grid.replace(row_capacity=grow_int(self.grid.row_capacity))
        rows = build_rows(flat_pos, self._gids(), self.grid)
        return state.replace(rows=rows, quat=self._payload_to_rows(flat_quat, rows),
                             overflow=rows.overflow)

    def run(self, state: Optional[RowRodsState] = None, log=print):
        c = self.config
        if state is None:
            state = self.init()

        def status(s, done, tps):
            return (f"step {done}/{c.num_steps}  tps={tps:.2f}  "
                    f"rebuilds={s.rebuild_count}  overflow={bool(s.overflow)}")

        return run_blocks(self, state, c.num_steps, c.log_every, log, status)

    # diagnostics ------------------------------------------------------
    def positions(self, state: RowRodsState) -> torch.Tensor:
        return rows_to_flat(state.rows, self.config.num_rods)

    def quaternions(self, state: RowRodsState) -> torch.Tensor:
        return self._payload_to_flat(state)
