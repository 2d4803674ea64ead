"""Spheres app on the dense row-grid engine (BASELINE config #1).

Port of mundy_tpu/driver/apps/spheres_rows.py. The state lives in the
(ny, nz, R) row layout between rebuilds; each step computes Hertzian contact
forces with kernel K1 (ops/kernels/row_central.py), adds gid-keyed Brownian
noise, and takes an overdamped Euler step with periodic wrap. A skin
displacement trigger re-sorts the rows. A small box, whose row grid has
ny or nz < 5 (the half stencil of K1 and the image pre-shift need 5), takes
the reference's fallback, the general neighbor/rows.pair_accumulate with
the Hertz pair_fn under the full minimum image, with two corrections
(ROADMAP queue 3): each neighbour row counts once where ny or nz <= 2
(the reference's nine rolls count its pairs two or three times), and
polydisperse spheres pass their radius plane to the pair_fn (the
reference's uses the scalar radius). With `polydispersity > 0` the radii
are drawn as the reference draws them (numpy, seed + 777), the grid cutoff
covers the largest pair, the forces run through kernel K6 with a radius
plane (ops/kernels/row_hertz.py) and drag and diffusion scale per sphere,
their per-slot planes computed once per rebuild.

The control flow is the reference's, step for step: every block begins with
a rebuild, and the skin test after every inner step ends the inner loop.
The reference keeps that trigger on the device inside a while loop; here
the host reads it once per step (one `.item()`, a device sync per step),
because reading it less often would rebuild later than the reference does
and break trajectory parity.
"""

from __future__ import annotations

import math as _math
from typing import Optional

import torch

from mundy_tpu_torch.core.config import validate_config
from mundy_tpu_torch.core.containers import frozen_dataclass
from mundy_tpu_torch.core.interop import key_words, row_state_from_numpy
from mundy_tpu_torch.driver.apps.spheres import SpheresConfig, polydisperse_radii
from mundy_tpu_torch.driver.regrow import grow_int, run_blocks
from mundy_tpu_torch.dynamics.brownian import brownian_velocity_keyed
from mundy_tpu_torch.forces.contact import effective_youngs, hertzian_pair_force
from mundy_tpu_torch.geom.periodicity import periodic
from mundy_tpu_torch.neighbor.rows import (
    RowState,
    build_rows,
    make_row_grid,
    moved_beyond_skin,
    orthorhombic_lengths,
    pair_accumulate,
    rows_to_flat,
)
from mundy_tpu_torch.ops.kernels.row_central import row_hertzian_forces_sym
from mundy_tpu_torch.ops.kernels.row_hertz import row_hertzian_forces

_DTYPES = {"float32": torch.float32, "float64": torch.float64}
_CAPACITY_SLACK = 1.9  # row capacity over the mean occupancy, before init right-sizing


@frozen_dataclass
class RowSpheresState:
    rows: RowState
    key: tuple  # the run's two uint32 key words (python ints)
    step: int
    rebuild_count: int
    overflow: torch.Tensor  # () bool, sticky


def row_spheres_state_from_numpy(grid: RowGrid, pos, gid, valid, ref_pos,
                                 rows_overflow, key, step, rebuild_count,
                                 overflow, device="cpu") -> RowSpheresState:
    """A RowSpheresState from the reference RowSpheresState's arrays.

    pos/ref_pos: (ny, nz, R, 3); gid: (ny, nz, R) int; valid: (ny, nz, R)
    bool; rows_overflow: the last build's flag; key: the two uint32 words of
    the raw threefry key (`jax.random.key_data`); step and rebuild_count:
    ints; overflow: the state's sticky flag. The positions keep their numpy
    dtype, which must match the grid's."""
    rows = row_state_from_numpy(grid, pos, gid, valid, ref_pos, rows_overflow, device)
    return RowSpheresState(rows=rows, key=key_words(key), step=int(step),
                           rebuild_count=int(rebuild_count),
                           overflow=torch.as_tensor(bool(overflow), device=device))


class RowSpheresSim:
    """Assembled row-engine simulation for SpheresConfig on one device (the
    card unless the caller asks for "cpu")."""

    def __init__(self, config: SpheresConfig, device="cuda"):
        self.config = c = config
        validate_config(config)
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("RowSpheresSim(device='cuda') needs a CUDA "
                               "device, and torch sees none")
        self.dtype = _DTYPES[c.dtype]
        box = [c.box_size] * 3
        self.metric = periodic(box, dtype=self.dtype, device=self.device)
        self.cutoff = 2 * c.radius + c.skin
        # polydisperse radii, the reference's draw (seed + 777, as its flat
        # engine draws them); the cutoff covers the largest pair
        self.radii = None
        self._planes = None  # slot_planes' (gid, planes) of the last layout
        if c.polydispersity > 0:
            rr = polydisperse_radii(c)
            self.radii = torch.as_tensor(rr, dtype=self.dtype, device=self.device)
            self.cutoff = 2 * float(rr.max()) + c.skin
        # align=8 keeps the reference's slot layout (its TPU kernel needs
        # nz % 8 == 0; the CUDA kernel does not)
        self.grid = make_row_grid([0, 0, 0], box, self.cutoff, c.num_spheres,
                                  capacity_slack=_CAPACITY_SLACK,
                                  dtype=self.dtype, align=8,
                                  device=self.device)
        self.box_static = orthorhombic_lengths(self.metric)
        # the reference's condition for its central-force engines
        self.small_box = self.grid.ny < 5 or self.grid.nz < 5
        self.inv_drag = 1.0 / (6.0 * _math.pi * c.viscosity * c.radius)
        self.e_eff = effective_youngs(c.youngs_modulus, c.youngs_modulus,
                                      c.poissons_ratio, c.poissons_ratio)
        self.dt = torch.tensor(c.dt, dtype=self.dtype, device=self.device)
        # the small-box pair_fn's constants, in the positions' dtype
        self._hertz = tuple(torch.tensor(v, dtype=self.dtype, device=self.device)
                            for v in (0.5 * c.radius, 2.0 * c.radius, self.e_eff))

    def _gids(self) -> torch.Tensor:
        return torch.arange(self.config.num_spheres, dtype=torch.int32,
                            device=self.device)

    def init(self, pos: Optional[torch.Tensor] = None,
             key_words: Optional[tuple] = None) -> RowSpheresState:
        """Initial state. With no arguments the positions are drawn uniformly
        in the box from a torch.Generator seeded with config.seed, and the
        key is (0, seed), what jax.random.PRNGKey(seed) holds. Pass `pos`
        (N, 3) and `key_words` to start from another engine's state."""
        c = self.config
        if pos is None:
            gen = torch.Generator(device=self.device).manual_seed(c.seed)
            pos = torch.rand((c.num_spheres, 3), generator=gen,
                             dtype=self.dtype, device=self.device) * c.box_size
        if key_words is None:
            key_words = (0, c.seed & 0xFFFFFFFF)
        pos = torch.as_tensor(pos, dtype=self.dtype, device=self.device)
        rows = build_rows(pos, self._gids(), self.grid)
        # Right-size the row capacity from the measured max occupancy: the
        # pair work scales with R^2, so slack is paid every step. +12.5%
        # margin (occupancy drifts between rebuilds), 8-aligned; the sticky
        # overflow flag catches later violations.
        R = self.grid.row_capacity
        max_occ = int(rows.valid.reshape(-1, R).sum(dim=1).max())
        tight = ((int(max_occ * 1.125) + 4 + 7) // 8) * 8
        if tight < R:
            self.grid = self.grid.replace(row_capacity=tight)
            rows = build_rows(pos, self._gids(), self.grid)
        return RowSpheresState(rows=rows, key=tuple(int(k) for k in key_words),
                               step=0, rebuild_count=1, overflow=rows.overflow)

    # ------------------------------------------------------------------
    def _slot_radii(self, rows: RowState) -> torch.Tensor:
        """(ny, nz, R) radius of each slot's sphere (invalid slots hold
        gid 0's)."""
        return self.radii[torch.clamp(rows.gid, max=self.config.num_spheres - 1).long()]

    def slot_planes(self, rows: RowState) -> tuple:
        """The polydisperse spheres' per-slot planes: (radius, zero on
        invalid slots; inverse drag (ny, nz, R, 1), zero there; diffusion
        coefficient D radius / r). They change only with the slot layout, so
        they are computed once per rebuild and kept for the rows' gid
        tensor, which every build replaces."""
        if self._planes is None or self._planes[0] is not rows.gid:
            c = self.config
            kw = dict(dtype=self.dtype, device=self.device)
            r = self._slot_radii(rows)
            r_safe = torch.clamp(r, min=1e-12)
            r_rows = torch.where(rows.valid, r, 0.0)
            inv_drag = torch.where(rows.valid, 1.0 / (6.0 * _math.pi * c.viscosity * r_safe),
                                   0.0)[..., None]
            diff = (torch.tensor(c.diffusion_coeff, **kw) * torch.tensor(c.radius, **kw)
                    / r_safe)
            self._planes = (rows.gid, (r_rows, inv_drag, diff))
        return self._planes[1]

    def _small_box_forces(self, rows: RowState) -> torch.Tensor:
        """Hertz forces through pair_accumulate (the small-box fallback),
        with each sphere's radius when the spheres are polydisperse."""
        r_eff, two_r, e_eff = self._hertz

        def rinv_d(r2):
            r2 = torch.clamp(r2, min=1e-24)
            rinv = torch.rsqrt(r2)
            return rinv, r2 * rinv

        if self.radii is None:
            def pair_fn(sep, r2, mask):
                rinv, d = rinv_d(r2)
                mag = hertzian_pair_force(d - two_r, r_eff, e_eff)
                return -torch.where(mask, mag * rinv, 0.0)[..., None] * sep

            return pair_accumulate(rows, self.metric, pair_fn, box=self.box_static)

        def pair_fn_poly(sep, r2, mask, ro, rc):
            rinv, d = rinv_d(r2)
            re = (ro * rc) / torch.clamp(ro + rc, min=1e-12)
            mag = hertzian_pair_force(d - (ro + rc), re, e_eff)
            return -torch.where(mask, mag * rinv, 0.0)[..., None] * sep

        return pair_accumulate(rows, self.metric, pair_fn_poly,
                               extra_fields=(self.slot_planes(rows)[0],), box=self.box_static)

    def _forces(self, rows: RowState) -> torch.Tensor:
        c = self.config
        if self.small_box:
            return self._small_box_forces(rows)
        if self.radii is not None:
            return row_hertzian_forces(rows.pos, rows.valid, self.box_static[0],
                                       c.radius, c.youngs_modulus, c.poissons_ratio,
                                       radii=self.slot_planes(rows)[0])
        return row_hertzian_forces_sym(rows.pos, self.box_static[0], c.radius,
                                       c.youngs_modulus, c.poissons_ratio,
                                       valid=rows.valid)

    def _inner_step(self, state: RowSpheresState) -> RowSpheresState:
        c = self.config
        rows = state.rows
        force = self._forces(rows)
        diff = c.diffusion_coeff
        if self.radii is not None:
            _, inv_drag, diff = self.slot_planes(rows)
            vel = inv_drag * force
        else:
            vel = self.inv_drag * force
        if c.diffusion_coeff > 0:
            # gid-keyed counter-based noise: the reference's streams
            bz = brownian_velocity_keyed(state.key, state.step, rows.gid, diff, c.dt,
                                         dtype=self.dtype)
            vel = vel + torch.where(rows.valid[..., None], bz, 0.0)
        new_pos = self.metric.wrap(rows.pos + self.dt * vel)
        new_pos = torch.where(rows.valid[..., None], new_pos, rows.pos)
        return state.replace(rows=rows.replace(pos=new_pos), step=state.step + 1)

    def _rebuild(self, state: RowSpheresState) -> RowSpheresState:
        c = self.config
        flat = rows_to_flat(state.rows, c.num_spheres)
        rows = build_rows(flat, self._gids(), self.grid)
        return state.replace(rows=rows, rebuild_count=state.rebuild_count + 1,
                             overflow=state.overflow | rows.overflow)

    def _skin_fired(self, state: RowSpheresState) -> bool:
        return bool(moved_beyond_skin(state.rows, self.metric,
                                      self.config.skin).item())

    def run_block(self, state: RowSpheresState, n_steps: int) -> RowSpheresState:
        """n_steps steps: a rebuild at the start of the block and after every
        step that moved a particle beyond skin/2, as in the reference."""
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

    def regrow(self, state: RowSpheresState) -> RowSpheresState:
        """Grow the row slot capacity and re-sort the current positions into
        the bigger layout (driver/regrow.py)."""
        c = self.config
        if int(state.rows.valid.sum()) != c.num_spheres:
            # the row layout is the primary state: a build that dropped
            # particles has already lost their positions
            raise RuntimeError("row state lost particles; cannot regrow")
        pos = rows_to_flat(state.rows, c.num_spheres)
        self.grid = self.grid.replace(
            row_capacity=grow_int(self.grid.row_capacity))
        rows = build_rows(pos, self._gids(), self.grid)
        return state.replace(rows=rows, overflow=rows.overflow)

    def run(self, state: Optional[RowSpheresState] = None, log=print):
        c = self.config
        if state is None:
            state = self.init()

        def status(s, done, tps):
            return (f"step {done}/{c.num_steps}  tps={tps:.1f}  "
                    f"rebuilds={s.rebuild_count}  overflow={bool(s.overflow)}")

        return run_blocks(self, state, c.num_steps, c.log_every, log, status)

    # diagnostics ------------------------------------------------------
    def positions(self, state: RowSpheresState) -> torch.Tensor:
        return rows_to_flat(state.rows, self.config.num_spheres)

    def max_overlap(self, state: RowSpheresState) -> float:
        """Largest pair overlap r_i + r_j - d over the 9-row neighborhood (0
        when no pair touches), with each sphere's own radius when the
        spheres are polydisperse."""
        pos, valid = state.rows.pos, state.rows.valid
        if self.radii is not None:
            r = self._slot_radii(state.rows)
        else:
            r = torch.full(valid.shape, self.config.radius, dtype=pos.dtype,
                           device=pos.device)
        R = pos.shape[2]
        not_self = ~torch.eye(R, dtype=torch.bool, device=pos.device)
        worst = torch.zeros((), dtype=pos.dtype, device=pos.device)
        for dy in (-1, 0, 1):
            for dz in (-1, 0, 1):
                cand_pos = torch.roll(pos, (-dy, -dz), dims=(0, 1))
                cand_valid = torch.roll(valid, (-dy, -dz), dims=(0, 1))
                cand_r = torch.roll(r, (-dy, -dz), dims=(0, 1))
                d = self.metric.distance(pos[..., :, None, :],
                                         cand_pos[..., None, :, :])
                mask = valid[..., :, None] & cand_valid[..., None, :]
                if (dy, dz) == (0, 0):
                    mask = mask & not_self
                ov = torch.where(mask, r[..., :, None] + cand_r[..., None, :] - d,
                                 -torch.inf)
                worst = torch.maximum(worst, ov.max())
        return float(worst)
