"""BASELINE config #3: spherocylinder (rod) suspension: segment-segment
narrow phase, Hertzian contact with torques, Brownian motion, rigid-body
Euler/quaternion update.

Port of mundy_tpu/driver/apps/rods.py: the config schema and the (N, K)
neighbor-matrix engine `RodsSim` (the row engine is driver/apps/
rods_rows.py). RodsSim runs what the configurator sends it: engine="nmat",
prolate ellipsoids (the shared-normal minimization of geom/distance.py,
warm-started from each slot's previous normal), frictional segment contact
(per-slot tangential history, remapped by pair identity at every rebuild),
and boxes with fewer than 5 row cells per axis.

The broad phase builds the neighbor matrix through the row layout where
the reference does, and on the cell list elsewhere. The reference takes
rows when its TPU kernel's envelope admits the shape or when K R <= 2048
(the work gate of its plain extraction); on the card in float32 the port
asks rows_extract_feasible (kernel K2's envelope) in place of the TPU test,
and elsewhere keeps the reference's work gate, so a CPU run builds the
reference's neighbor matrix. The block loop is the reference's nested loop
run by the host, which reads the skin flag once per step.
"""

from __future__ import annotations

import dataclasses
import math as _math
from typing import Optional

import torch

from mundy_tpu_torch.core.config import validate_config
from mundy_tpu_torch.core.containers import frozen_dataclass
from mundy_tpu_torch.driver.apps.spheres import DTYPES, cuda_device
from mundy_tpu_torch.driver.regrow import grow_int, run_blocks
from mundy_tpu_torch.dynamics.brownian import brownian_angular_velocity, brownian_velocity
from mundy_tpu_torch.dynamics.integrators import euler_step_rigid
from mundy_tpu_torch.forces.contact import effective_youngs, hertzian_pair_force
from mundy_tpu_torch.forces.friction import (frictional_segment_contact_rows,
                                             remap_row_history)
from mundy_tpu_torch.geom.distance import (distance_ellipsoid_ellipsoid,
                                           segment_closest_planes, segment_segment_closest)
from mundy_tpu_torch.geom.periodicity import periodic
from mundy_tpu_torch.geom.primitives import Ellipsoid
from mundy_tpu_torch.geom.randomize import random_unit_quaternions
from mundy_tpu_torch.math.linalg import cross
from mundy_tpu_torch.math.quaternion import quat_rotate
from mundy_tpu_torch.neighbor.cell_list import (NeighborMatrix, build_cell_list,
                                                make_cell_grid, neighbor_matrix)
from mundy_tpu_torch.neighbor.rows import (make_row_grid, neighbor_matrix_rows,
                                           orthorhombic_lengths, rows_extract_feasible)


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
    # (N, K) neighbor-matrix engine (RodsSim), "auto" picks rows when the
    # box admits >= 5 cells per axis
    engine: str = "auto"
    # "spherocylinder" (segment-segment narrow phase) or "ellipsoid"
    # (prolate ellipsoids, semi-axes (radius, radius, length/2 + radius):
    # multistart PGD + the L-BFGS chart polish, the reference's
    # EllipsoidEllipsoid.hpp:45-110)
    shape: str = "spherocylinder"
    ellipsoid_pgd_iters: int = 24
    ellipsoid_refine_iters: int = 8
    # temporal warm start of the ellipsoid narrow phase: each pair slot's
    # converged normal seeds the next step's PGD (one start, fewer
    # iterations); the full multistart runs once per rebuild
    ellipsoid_warm_start: bool = True
    ellipsoid_warm_pgd_iters: int = 6
    # frictional segment-segment contact (the CollidingFrictionalSperm
    # capability): a tangential spring on the accumulated contact-point
    # slip, Coulomb-capped, the slip rate from the previous step's body
    # velocities; the history lives in the neighbor-row slots
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


@frozen_dataclass
class RodsState:
    pos: torch.Tensor  # (N, 3) centers
    quat: torch.Tensor  # (N, 4) orientations (body z = axis)
    key: tuple  # the run's two uint32 key words (python ints)
    step: int
    nmat: NeighborMatrix
    ref_pos: torch.Tensor  # centers at the last rebuild
    rebuild_count: int
    overflow: torch.Tensor  # () bool, sticky
    # (N, K, 3) per-slot shared normals (the ellipsoid warm start; a
    # (1, 1, 3) placeholder otherwise)
    warm_n: torch.Tensor
    # friction (config.friction; (1, 1, 3) and (1, 3) placeholders
    # otherwise): the per-slot tangential history and the previous step's
    # body velocities, from which the slip rate is taken
    tang: torch.Tensor
    prev_vel: torch.Tensor
    prev_omega: torch.Tensor


class RodsSim:
    """The (N, K) neighbor-matrix engine for RodsConfig on one device (the
    card unless the caller asks for "cpu")."""

    def __init__(self, config: RodsConfig, device="cuda"):
        self.config = c = config
        validate_config(config)
        self.device = cuda_device(device, "RodsSim")
        self.dtype = DTYPES[c.dtype]
        kw = dict(dtype=self.dtype, device=self.device)
        box = [c.box_size] * 3
        self.metric = periodic(box, **kw)
        self.box_static = orthorhombic_lengths(self.metric)
        # the bounding-sphere search radius (ComputeBoundingRadius)
        self.search_radius = 0.5 * c.length + c.radius + 0.5 * c.skin
        self.grid = make_cell_grid([0, 0, 0], box, 2 * self.search_radius,
                                   periodic=(True,) * 3, **kw)
        self.rows_slack = 1.9  # the row broad phase's slot slack (regrow grows it)
        # isotropic local drag for a rod of half-length + cap envelope
        a_eff = (0.75 * (0.5 * c.length + c.radius) * c.radius * c.radius) ** (1.0 / 3.0)
        self.inv_drag_t = 1.0 / (6.0 * _math.pi * c.viscosity * a_eff)
        self.inv_drag_r = 1.0 / (8.0 * _math.pi * c.viscosity * a_eff ** 3)
        e_eff = effective_youngs(c.youngs_modulus, c.youngs_modulus,
                                 c.poissons_ratio, c.poissons_ratio)
        self.e_eff = torch.tensor(e_eff, **kw)
        self.r_eff = torch.tensor(0.5 * c.radius, **kw)
        self.dt = torch.tensor(c.dt, **kw)
        self.skin_sq = torch.tensor((0.5 * c.skin) ** 2, **kw)
        self._zhat = torch.tensor([0.0, 0.0, 1.0], **kw)
        # the ellipsoid's body semi-axes (body z = the rod axis)
        self._radii = torch.tensor([c.radius, c.radius, 0.5 * c.length + c.radius], **kw)

    # ------------------------------------------------------------------
    def _axes(self, quat: torch.Tensor) -> torch.Tensor:
        return quat_rotate(quat, self._zhat)

    def broad_phase(self) -> str:
        """"rows" where _build_nmat builds through the row layout (kernel K2
        on the card), else "cells"."""
        return "cells" if self._row_grid() is None else "rows"

    def _row_grid(self):
        """The row grid of the broad phase, or None for the cell list."""
        c = self.config
        if int(c.box_size // (2 * self.search_radius)) < 5:
            return None
        rg = make_row_grid([0, 0, 0], (c.box_size,) * 3, 2 * float(self.search_radius),
                           c.num_rods, capacity_slack=self.rows_slack, dtype=self.dtype,
                           align=8, device=self.device)
        if self.device.type == "cuda" and self.dtype == torch.float32:
            ok = rows_extract_feasible(rg, c.max_neighbors)
        else:
            ok = c.max_neighbors * rg.row_capacity <= 2048
        return rg if ok else None

    def _build_nmat(self, pos: torch.Tensor):
        c = self.config
        rg = self._row_grid()
        if rg is not None:
            nmat = neighbor_matrix_rows(pos, float(self.search_radius), (c.box_size,) * 3,
                                        max_neighbors=c.max_neighbors, grid=rg)
            return nmat, nmat.overflow
        clist = build_cell_list(pos, self.grid, c.cell_capacity)
        nmat = neighbor_matrix(pos, clist, self.search_radius, metric=self.metric,
                               max_neighbors=c.max_neighbors,
                               chunk=min(c.chunk, max(256, c.num_rods)))
        return nmat, clist.overflow | nmat.overflow

    def _contact_forces_torques(self, pos: torch.Tensor, quat: torch.Tensor, nmat):
        """Segment-segment Hertzian contact over the neighbor matrix: (force
        (N, 3), torque (N, 3)), each rod's row summed one-sidedly, the torque
        from the arm to the contact point on the rod's own surface."""
        c = self.config
        idx = torch.clamp(nmat.idx.long(), max=c.num_rods - 1)
        hedge = (0.5 * c.length) * self._axes(quat)
        payload = torch.cat([pos, hedge], dim=1)  # (N, 6): one gather per pair
        cand = payload[idx]  # (N, K, 6)
        (lx, ly, lz), (px, py, pz) = self.box_static
        S = [cand[..., i] - pos[:, None, i] for i in range(3)]
        for i, (L, p) in enumerate(((lx, px), (ly, py), (lz, pz))):
            if p:
                S[i] = S[i] - L * torch.round(S[i] * (1.0 / L))
        oe = [hedge[:, None, i] for i in range(3)]
        s, _t, DX, DY, DZ, d2 = segment_closest_planes(
            *S, *oe, cand[..., 3], cand[..., 4], cand[..., 5])
        d2c = torch.clamp(d2, min=1e-24)
        rinv = torch.rsqrt(d2c)
        mag = hertzian_pair_force(d2c * rinv - 2.0 * c.radius, self.r_eff, self.e_eff)
        w = torch.where(nmat.mask, -(mag * rinv), 0.0)
        fx, fy, fz = w * DX, w * DY, w * DZ
        # the contact point on our surface: the own closest point
        # (2 s - 1) half_edge plus radius d_hat
        u2 = 2.0 * s - 1.0
        rr = c.radius * rinv
        px_ = u2 * oe[0] + rr * DX
        py_ = u2 * oe[1] + rr * DY
        pz_ = u2 * oe[2] + rr * DZ
        force = torch.stack([fx.sum(1), fy.sum(1), fz.sum(1)], dim=-1)
        torque = torch.stack([(py_ * fz - pz_ * fy).sum(1), (pz_ * fx - px_ * fz).sum(1),
                              (px_ * fy - py_ * fx).sum(1)], dim=-1)
        return force, torque

    def _ellipsoid_narrow(self, pos: torch.Tensor, quat: torch.Tensor, nmat,
                          warm_n: Optional[torch.Tensor] = None):
        """The shared-normal narrow phase over the neighbor matrix (a
        SepResult of (N, K) pairs); `warm_n` (N, K, 3) seeds each slot from
        the previous step's normal in place of the 7-start sweep."""
        c = self.config
        idx = torch.clamp(nmat.idx.long(), max=c.num_rods - 1)
        own = pos[:, None, :]
        # the candidates' centers at their minimum image around our own
        cj = own + self.metric.sep(own, pos[idx])
        radii = self._radii[None, None, :]
        e_own = Ellipsoid(center=own, orientation=quat[:, None, :], radii=radii)
        e_cand = Ellipsoid(center=cj, orientation=quat[idx], radii=radii)
        iters = c.ellipsoid_pgd_iters if warm_n is None else c.ellipsoid_warm_pgd_iters
        return distance_ellipsoid_ellipsoid(e_own, e_cand, newton_iters=iters, refine="lbfgs",
                                            refine_iters=c.ellipsoid_refine_iters, n0=warm_n)

    def _warm_normals(self, pos: torch.Tensor, quat: torch.Tensor, nmat) -> torch.Tensor:
        """The cold (full multistart) normals of every valid slot, zero on
        the others: the warm seeds after a rebuild."""
        res = self._ellipsoid_narrow(pos, quat, nmat)
        return torch.where(nmat.mask[..., None], res.normal, 0.0)

    def _contact_forces_torques_ellipsoid(self, pos: torch.Tensor, quat: torch.Tensor,
                                          nmat, warm_n: Optional[torch.Tensor] = None):
        """Prolate-ellipsoid Hertzian contact over the neighbor matrix:
        (force, torque, normals), the normals of every valid slot kept as the
        next step's warm seeds (ref: the linker kernels dispatching
        EllipsoidEllipsoid.hpp:45-110)."""
        res = self._ellipsoid_narrow(pos, quat, nmat, warm_n)
        mag = torch.where(nmat.mask, hertzian_pair_force(res.dist, self.r_eff, self.e_eff), 0.0)
        f_pair = -mag[..., None] * res.normal  # pushes our body along -n
        t_pair = cross(res.point1 - pos[:, None, :], f_pair)  # arm to our contact point
        warm_out = torch.where(nmat.mask[..., None], res.normal, 0.0)
        return f_pair.sum(1), t_pair.sum(1), warm_out

    def _inner_step(self, state: RodsState) -> RodsState:
        c = self.config
        warm_out = tang_out = None
        if c.shape == "ellipsoid":
            seed = state.warm_n if c.ellipsoid_warm_start else None
            force, torque, warm_out = self._contact_forces_torques_ellipsoid(
                state.pos, state.quat, state.nmat, warm_n=seed)
        elif c.friction:
            hedge = (0.5 * c.length) * self._axes(state.quat)
            res = frictional_segment_contact_rows(
                state.pos, hedge, state.prev_vel, state.prev_omega, state.nmat.idx,
                state.nmat.mask, state.tang, self.dt, c.radius, c.youngs_modulus,
                c.poissons_ratio, c.tang_spring, c.friction_coeff,
                tang_damping=c.tang_damping, metric=self.metric)
            force, torque, tang_out = res.forces, res.torques, res.tang_disp
        else:
            force, torque = self._contact_forces_torques(state.pos, state.quat, state.nmat)
        vel = self.inv_drag_t * force
        omega = self.inv_drag_r * torque
        kw = dict(dtype=self.dtype, device=self.device)
        if c.diffusion_coeff > 0:
            vel = vel + brownian_velocity(state.key, state.step, c.num_rods,
                                          c.diffusion_coeff, c.dt, **kw)
        if c.rot_diffusion_coeff > 0:
            omega = omega + brownian_angular_velocity(state.key, state.step, c.num_rods,
                                                      c.rot_diffusion_coeff, c.dt, **kw)
        pos, quat = euler_step_rigid(state.pos, state.quat, vel, omega, self.dt,
                                     metric=self.metric)
        out = state.replace(pos=pos, quat=quat, step=state.step + 1)
        if warm_out is not None and c.ellipsoid_warm_start:
            out = out.replace(warm_n=warm_out)
        if tang_out is not None:
            # the total velocities (contact + noise): the next step's slip
            # rate sees the motion that happened
            out = out.replace(tang=tang_out, prev_vel=vel, prev_omega=omega)
        return out

    def _renew_nmat(self, state: RodsState) -> tuple:
        """A new neighbor matrix at the state's centers, the friction history
        carried over by pair identity and the warm normals re-seeded cold:
        (state with nmat, tang and warm_n replaced, the build's overflow)."""
        c = self.config
        nmat, ovf = self._build_nmat(state.pos)
        if c.friction:
            state = state.replace(tang=remap_row_history(
                state.nmat.idx, state.nmat.mask, state.tang, nmat.idx, nmat.mask))
        state = state.replace(nmat=nmat, ref_pos=state.pos)
        if c.shape == "ellipsoid" and c.ellipsoid_warm_start:
            # the rows changed: every valid slot starts from the full
            # multistart once per rebuild, then rides its warm seed
            state = state.replace(warm_n=self._warm_normals(state.pos, state.quat, nmat))
        return state, ovf

    def _rebuild(self, state: RodsState) -> RodsState:
        state, ovf = self._renew_nmat(state)
        return state.replace(rebuild_count=state.rebuild_count + 1,
                             overflow=state.overflow | ovf)

    def _moved(self, state: RodsState) -> torch.Tensor:
        disp = self.metric.sep(state.ref_pos, state.pos)
        return (disp * disp).sum(-1).max() > self.skin_sq

    def run_block(self, state: RodsState, n_steps: int) -> RodsState:
        """n_steps steps: a rebuild at the start of the block and after every
        step that moved a rod center beyond skin/2, as in the reference."""
        done = 0
        while done < n_steps:
            state = self._rebuild(state)
            fired = False
            while done < n_steps and not fired:
                state = self._inner_step(state)
                done += 1
                # the flag only decides the next iteration: skip the read
                # (and its sync) once the block is complete
                fired = done < n_steps and bool(self._moved(state))
        return state

    def init(self, pos: Optional[torch.Tensor] = None, quat: Optional[torch.Tensor] = None,
             key_words: Optional[tuple] = None) -> RodsState:
        """Initial state. With no arguments the centers are drawn uniformly
        in the box and the orientations as random unit quaternions, from a
        torch.Generator seeded with config.seed, and the key is (0, seed),
        what jax.random.PRNGKey(seed) holds (not the key the JAX `init`
        splits off for its run, so the default trajectories differ). Pass
        `pos` (N, 3), `quat` (N, 4) and `key_words` to start from another
        engine's state."""
        c = self.config
        kw = dict(dtype=self.dtype, device=self.device)
        gen = torch.Generator(device=self.device).manual_seed(c.seed)
        if pos is None:
            pos = torch.rand((c.num_rods, 3), generator=gen, **kw) * c.box_size
        if quat is None:
            quat = random_unit_quaternions(gen, c.num_rods, **kw)
        if key_words is None:
            key_words = (0, c.seed & 0xFFFFFFFF)
        pos = torch.as_tensor(pos, **kw)
        quat = torch.as_tensor(quat, **kw)
        nmat, ovf = self._build_nmat(pos)
        if c.shape == "ellipsoid" and c.ellipsoid_warm_start:
            warm_n = self._warm_normals(pos, quat, nmat)
        else:
            warm_n = torch.zeros((1, 1, 3), **kw)
        if c.friction:
            tang = torch.zeros(nmat.idx.shape + (3,), **kw)
            pvel = torch.zeros((c.num_rods, 3), **kw)
        else:
            tang = torch.zeros((1, 1, 3), **kw)
            pvel = torch.zeros((1, 3), **kw)
        return RodsState(pos=pos, quat=quat, key=tuple(int(k) for k in key_words), step=0,
                         nmat=nmat, ref_pos=pos, rebuild_count=1, overflow=ovf,
                         warm_n=warm_n, tang=tang, prev_vel=pvel,
                         prev_omega=torch.zeros_like(pvel))

    def regrow(self, state: RodsState) -> RodsState:
        """Grow the cell capacity, K and the row slot slack, and rebuild the
        neighbor matrix from the state's centers (driver/regrow.py)."""
        c = self.config
        c.cell_capacity = grow_int(c.cell_capacity)
        c.max_neighbors = grow_int(c.max_neighbors)
        self.rows_slack *= 1.5  # a row-slot overflow must grow R too
        state, ovf = self._renew_nmat(state)
        return state.replace(overflow=ovf)

    def run(self, state: Optional[RodsState] = None, log=print) -> RodsState:
        c = self.config
        if state is None:
            state = self.init()

        def status(s, done, tps):
            return (f"step {done}/{c.num_steps}  tps={tps:.2f}  "
                    f"rebuilds={s.rebuild_count}  overflow={bool(s.overflow)}")

        return run_blocks(self, state, c.num_steps, c.log_every, log, status)

    # diagnostics ------------------------------------------------------
    def max_overlap(self, state: RodsState) -> float:
        """The worst spherocylinder overlap 2 radius - d over a fresh
        neighbor matrix (positive = penetration), as the reference measures
        it."""
        c = self.config
        nmat, _ = self._build_nmat(state.pos)
        axis = self._axes(state.quat)
        half = 0.5 * c.length
        idx = torch.clamp(nmat.idx.long(), max=c.num_rods - 1)
        pj = state.pos[idx]
        shift = self.metric.sep(state.pos[:, None, :], pj) - (pj - state.pos[:, None, :])
        pj = pj + shift
        aj = axis[idx]
        a0 = (state.pos - half * axis)[:, None, :]
        a1 = (state.pos + half * axis)[:, None, :]
        _s, _t, c1, c2 = segment_segment_closest(
            torch.broadcast_to(a0, pj.shape), torch.broadcast_to(a1, pj.shape),
            pj - half * aj, pj + half * aj)
        d = torch.linalg.vector_norm(c2 - c1, dim=-1) - 2 * c.radius
        return float(-torch.where(nmat.mask, d, torch.inf).min())
