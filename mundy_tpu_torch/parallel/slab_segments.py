"""Sharded row-engine spherocylinders: z-slab decomposition of the dense
segment-segment narrow phase (config #3 over ranks).

Port of mundy_tpu/parallel/slab_segments.py over the ranks of a Group, the
slab_rows pattern for oriented bodies. Each rod carries its orientation
quaternion as a payload. Per step each rank:

1. rotates its rods' axes from their quaternions and builds the half-edges
   (zero on invalid slots);
2. receives one (ny, 1, R, 7) boundary plane (midpoint, half-edge, valid
   flag) from each ring neighbour by `ppermute`, the wrapped midpoint
   planes shifted by the global z wrap;
3. computes its own rods' forces and torques with kernel K4's rods op
   (ops/kernels/row_segments.py, `row_segment_pairs_sym`) on the
   halo-extended (ny, nzl + 2, R) block, padded with empty, invalid planes
   up to the 5 that K4 needs. K4 sums, for each own slot, its 9 candidate
   rows one-sidedly, the rows (y + dy, z + dz) pre-shifted to the image
   nearest the own row and the minimum image on x only: the reference
   stencil's arithmetic (`_segment_pair_chunk`, the plain version's).
   For an own plane the 9 rows are planes z - 1 .. z + 1 of the block,
   never wrapped in z, so every (own, own) and (own, halo) pair is taken
   once from each own side, as in the reference; the wrapped candidates of
   halo and pad planes land only on their outputs, which are dropped;
4. integrates its rods (gid-keyed translational and rotational streams,
   the rotational one from fold_in(key, 0x5EED), a rigid Euler step with
   the quaternion update), as the single-device RowRodsSim does.

Rebuilds as slab_rows: the local resort (quaternions riding along, the
identity on empty slots) where legal, else the global psum resort.
"""

from __future__ import annotations

import math as _math

import torch

from mundy_tpu_torch.dynamics.brownian import brownian_velocity_keyed, fold_in
from mundy_tpu_torch.dynamics.integrators import euler_step_rigid
from mundy_tpu_torch.forces.contact import effective_youngs
from mundy_tpu_torch.geom.periodicity import periodic
from mundy_tpu_torch.math.quaternion import quat_rotate
from mundy_tpu_torch.neighbor.rows import build_rows, make_row_grid
from mundy_tpu_torch.ops.kernels.row_segments import row_segment_pairs_sym
from mundy_tpu_torch.parallel.comm import Group
from mundy_tpu_torch.parallel.slab_local import slab_local_resort
from mundy_tpu_torch.parallel.slab_rows import (
    MIN_ROWS,
    SlabEngine,
    empty_slot,
    flat_by_gid,
    halo_planes,
    pad_axis,
    resolve_rebuild_mode,
    run_block,
    skin_moved,
    slab_grid,
)

ROT_KEY = 0x5EED  # fold_in data of the rotational noise stream


def rods_block(lo, own, hi, box_size: float, empty: torch.Tensor):
    """K4's inputs from the packed (midpoint, half-edge, valid) planes: the
    (ny, nzl + 2, R) block padded to >= 5 planes, as (mid, half_edges,
    valid), and the box lengths; the own slots are [:, 1:nzl + 1]."""
    ext = pad_axis(torch.cat([lo, own, hi], dim=1), 1, empty)
    return (ext[..., :3].contiguous(), ext[..., 3:6].contiguous(),
            (ext[..., 6] > 0.5).contiguous(), (float(box_size),) * 3)


def make_slab_rods_step(group: Group, n_total: int, box_size: float, length: float = 2.0,
                        radius: float = 0.25, youngs: float = 1000.0, poisson: float = 0.3,
                        viscosity: float = 1.0, diffusion: float = 0.1,
                        rot_diffusion: float = 0.1, dt: float = 1e-4, skin: float = 0.4,
                        capacity_slack: float = 1.9, dtype=torch.float32,
                        rebuild_mode: str = "auto",
                        row_capacity=None) -> SlabEngine:
    """The rods z-slab engine on this rank of `group` (its device);
    `row_capacity`, when given, replaces the grid's (the regrow path)."""
    d, dev = group.size, group.device
    metric = periodic([box_size] * 3, dtype=dtype, device=dev)
    cutoff = length + 2 * radius + skin
    grid = make_row_grid([0, 0, 0], [box_size] * 3, cutoff, n_total,
                         capacity_slack=capacity_slack, dtype=dtype, device=dev)
    if grid.ny < MIN_ROWS or grid.nz < MIN_ROWS:
        raise ValueError("box too small for the row engine (need >= 5 cells per periodic axis)")
    grid = slab_grid(grid, d, box_size, min_planes=MIN_ROWS)
    if row_capacity is not None:
        grid = grid.replace(row_capacity=int(row_capacity))
    nzl = grid.nz // d
    z0 = group.rank * nzl
    rebuild_mode = resolve_rebuild_mode(rebuild_mode, d, nzl, grid.nz)
    half = 0.5 * length
    e_eff = effective_youngs(youngs, youngs, poisson, poisson)
    a_eff = (0.75 * (0.5 * length + radius) * radius * radius) ** (1.0 / 3.0)
    inv_drag_t = 1.0 / (6.0 * _math.pi * viscosity * a_eff)
    inv_drag_r = 1.0 / (8.0 * _math.pi * viscosity * a_eff ** 3)
    dt_t = torch.tensor(dt, dtype=dtype, device=dev)
    zhat = torch.tensor([0.0, 0.0, 1.0], dtype=dtype, device=dev)
    ident = torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=dtype, device=dev)
    empty = empty_slot(grid, 7, dtype, dev)
    gids = torch.arange(n_total, dtype=torch.int32, device=dev)

    def extended(state):
        valid = state["valid"]
        axes = quat_rotate(state["quat"], zhat)
        hedges = half * torch.where(valid[..., None], axes, 0.0)
        packed = torch.cat([state["pos"], hedges, valid[..., None].to(dtype)], dim=-1)
        lo, hi = halo_planes(group, packed, box_size)
        return rods_block(lo, packed, hi, box_size, empty)

    def inner_step(state):
        pos, quat, valid = state["pos"], state["quat"], state["valid"]
        mid_e, he_e, valid_e, box = extended(state)
        force, torque = row_segment_pairs_sym(mid_e, he_e, valid_e, box, radius, e_eff)
        vel = inv_drag_t * force[:, 1:1 + nzl]
        omega = inv_drag_r * torque[:, 1:1 + nzl]
        if diffusion > 0:
            vel = vel + brownian_velocity_keyed(state["key"], state["step"], state["gid"],
                                                diffusion, dt, dtype=dtype)
        if rot_diffusion > 0:
            omega = omega + brownian_velocity_keyed(fold_in(state["key"], ROT_KEY),
                                                    state["step"], state["gid"],
                                                    rot_diffusion, dt, dtype=dtype)
        new_pos, new_quat = euler_step_rigid(pos, quat, vel, omega, dt_t, metric=metric)
        new_pos = torch.where(valid[..., None], new_pos, pos)
        return {**state, "pos": new_pos, "quat": new_quat, "step": state["step"] + 1}

    def rows_of(pos_flat, quat_flat):
        """build_rows of the flat positions, this rank's planes, with the
        quaternions gathered beside them (the identity on empty slots)."""
        rows = build_rows(pos_flat, gids, grid)
        safe = torch.clamp(rows.gid.to(torch.int64), max=n_total - 1)
        qrows = torch.where(rows.valid[..., None], quat_flat[safe], ident)
        sl = slice(z0, z0 + nzl)
        p = rows.pos[:, sl].contiguous()
        return (p, qrows[:, sl].contiguous(), rows.valid[:, sl].contiguous(),
                rows.gid[:, sl].contiguous(), rows.overflow)

    def rebuild(state):
        if rebuild_mode == "local":
            new_pos, new_val, new_gid, (new_quat,), ovf = slab_local_resort(
                group, state["pos"], state["valid"], state["gid"], grid, nzl,
                extras=(state["quat"],), extra_fill=(ident,), ovf=state["overflow"])
        else:
            pq = flat_by_gid(group, torch.cat([state["pos"], state["quat"]], dim=-1),
                             state["valid"], state["gid"], n_total)
            new_pos, new_quat, new_val, new_gid, rovf = rows_of(pq[:, :3], pq[:, 3:])
            ovf = state["overflow"] | rovf
        return {**state, "pos": new_pos, "quat": new_quat, "valid": new_val, "gid": new_gid,
                "ref_pos": new_pos, "overflow": ovf, "rebuilds": state["rebuilds"] + 1}

    def init(pos, key_words, step0: int = 0, quat=None) -> dict:
        """This rank's state from the full (N, 3) centres and (N, 4)
        quaternions (every rank passes the same), the run's two key words
        and the global step."""
        pos = torch.as_tensor(pos, dtype=dtype, device=dev)
        quat = torch.as_tensor(quat, dtype=dtype, device=dev)
        p, q, v, g, ovf = rows_of(pos, quat)
        return {"pos": p, "quat": q, "valid": v, "gid": g, "ref_pos": p, "overflow": ovf,
                "key": tuple(int(k) for k in key_words), "step": int(step0), "rebuilds": 0}

    def step_block(state, n_steps: int) -> dict:
        return run_block(state, n_steps, rebuild, inner_step,
                         lambda s: skin_moved(group, metric, s, skin))

    return SlabEngine(init, step_block, grid, extended, rebuild_mode, nzl)
