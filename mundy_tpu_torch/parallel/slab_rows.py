"""Sharded row-grid spheres engine: z-slab decomposition of the row layout.

Port of mundy_tpu/parallel/slab_rows.py over the ranks of a Group (one
process per rank). The (ny, nz, R) rows are cut into d slabs of nzl = nz / d
z-planes (nz rounded down to a multiple of d), rank r holding planes
r nzl .. (r + 1) nzl - 1. Per step each rank:

1. receives one boundary z-plane from each ring neighbour by `ppermute`, the
   wrapped planes of the box's edge ranks carrying the global z-wrap shift
   (the aura/ghosting analog: O(ny R) bytes against an O(N) all-gather);
2. computes the Hertz forces of its own planes with kernel K6
   (ops/kernels/row_hertz.py, `row_hertzian_forces`, with no radius plane:
   the kernel takes a constant one) on its halo-extended block;
3. integrates its own particles (gid-keyed Brownian streams: the
   trajectories are the single-device row engine's).

The reference runs the 9-row stencil of pair_accumulate_central on the
(ny, nzl + 2, R) block, y periodic by rolls with the image shift
pre-applied and the minimum image on x only. K6 takes the minimum image on
every axis, which would find the contacts of a particle that crossed a y or
z face since the last rebuild, contacts the reference's row engines miss
(ROADMAP queue 3, fault 1; K1 and RowSpheresSim keep that for parity). So
the block handed to K6 carries the y wrap as two more halo rows, the last
row shifted by -L in y and the first by +L, exactly the reference's
pre-shifted rolled rows, and K6 gets 4L for the y and z lengths, where no
separation within reach of an own slot rounds to an image: its minimum
image there is the identity, and the own slots' forces are the reference
stencil's, every candidate row in place. The block is padded with empty,
invalid rows and planes up to the 5 per axis that K6 needs, on every device
alike. Halo and pad outputs are dropped. K6 masks invalid slots, so the
halo carries the valid flag beside the positions.

A skin trigger (`pmax` of each rank's largest squared displacement, read on
the host once per step, as RowSpheresSim reads its own) ends the inner loop;
every block starts with a rebuild, as in the reference:
- "global": a psum of the flat (N, 3) positions, build_rows on every rank,
  each keeping its planes (O(N) bytes and a replicated sort);
- "local": slab_local.slab_local_resort (the default where legal: d >= 2
  and nzl >= 2), rows bit-equal to the global resort's.
"""

from __future__ import annotations

import math as _math
from typing import Callable, NamedTuple

import torch

from mundy_tpu_torch.dynamics.brownian import brownian_velocity_keyed
from mundy_tpu_torch.forces.contact import effective_youngs
from mundy_tpu_torch.geom.periodicity import periodic
from mundy_tpu_torch.neighbor.rows import RowGrid, build_rows, make_row_grid
from mundy_tpu_torch.ops.kernels.row_hertz import row_hertzian_forces
from mundy_tpu_torch.parallel.comm import Group, ring_perms
from mundy_tpu_torch.parallel.slab_local import local_resort_ok, slab_local_resort

MIN_ROWS = 5  # rows and planes per axis that K6 and K4 need
IMAGE_FREE = 4.0  # K6's y and z lengths on the extended block, in box lengths


class SlabEngine(NamedTuple):
    """A z-slab engine on one rank: init(pos, key_words, step0=0, ...) ->
    this rank's state dict; step_block(state, n_steps) -> state; the
    (slab-rounded) grid; extended(state) -> the halo-extended kernel inputs
    of the state's next force evaluation (a collective: every rank calls
    it); the rebuild mode; nzl, the planes per rank."""

    init: Callable
    step_block: Callable
    grid: RowGrid
    extended: Callable
    rebuild_mode: str
    nzl: int


def slab_grid(grid: RowGrid, d: int, box_size: float, min_planes: int = 1) -> RowGrid:
    """The grid with nz rounded down to a multiple of d and the z cell
    edge widened to box / nz (cells only grow, so the cutoff still
    holds)."""
    nz = (grid.nz // d) * d
    if nz < max(d, min_planes):
        raise ValueError("too few z-planes for the ranks")
    cell = grid.cell_yz.clone()
    cell[1] = box_size / nz
    return grid.replace(cell_yz=cell, nz=nz)


def resolve_rebuild_mode(rebuild_mode: str, d: int, nzl: int, nz: int) -> str:
    """"auto" -> "local" where the local resort is legal, else "global"."""
    ok = local_resort_ok(d, nzl)
    if rebuild_mode == "auto":
        return "local" if ok else "global"
    if rebuild_mode == "local" and not ok:
        raise ValueError(f"slab-local rebuild needs >=2 z-planes/slab and >=2 shards; "
                         f"got nz={nz} over {d} shards")
    if rebuild_mode not in ("local", "global"):
        raise ValueError(f"unknown rebuild_mode {rebuild_mode!r}")
    return rebuild_mode


def halo_planes(group: Group, packed: torch.Tensor, box_size: float, shift: bool = True):
    """(lo, hi): the (ny, 1, R, C) boundary planes of the ring neighbours
    below and above this rank's slab, channel 2 (z) shifted by the global
    wrap on the box's edge ranks (half-edges and flags are translation
    invariant); `shift` False for channels that are not positions."""
    up, dn = ring_perms(group.size)
    lo = group.ppermute(packed[:, -1:].contiguous(), up)  # from the rank below
    hi = group.ppermute(packed[:, :1].contiguous(), dn)  # from the rank above
    if shift and group.rank == 0:
        lo[..., 2] = lo[..., 2] + (-box_size)
    if shift and group.rank == group.size - 1:
        hi[..., 2] = hi[..., 2] + box_size
    return lo, hi


def pad_axis(x: torch.Tensor, dim: int, fill: torch.Tensor) -> torch.Tensor:
    """x padded along `dim` up to MIN_ROWS with copies of the (C,) `fill`
    (an empty, invalid slot)."""
    n = x.shape[dim]
    if n >= MIN_ROWS:
        return x
    shape = list(x.shape)
    shape[dim] = MIN_ROWS - n
    return torch.cat([x, fill.to(x.dtype).expand(shape)], dim=dim)


def empty_slot(grid: RowGrid, width: int, dtype, device) -> torch.Tensor:
    """The packed channels of an empty slot: build_rows' sentinel position
    (1e6 box heights below the box in y), zeros elsewhere (half-edges, the
    valid flag)."""
    e = torch.zeros((width,), dtype=dtype, device=device)
    e[1] = (grid.origin[1] - 1e6 * (grid.cell_yz[0] * grid.ny + 1.0)).to(dtype)
    return e


def spheres_block(lo, own, hi, box_size: float, empty: torch.Tensor):
    """K6's inputs from the packed (pos, valid) planes: the (ny + 2,
    nzl + 2, R) block (padded to >= 5 per axis) of positions and the valid
    mask, and the box lengths (L, 4L, 4L). Row 0 is the last row shifted by
    -L in y, row ny + 1 the first shifted by +L; the own slots are
    [1:ny + 1, 1:nzl + 1]."""
    ext = torch.cat([lo, own, hi], dim=1)
    ylo, yhi = ext[-1:].clone(), ext[:1].clone()
    ylo[..., 1] = ylo[..., 1] + (-box_size)
    yhi[..., 1] = yhi[..., 1] + box_size
    ext = torch.cat([ylo, ext, yhi], dim=0)
    ext = pad_axis(pad_axis(ext, 0, empty), 1, empty)
    box = (float(box_size), IMAGE_FREE * box_size, IMAGE_FREE * box_size)
    return ext[..., :3].contiguous(), (ext[..., 3] > 0.5).contiguous(), box


def run_block(state: dict, n_steps: int, rebuild, inner_step, moved) -> dict:
    """The reference's control flow: a rebuild at the start of the block and
    after every step whose (global) skin trigger fired. Every rank reads the
    same trigger, so all take the same path through the collectives."""
    done = 0
    while done < n_steps:
        state = rebuild(state)
        fired = False
        while done < n_steps and not fired:
            state = inner_step(state)
            done += 1
            fired = done < n_steps and moved(state)
    return state


def skin_moved(group: Group, metric, state: dict, skin: float) -> bool:
    """The global skin trigger: the pmax over ranks of the largest squared
    displacement of a valid slot since the last rebuild, > (skin / 2)^2."""
    disp = metric.sep(state["ref_pos"], state["pos"])
    d2 = torch.where(state["valid"], (disp * disp).sum(-1), 0.0)
    return bool(group.pmax(d2.max().reshape(1))[0] > (0.5 * skin) ** 2)


def flat_by_gid(group: Group, values: torch.Tensor, valid, gid, n_total: int) -> torch.Tensor:
    """psum of each rank's (..., C) slot values scattered into an (N, C)
    array by gid: every valid slot's value, in gid order, on every rank."""
    c = values.shape[-1]
    flat = torch.zeros((n_total + 1, c), dtype=values.dtype, device=values.device)
    idx = torch.where(valid.reshape(-1), gid.reshape(-1).to(torch.int64), n_total)
    flat[idx] = values.reshape(-1, c)
    return group.psum(flat[:n_total])


def make_slab_rows_spheres_step(group: Group, n_total: int, box_size: float,
                                radius: float = 0.5, youngs: float = 1000.0,
                                poisson: float = 0.3, viscosity: float = 1.0,
                                diffusion: float = 0.1, dt: float = 1e-4,
                                skin: float = 0.4, capacity_slack: float = 1.9,
                                dtype=torch.float32, rebuild_mode: str = "auto",
                                row_capacity=None) -> SlabEngine:
    """The spheres z-slab engine on this rank of `group` (its device);
    `row_capacity`, when given, replaces the grid's (the regrow path)."""
    d, dev = group.size, group.device
    metric = periodic([box_size] * 3, dtype=dtype, device=dev)
    cutoff = 2 * radius + skin
    grid = make_row_grid([0, 0, 0], [box_size] * 3, cutoff, n_total,
                         capacity_slack=capacity_slack, dtype=dtype, device=dev)
    grid = slab_grid(grid, d, box_size)
    if row_capacity is not None:
        grid = grid.replace(row_capacity=int(row_capacity))
    nzl = grid.nz // d
    z0 = group.rank * nzl
    rebuild_mode = resolve_rebuild_mode(rebuild_mode, d, nzl, grid.nz)
    inv_drag = 1.0 / (6.0 * _math.pi * viscosity * radius)
    e_eff = effective_youngs(youngs, youngs, poisson, poisson)
    dt_t = torch.tensor(dt, dtype=dtype, device=dev)
    empty = empty_slot(grid, 4, dtype, dev)
    gids = torch.arange(n_total, dtype=torch.int32, device=dev)

    def extended(state):
        packed = torch.cat([state["pos"], state["valid"][..., None].to(dtype)], dim=-1)
        lo, hi = halo_planes(group, packed, box_size)
        return spheres_block(lo, packed, hi, box_size, empty)

    def forces_local(state):
        pos_e, valid_e, box = extended(state)
        f = row_hertzian_forces(pos_e, valid_e, box, radius, youngs, poisson)
        ny = state["pos"].shape[0]
        return f[1:1 + ny, 1:1 + nzl]

    def inner_step(state):
        pos, valid = state["pos"], state["valid"]
        vel = inv_drag * forces_local(state)
        if diffusion > 0:
            # each rank draws only its own entities' gid-keyed streams
            bz = brownian_velocity_keyed(state["key"], state["step"], state["gid"],
                                         diffusion, dt, dtype=dtype)
            vel = vel + torch.where(valid[..., None], bz, 0.0)
        new_pos = metric.wrap(pos + dt_t * vel)
        new_pos = torch.where(valid[..., None], new_pos, pos)
        return {**state, "pos": new_pos, "step": state["step"] + 1}

    def rebuild_global(state):
        flat = flat_by_gid(group, state["pos"], state["valid"], state["gid"], n_total)
        rows = build_rows(flat, gids, grid)
        new_pos = rows.pos[:, z0:z0 + nzl].contiguous()
        return {**state, "pos": new_pos, "valid": rows.valid[:, z0:z0 + nzl].contiguous(),
                "gid": rows.gid[:, z0:z0 + nzl].contiguous(), "ref_pos": new_pos,
                "overflow": state["overflow"] | rows.overflow,
                "rebuilds": state["rebuilds"] + 1}

    def rebuild_local(state):
        new_pos, new_val, new_gid, _, ovf = slab_local_resort(
            group, state["pos"], state["valid"], state["gid"], grid, nzl,
            ovf=state["overflow"])
        return {**state, "pos": new_pos, "valid": new_val, "gid": new_gid,
                "ref_pos": new_pos, "overflow": ovf, "rebuilds": state["rebuilds"] + 1}

    rebuild = rebuild_local if rebuild_mode == "local" else rebuild_global

    def init(pos, key_words, step0: int = 0) -> dict:
        """This rank's state from the full (N, 3) positions (every rank
        passes the same), the run's two key words and the global step, so
        the noise streams continue the single-device run's."""
        pos = torch.as_tensor(pos, dtype=dtype, device=dev)
        rows = build_rows(pos, gids, grid)
        p = rows.pos[:, z0:z0 + nzl].contiguous()
        return {"pos": p, "valid": rows.valid[:, z0:z0 + nzl].contiguous(),
                "gid": rows.gid[:, z0:z0 + nzl].contiguous(), "ref_pos": p,
                "overflow": rows.overflow, "key": tuple(int(k) for k in key_words),
                "step": int(step0), "rebuilds": 0}

    def step_block(state, n_steps: int) -> dict:
        return run_block(state, n_steps, rebuild, inner_step,
                         lambda s: skin_moved(group, metric, s, skin))

    return SlabEngine(init, step_block, grid, extended, rebuild_mode, nzl)
