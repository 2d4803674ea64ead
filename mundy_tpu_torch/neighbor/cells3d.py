"""Dense 3D-cell engine: wide-cutoff pairwise operators without a neighbor
matrix.

Port of mundy_tpu/neighbor/cells3d.py, the real-space engine of the
spectral-Ewald RPY mobility:

- particles live in a dense (nx, ny, nz, C) cell layout (cell edge >= the
  cutoff, sentinel-filled empty slots), built by one stable sort and one
  scatter;
- the candidates of a cell are its 27 neighbour cells, reached by
  `torch.roll` with the periodic image shift pre-applied per axis, so a pair
  needs no minimum image;
- a pair kernel runs on dense (C, 27 C) pair blocks, chunked over cell rows
  under a byte budget, with the sources' payload (forces) riding the same
  rolled planes.

The density split (`build_cells3d_split`, `pair_apply_cells3d_split`)
keeps the quadratic pass at a low base capacity and corrects the few dense
cells compactly. Its scatters with repeated targets use
`index_put_(accumulate=True)`, which on the card sums each target's terms
in index order (sorted, no atomics), so runs repeat bit for bit. This
engine is plain PyTorch: the reference runs it in XLA, outside any Pallas
kernel.
"""

from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch

from mundy_tpu_torch.core.containers import frozen_dataclass, static_field


@frozen_dataclass
class CellGrid3D:
    origin: torch.Tensor  # (3,)
    edge: torch.Tensor  # (3,) cell edge per axis
    nx: int = static_field(default=1)
    ny: int = static_field(default=1)
    nz: int = static_field(default=1)
    capacity: int = static_field(default=8)


@frozen_dataclass
class Cells3DState:
    grid: CellGrid3D
    pos: torch.Tensor  # (nx, ny, nz, C, 3) sentinel-filled
    perm: torch.Tensor  # (nx, ny, nz, C) int32 particle id per slot (n = empty)
    overflow: torch.Tensor  # () bool


def make_cell_grid3d(box_lengths, cutoff: float, n_particles: int,
                     capacity_slack: float = 1.15, dtype=torch.float32,
                     device=None) -> CellGrid3D:
    """Cells with edge >= cutoff on every axis; capacity from the
    Poisson-max estimate with slack (overflow flag on violation)."""
    L = np.asarray(box_lengths, np.float64)
    n = np.maximum((L // cutoff).astype(int), 1)
    occ = n_particles / int(n[0] * n[1] * n[2])
    cap = int(occ * capacity_slack + 6 * math.sqrt(occ + 4) + 4)
    cap = ((cap + 7) // 8) * 8
    return CellGrid3D(origin=torch.zeros(3, dtype=dtype, device=device),
                      edge=torch.as_tensor(L / n, dtype=dtype, device=device),
                      nx=int(n[0]), ny=int(n[1]), nz=int(n[2]), capacity=cap)


def _sort_cells(pos: torch.Tensor, grid: CellGrid3D):
    """(order, sorted cell ids, rank within the cell, counts per cell)."""
    n = pos.shape[0]
    dev = pos.device
    dims = torch.as_tensor([grid.nx, grid.ny, grid.nz], dtype=torch.int64, device=dev)
    ic = ((pos - grid.origin) / grid.edge).to(torch.int32).to(torch.int64)
    ic = torch.minimum(torch.clamp(ic, min=0), dims - 1)
    cell = (ic[:, 0] * grid.ny + ic[:, 1]) * grid.nz + ic[:, 2]
    order = torch.argsort(cell, stable=True)
    cell_s = cell[order]
    first = torch.ones(n, dtype=torch.bool, device=dev)
    first[1:] = cell_s[1:] != cell_s[:-1]
    ar = torch.arange(n, device=dev)
    rank = ar - torch.cummax(torch.where(first, ar, 0), dim=0).values
    counts = torch.bincount(cell, minlength=grid.nx * grid.ny * grid.nz)
    return order, cell_s, rank, counts


def _sentinel_y(grid: CellGrid3D) -> torch.Tensor:
    """Empty slots sit ~1e6 boxes away in y: beyond every cutoff against
    real particles (sentinel-sentinel pairs carry zero payload)."""
    return grid.origin[1] - 1e6 * (grid.edge[1] * grid.ny + 1.0)


def _base_layout(pos, grid, order, cell_s, rank):
    n = pos.shape[0]
    C = grid.capacity
    n_slots = grid.nx * grid.ny * grid.nz * C
    slot = torch.where(rank < C, cell_s * C + torch.clamp(rank, max=C - 1), n_slots)
    flat_pos = pos.new_zeros((n_slots + 1, 3))
    flat_pos[:, 1] = _sentinel_y(grid).to(pos.dtype)
    flat_pos[slot] = pos[order]  # index n_slots is the dump
    flat_perm = torch.full((n_slots + 1,), n, dtype=torch.int32, device=pos.device)
    flat_perm[slot] = order.to(torch.int32)
    shape = (grid.nx, grid.ny, grid.nz, C)
    return flat_pos[:n_slots].reshape(shape + (3,)), flat_perm[:n_slots].reshape(shape)


def build_cells3d(pos: torch.Tensor, grid: CellGrid3D) -> Cells3DState:
    """Flat (N, 3) positions -> dense 3D cell layout (one sort + scatter);
    particles past a cell's capacity are dropped and flag overflow."""
    order, cell_s, rank, counts = _sort_cells(pos, grid)
    p, perm = _base_layout(pos, grid, order, cell_s, rank)
    return Cells3DState(grid=grid, pos=p, perm=perm,
                        overflow=(counts > grid.capacity).any())


def _axis_shift(n: int, d: int, L: float, dtype, device) -> torch.Tensor:
    idx = np.arange(n)
    s = np.where(idx + d >= n, L, np.where(idx + d < 0, -L, 0.0))
    return torch.as_tensor(s, dtype=dtype, device=device)


def pair_apply_cells3d(state: Cells3DState, box_lengths, payload: torch.Tensor,
                       kernel: Callable, out_dim: int,
                       hbm_budget_bytes: float = 2.0e9, x_range=None) -> torch.Tensor:
    """Dense pairwise reduction over the 27-cell neighbourhood.

    kernel(DX, DY, DZ, r2, pj) with pair blocks (rows, nz, C, 27C) and
    payload pj (rows, nz, 27C, D) returns the reduced (rows, nz, C,
    out_dim). The kernel must vanish beyond the grid cutoff and for zero
    payload (empty slots carry payload 0, which the caller ensures).
    Self-pairs (sep = 0, own payload) are included. Returns (nx, ny, nz, C,
    out_dim).

    `x_range = (x0, nxl)`: evaluate only the x-slab of cells [x0, x0 + nxl)
    as targets, against candidates from the whole periodic grid, with the
    same pair blocks in the same order (the sharded real space,
    parallel/spectral_shard.py). Returns (nxl, ny, nz, C, out_dim)."""
    pos = state.pos
    nx, ny, nz, C = pos.shape[:4]
    dtype, dev = pos.dtype, pos.device
    L = tuple(float(v) for v in box_lengths)
    if nx < 3 or ny < 3 or nz < 3:
        raise ValueError("pair_apply_cells3d needs >= 3 cells per axis")
    D = payload.shape[-1]
    x0, nx_out = (0, nx) if x_range is None else (int(x_range[0]), int(x_range[1]))
    if not (0 <= x0 and nx_out >= 1 and x0 + nx_out <= nx):
        raise ValueError(f"x_range ({x0}, {nx_out}) outside the grid's {nx} x-cells")
    xs = slice(x0, x0 + nx_out)
    cx, cy, cz, cf = [], [], [], []
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dz in (-1, 0, 1):
                if (dx, dy, dz) == (0, 0, 0):
                    cp, cpay = pos, payload
                else:
                    cp = torch.roll(pos, (-dx, -dy, -dz), dims=(0, 1, 2))
                    cpay = torch.roll(payload, (-dx, -dy, -dz), dims=(0, 1, 2))
                x, y, z = cp[..., 0], cp[..., 1], cp[..., 2]
                if dx != 0:
                    x = x + _axis_shift(nx, dx, L[0], dtype, dev)[:, None, None, None]
                if dy != 0:
                    y = y + _axis_shift(ny, dy, L[1], dtype, dev)[None, :, None, None]
                if dz != 0:
                    z = z + _axis_shift(nz, dz, L[2], dtype, dev)[None, None, :, None]
                cx.append(x[xs])
                cy.append(y[xs])
                cz.append(z[xs])
                cf.append(cpay[xs])
    rows = nx_out * ny
    cx = torch.cat(cx, dim=-1).reshape(rows, nz, 27 * C)
    cy = torch.cat(cy, dim=-1).reshape(rows, nz, 27 * C)
    cz = torch.cat(cz, dim=-1).reshape(rows, nz, 27 * C)
    cf = torch.cat(cf, dim=-2).reshape(rows, nz, 27 * C, D)
    ox = pos[xs, ..., 0].reshape(rows, nz, C)
    oy = pos[xs, ..., 1].reshape(rows, nz, C)
    oz = pos[xs, ..., 2].reshape(rows, nz, C)
    bytes_per_row = (8 + 2 * D) * nz * C * 27 * C * pos.element_size()
    cr = max(1, int(hbm_budget_bytes // max(bytes_per_row, 1)))
    out = []
    for r0 in range(0, rows, cr):
        s = slice(r0, r0 + cr)
        DX = cx[s][..., None, :] - ox[s][..., :, None]  # (rows, nz, C, 27C)
        DY = cy[s][..., None, :] - oy[s][..., :, None]
        DZ = cz[s][..., None, :] - oz[s][..., :, None]
        r2 = DX * DX + DY * DY + DZ * DZ
        out.append(kernel(DX, DY, DZ, r2, cf[s]))
        del DX, DY, DZ, r2
    return torch.cat(out).reshape(nx_out, ny, nz, C, out_dim)


def scatter_to_flat(state: Cells3DState, values: torch.Tensor, n: int) -> torch.Tensor:
    """(nx, ny, nz, C, D) slot values -> flat (n, D) by particle id."""
    D = values.shape[-1]
    out = values.new_zeros((n + 1, D))
    out[torch.clamp(state.perm.reshape(-1), max=n).long()] = values.reshape(-1, D)
    return out[:n]  # row n collected the empty slots


def gather_from_flat(state: Cells3DState, values: torch.Tensor) -> torch.Tensor:
    """Flat (n, D) -> (nx, ny, nz, C, D) slot layout (zero on empty)."""
    n = values.shape[0]
    perm = state.perm.reshape(-1)
    v = values[torch.clamp(perm, max=n - 1).long()]
    v = torch.where((perm < n)[:, None], v, 0.0)
    return v.reshape(state.perm.shape + (values.shape[-1],))


@frozen_dataclass
class CellsSplitState:
    """build_cells3d_split result: base grid + compact dense-cell excess."""

    base: Cells3DState  # capacity C_lo; ranks >= C_lo are NOT an overflow
    xs_pos: torch.Tensor  # (DC, CE, 3) excess positions (sentinel on empty)
    xs_perm: torch.Tensor  # (DC, CE) particle id per excess slot (n = empty)
    dc_cell: torch.Tensor  # (DC,) flat cell id of each dense cell (n_cells = pad)
    dense_of: torch.Tensor  # (n_cells,) dense slot of a cell (DC = not dense)
    overflow: torch.Tensor  # () bool: dense cells > DC or a cell > C_lo + CE


def build_cells3d_split(pos: torch.Tensor, grid: CellGrid3D, c_ex: int,
                        dc_cap: int) -> CellsSplitState:
    """Flat (N, 3) -> base cells at grid.capacity (= C_lo) + compact excess:
    particles with in-cell rank >= C_lo land in per-dense-cell slots (dense
    cell = count > C_lo; at most dc_cap of them, each with c_ex excess
    slots). One sort + three scatters."""
    n = pos.shape[0]
    dev = pos.device
    C = grid.capacity
    n_cells = grid.nx * grid.ny * grid.nz
    order, cell_s, rank, counts = _sort_cells(pos, grid)
    dense = counts > C
    dcum = torch.cumsum(dense.to(torch.int64), dim=0)
    n_dense = dcum[n_cells - 1]
    dense_of = torch.where(dense, torch.clamp(dcum - 1, max=dc_cap), dc_cap)
    dc_cell = torch.full((dc_cap + 1,), n_cells, dtype=torch.int32, device=dev)
    dc_cell[dense_of] = torch.arange(n_cells, dtype=torch.int32, device=dev)
    overflow = (n_dense > dc_cap) | (counts > C + c_ex).any()

    p, perm = _base_layout(pos, grid, order, cell_s, rank)
    base = Cells3DState(grid=grid, pos=p, perm=perm,
                        overflow=torch.zeros((), dtype=torch.bool, device=dev))

    d_of = dense_of[cell_s]
    xrank = rank - C
    xslot = torch.where((rank >= C) & (xrank < c_ex) & (d_of < dc_cap),
                        d_of * c_ex + xrank, dc_cap * c_ex)
    xs_pos = pos.new_zeros((dc_cap * c_ex + 1, 3))
    xs_pos[:, 1] = _sentinel_y(grid).to(pos.dtype)
    xs_pos[xslot] = pos[order]
    xs_perm = torch.full((dc_cap * c_ex + 1,), n, dtype=torch.int32, device=dev)
    xs_perm[xslot] = order.to(torch.int32)
    return CellsSplitState(base=base, xs_pos=xs_pos[:dc_cap * c_ex].reshape(dc_cap, c_ex, 3),
                           xs_perm=xs_perm[:dc_cap * c_ex].reshape(dc_cap, c_ex),
                           dc_cell=dc_cell[:dc_cap], dense_of=dense_of.to(torch.int32),
                           overflow=overflow)


def pair_apply_cells3d_split(split: CellsSplitState, box_lengths, forces: torch.Tensor,
                             kernel: Callable, out_dim: int,
                             hbm_budget_bytes: float = 2.0e9,
                             dc_chunk: int = 128) -> torch.Tensor:
    """Full pairwise sum (pair_apply_cells3d's kernel contract) as base x
    base (the dense pass at C_lo) plus compact dense-cell passes. Ordered
    pairs partition by (target class, source class): A base <- base on the
    grid; C'/D' excess <- (base + excess) and B' base <- excess over each
    dense cell's 27-neighbourhood. Every self pair appears once. Returns
    flat (n, out_dim)."""
    base = split.base
    nx, ny, nz, C = base.perm.shape
    n_cells = nx * ny * nz
    n, D = forces.shape
    dtype, dev = base.pos.dtype, base.pos.device
    L = tuple(float(v) for v in box_lengths)
    DC, CE = split.xs_perm.shape

    payload = gather_from_flat(base, forces)
    uA = pair_apply_cells3d(base, box_lengths, payload, kernel, out_dim, hbm_budget_bytes)
    out = forces.new_zeros((n + 1, out_dim))
    flat_perm = base.perm.reshape(-1)
    out[torch.clamp(flat_perm, max=n).long()] = uA.reshape(-1, out_dim)  # ids unique

    # neighbourhoods of the dense cells, with their periodic image shifts
    ci = torch.clamp(split.dc_cell, max=n_cells - 1).long()
    cxi, cyi, czi = ci // (ny * nz), (ci // nz) % ny, ci % nz
    noff, shifts = [], []
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dz in (-1, 0, 1):
                noff.append((((cxi + dx) % nx) * ny + (cyi + dy) % ny) * nz + (czi + dz) % nz)
                sh = [((c + d >= nn).to(dtype) - (c + d < 0).to(dtype)) * length
                      for c, d, nn, length in ((cxi, dx, nx, L[0]), (cyi, dy, ny, L[1]),
                                               (czi, dz, nz, L[2]))]
                shifts.append(torch.stack(sh, -1))
    ncell = torch.stack(noff, dim=1)  # (DC, 27)
    shift = torch.stack(shifts, dim=1)  # (DC, 27, 3)

    bpos = base.pos.reshape(n_cells, C, 3)
    bpay = payload.reshape(n_cells, C, D)
    bperm = base.perm.reshape(n_cells, C)
    cand_pos = bpos[ncell] + shift[:, :, None, :]  # (DC, 27, C, 3)
    cand_pay = bpay[ncell]
    xs_pay = torch.where((split.xs_perm < n)[..., None],
                         forces[torch.clamp(split.xs_perm, max=n - 1).long()], 0.0)
    pad_pos = torch.zeros((1, CE, 3), dtype=dtype, device=dev)
    pad_pos[..., 1] = -1e6 * (L[1] + 1.0)
    xs_pos_p = torch.cat([split.xs_pos, pad_pos])  # (DC + 1, CE, 3)
    xs_pay_p = torch.cat([xs_pay, xs_pay.new_zeros((1, CE, D))])
    nd = split.dense_of[ncell].long()  # (DC, 27), DC = not dense
    xcand_pos = xs_pos_p[nd] + shift[:, :, None, :]  # (DC, 27, CE, 3)
    xcand_pay = xs_pay_p[nd]

    def pair_block(tgt, cpos, cpay):
        # tgt (b, T, 3), cpos (b, S, 3), cpay (b, S, D) -> (b, T, out_dim)
        DX = cpos[..., None, :, 0] - tgt[..., :, None, 0]
        DY = cpos[..., None, :, 1] - tgt[..., :, None, 1]
        DZ = cpos[..., None, :, 2] - tgt[..., :, None, 2]
        r2 = DX * DX + DY * DY + DZ * DZ
        return kernel(DX, DY, DZ, r2, cpay)

    def chunked(fn, *args):
        return torch.cat([fn(*(a[s:s + dc_chunk] for a in args))
                          for s in range(0, DC, dc_chunk)])

    # C' + D': excess targets <- all 27-neighbourhood sources
    cpos_all = torch.cat([cand_pos.reshape(DC, 27 * C, 3),
                          xcand_pos.reshape(DC, 27 * CE, 3)], dim=1)
    cpay_all = torch.cat([cand_pay.reshape(DC, 27 * C, D),
                          xcand_pay.reshape(DC, 27 * CE, D)], dim=1)
    uX = chunked(pair_block, split.xs_pos, cpos_all, cpay_all)  # (DC, CE, out)
    out[torch.clamp(split.xs_perm.reshape(-1), max=n).long()] += uX.reshape(-1, out_dim)

    # B': neighbourhood base targets <- this dense cell's excess sources, in
    # the dense cell's frame (targets image-shifted, sources as stored)
    uB = chunked(lambda t, s, p: pair_block(t.reshape(t.shape[0], 27 * C, 3), s, p),
                 cand_pos, split.xs_pos, xs_pay)  # (DC, 27C, out)
    # each empty target slot gets a dump row of its own: one shared dump row
    # would be one index repeated ~DC 27 C times, which the sorted
    # accumulation walks serially
    tgt = bperm[ncell].reshape(-1).long()
    dump = n + 1 + torch.arange(tgt.shape[0], device=dev)
    out = torch.cat([out, out.new_zeros((tgt.shape[0], out_dim))])
    out.index_put_((torch.where(tgt < n, tgt, dump),), uB.reshape(-1, out_dim),
                   accumulate=True)
    return out[:n]
