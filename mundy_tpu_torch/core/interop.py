"""Carry state across from the JAX engines, given as numpy arrays.

Users and the parity tests start both engines from one state with these
functions: export the reference's arrays with numpy (`np.asarray`) and hand
them over. No JAX is imported here.
"""

from __future__ import annotations

import numpy as np
import torch

from mundy_tpu_torch.driver.apps.rods_rows import RowRodsState
from mundy_tpu_torch.driver.apps.spheres_rows import RowSpheresState
from mundy_tpu_torch.neighbor.cell_list import NeighborMatrix
from mundy_tpu_torch.neighbor.rows import RowGrid, RowState


def row_grid_from_numpy(origin, cell_yz, ny: int, nz: int, row_capacity: int,
                        dtype=torch.float64, device="cpu") -> RowGrid:
    """A RowGrid from the reference RowGrid's fields."""
    return RowGrid(
        origin=torch.as_tensor(np.array(origin), dtype=dtype, device=device),
        cell_yz=torch.as_tensor(np.array(cell_yz), dtype=dtype, device=device),
        ny=int(ny), nz=int(nz), row_capacity=int(row_capacity))


def _t(a, dtype=None, device="cpu"):
    return torch.as_tensor(np.array(a), dtype=dtype, device=device)


def _key(key) -> tuple:
    k0, k1 = (int(w) for w in np.asarray(key, dtype=np.uint32).reshape(-1))
    return k0, k1


def row_state_from_numpy(grid: RowGrid, pos, gid, valid, ref_pos, overflow,
                         device="cpu") -> RowState:
    """A RowState from the reference RowState's arrays: pos/ref_pos
    (ny, nz, R, 3) in the grid's dtype, gid (ny, nz, R) int, valid
    (ny, nz, R) bool, overflow the build's flag."""
    pos = _t(pos, device=device)
    if pos.dtype != grid.origin.dtype:
        raise TypeError(f"positions are {pos.dtype}, the grid {grid.origin.dtype}")
    return RowState(grid=grid, pos=pos, gid=_t(gid, torch.int32, device),
                    valid=_t(valid, torch.bool, device),
                    ref_pos=_t(ref_pos, device=device),
                    overflow=_t(bool(overflow), torch.bool, device))


def neighbor_matrix_from_numpy(idx, mask, overflow, device="cpu") -> NeighborMatrix:
    """A NeighborMatrix from the reference's idx (N, K), mask and flag."""
    return NeighborMatrix(idx=_t(idx, torch.int32, device), mask=_t(mask, torch.bool, device),
                          overflow=_t(bool(overflow), torch.bool, device))


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
    return RowSpheresState(rows=rows, key=_key(key), step=int(step),
                           rebuild_count=int(rebuild_count),
                           overflow=_t(bool(overflow), torch.bool, device))


def row_rods_state_from_numpy(grid: RowGrid, pos, gid, valid, ref_pos,
                              rows_overflow, quat, key, step, rebuild_count,
                              overflow, device="cpu") -> RowRodsState:
    """A RowRodsState from the reference RowRodsState's arrays: the row
    fields as for row_spheres_state_from_numpy, and quat, the (ny, nz, R, 4)
    orientation payload in the positions' dtype."""
    rows = row_state_from_numpy(grid, pos, gid, valid, ref_pos, rows_overflow, device)
    quat = _t(quat, device=device)
    if quat.dtype != rows.pos.dtype:
        raise TypeError(f"quaternions are {quat.dtype}, positions {rows.pos.dtype}")
    return RowRodsState(rows=rows, quat=quat, key=_key(key), step=int(step),
                        rebuild_count=int(rebuild_count),
                        overflow=_t(bool(overflow), torch.bool, device))
