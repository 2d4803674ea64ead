"""Carry state across from the JAX engines, given as numpy arrays.

Users and the parity tests start both engines from one state with these
functions: export the reference's arrays with numpy (`np.asarray`) and hand
them over. No JAX is imported here.
"""

from __future__ import annotations

import numpy as np
import torch

from mundy_tpu_torch.driver.apps.spheres_rows import RowSpheresState
from mundy_tpu_torch.neighbor.rows import RowGrid, RowState


def row_grid_from_numpy(origin, cell_yz, ny: int, nz: int, row_capacity: int,
                        dtype=torch.float64, device="cpu") -> RowGrid:
    """A RowGrid from the reference RowGrid's fields."""
    return RowGrid(
        origin=torch.as_tensor(np.array(origin), dtype=dtype, device=device),
        cell_yz=torch.as_tensor(np.array(cell_yz), dtype=dtype, device=device),
        ny=int(ny), nz=int(nz), row_capacity=int(row_capacity))


def row_spheres_state_from_numpy(grid: RowGrid, pos, gid, valid, ref_pos,
                                 rows_overflow, key, step, rebuild_count,
                                 overflow, device="cpu") -> RowSpheresState:
    """A RowSpheresState from the reference RowSpheresState's arrays.

    pos/ref_pos: (ny, nz, R, 3); gid: (ny, nz, R) int; valid: (ny, nz, R)
    bool; rows_overflow: the last build's flag; key: the two uint32 words of
    the raw threefry key (`jax.random.key_data`); step and rebuild_count:
    ints; overflow: the state's sticky flag. The positions keep their numpy
    dtype, which must match the grid's."""

    def t(a, dtype=None):
        return torch.as_tensor(np.array(a), dtype=dtype, device=device)

    pos = t(pos)
    if pos.dtype != grid.origin.dtype:
        raise TypeError(f"positions are {pos.dtype}, the grid {grid.origin.dtype}")
    rows = RowState(grid=grid, pos=pos, gid=t(gid, torch.int32),
                    valid=t(valid, torch.bool), ref_pos=t(ref_pos),
                    overflow=t(bool(rows_overflow), torch.bool))
    k0, k1 = (int(w) for w in np.asarray(key, dtype=np.uint32).reshape(-1))
    return RowSpheresState(rows=rows, key=(k0, k1), step=int(step),
                           rebuild_count=int(rebuild_count),
                           overflow=t(bool(overflow), torch.bool))
