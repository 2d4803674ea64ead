"""Carry state across from the JAX engines, given as numpy arrays.

Users and the parity tests start both engines from one state with these
functions: export the reference's arrays with numpy (`np.asarray`) and hand
them over. Each app builds its own state beside its state class
(`*_state_from_numpy`) from these pieces. No JAX is imported here.
"""

from __future__ import annotations

import numpy as np
import torch

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


def key_words(key) -> tuple:
    """The two uint32 words of a raw threefry key (`jax.random.key_data`)
    as python ints."""
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


def slab_spheres_state_from_numpy(rank: int, size: int, pos, active, gid, flags,
                                  device="cpu") -> tuple:
    """This rank's (pos, active, gid, flags) of parallel.sharded_step's v2
    step from the reference's make_slab_spheres_step arrays: pos (d C, 3),
    active (d C,), gid (d C,), sharded over the mesh axis in rank order,
    and the overflow bitmask."""
    c = np.shape(pos)[0] // size
    sl = slice(rank * c, (rank + 1) * c)
    return (_t(np.asarray(pos)[sl], device=device),
            _t(np.asarray(active)[sl], torch.bool, device),
            _t(np.asarray(gid)[sl], torch.int32, device),
            _t(int(np.asarray(flags)), torch.int32, device))


def slab_lcp_state_from_numpy(rank: int, size: int, state: dict, mode: str,
                              device="cpu") -> dict:
    """This rank's state of parallel.slab_lcp from the reference engine's
    state dict (numpy arrays, `key` its raw key data): the rows (ny, nz, R,
    ...) cut into the rank's nz / d planes, gamma (d C,) into its C slots,
    its lcp_iters; `mode` the port engine's rebuild mode."""
    nzl = np.shape(state["pos"])[1] // size
    planes = slice(rank * nzl, (rank + 1) * nzl)
    c = np.shape(state["gamma"])[0] // size
    rows = {k: np.asarray(state[k])[:, planes] for k in ("pos", "valid", "gid", "ref_pos")}
    return {"pos": _t(rows["pos"], device=device),
            "valid": _t(rows["valid"], torch.bool, device),
            "gid": _t(rows["gid"], torch.int32, device),
            "ref_pos": _t(rows["ref_pos"], device=device),
            "gamma": _t(np.asarray(state["gamma"])[rank * c:(rank + 1) * c], device=device),
            "lcp_iters": int(np.asarray(state["lcp_iters"])[rank]), "iters": [],
            "overflow": _t(bool(np.asarray(state["overflow"])), torch.bool, device),
            "key": key_words(state["key"]), "step": 0, "rebuilds": 0, "mode": mode}
