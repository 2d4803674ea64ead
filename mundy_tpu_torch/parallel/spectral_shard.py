"""Sharded spectral-Ewald RPY mobility: config #5's hydro over the ranks.

Port of mundy_tpu/parallel/spectral_shard.py over the ranks of a Group (one
process per rank; the reference's psum is `Group.psum`, its pmax
`Group.pmax`, its axis index `group.rank`). Bodies are split into flat index
blocks of N/d:

- wave space: each rank bins and spreads its own N/d bodies onto the full
  (G, G, G, 3) grid (kernel K5s on the 3D tiles; the plain dense trio on
  the (y, z) rows, as in the reference), one psum sums the grids, every rank
  runs the FFT mode product (`spectral._k_apply`, cuFFT on the card) and
  interpolates at its own bodies only (K5i on the inverse FFT's planar
  output, as the single-device path passes it);
- real space: every rank holds the all-gathered positions and forces,
  builds the same 3D cells and evaluates only its x-slab of cells
  (`pair_apply_cells3d(x_range=)`, the unsplit engine at the grid's
  capacity); slots of cells that belong to another rank's slab (the overlap
  where d does not divide nx) are masked, and one psum of the (N, 3) result
  follows;
- the binning and cell overflow flags are reduced by one pmax.
"""

from __future__ import annotations

from typing import Optional

import torch

from mundy_tpu_torch.mobility.ewald import rpy_real_cells_kernel
from mundy_tpu_torch.mobility.spectral import SpectralEwaldRPY, _k_apply
from mundy_tpu_torch.neighbor.cells3d import build_cells3d, gather_from_flat, pair_apply_cells3d
from mundy_tpu_torch.ops.kernels.se_grid import (
    SEGridTiles,
    se_bin_dense,
    se_bin_tiles,
    se_interp,
    se_interp_dense,
    se_spread,
    se_spread_dense,
)
from mundy_tpu_torch.parallel.comm import Group


def _all_gather_flat(group: Group, v: torch.Tensor) -> torch.Tensor:
    return torch.cat(group.all_gather(v))


def make_se_local_apply(group: Group, op: SpectralEwaldRPY, geom, cells_grid,
                        n_total: int, box_lengths):
    """This rank's spectral-Ewald RPY apply over `group`.

    Returns local_apply(pos_l, f_l, pos_all=None, f_all=None) -> (u_l,
    overflow): pos_l and f_l are this rank's (N/d, 3) block, bodies
    [rank N/d, (rank + 1) N/d) of the whole; pos_all and f_all the (N, 3)
    arrays of every rank when the caller holds them already (else they are
    all-gathered here). `geom` is the tile geometry (SEGridTiles) or the rows
    geometry, sized for a rank's block or more (ChromatinSim passes its
    geometry right-sized for the whole N, a safe bound for any subset);
    `cells_grid` the 3D-cell grid for the
    whole N. overflow is a 0-d bool, the same on every rank. Every rank must
    call it at the same step (it runs collectives)."""
    d = group.size
    if n_total % d != 0:
        raise ValueError(f"the sharded spectral apply needs N % ranks == 0 (N {n_total}, "
                         f"{d} ranks)")
    tiled = isinstance(geom, SEGridTiles)
    n_local = n_total // d
    nx = cells_grid.nx
    nxl = -(-nx // d)  # x-slab of cells per rank; the last slab overlaps its neighbour
    L = tuple(float(v) for v in box_lengths)
    kernel = rpy_real_cells_kernel(op.base)
    me = group.rank
    x0 = min(me * nxl, nx - nxl)
    own_lo, own_hi = me * nxl, min((me + 1) * nxl, nx)

    def local_apply(pos_l: torch.Tensor, f_l: torch.Tensor,
                    pos_all: Optional[torch.Tensor] = None,
                    f_all: Optional[torch.Tensor] = None):
        dtype, dev = pos_l.dtype, pos_l.device
        if pos_all is None:
            pos_all = _all_gather_flat(group, pos_l)
        if f_all is None:
            f_all = _all_gather_flat(group, f_l)
        # ---- wave space: own spread -> psum'd grid -> replicated FFT
        if tiled:
            pieces = se_bin_tiles(geom, pos_l, dtype)
            grid = se_spread(geom, pieces, f_l.contiguous())
        else:
            pieces = se_bin_dense(geom, pos_l, dtype)
            grid = se_spread_dense(geom, pieces, f_l)
        grid = group.psum(grid)
        ugrid = _k_apply(op, grid)  # the inverse FFT's planar layout, which K5i reads
        if tiled:
            uw = se_interp(geom, pieces, ugrid.to(dtype))
        else:
            uw = se_interp_dense(geom, pieces, n_local, ugrid.to(dtype))
        overflow = pieces[1]
        # ---- real space: replicated cells, this rank's x-slab as targets
        cells = build_cells3d(pos_all, cells_grid)
        overflow = overflow | cells.overflow
        payload = gather_from_flat(cells, f_all)
        u_slab = pair_apply_cells3d(cells, L, payload, kernel, 3, x_range=(x0, nxl))
        perm_slab = cells.perm[x0:x0 + nxl]
        cell_x = x0 + torch.arange(nxl, device=dev)[:, None, None, None]
        owned = (cell_x >= own_lo) & (cell_x < own_hi) & (perm_slab < n_total)
        tgt = torch.where(owned, perm_slab, n_total).reshape(-1).to(torch.int64)
        ur = torch.zeros((n_total + 1, 3), dtype=dtype, device=dev)
        ur[tgt] = u_slab.reshape(-1, 3)  # row n_total is the dump
        ur = group.psum(ur[:n_total])
        # the self pair (sep = 0) is the cells' self term: nothing to add
        u = ur[me * n_local:(me + 1) * n_local] + uw
        overflow = group.pmax(overflow.reshape(1).to(torch.int32))[0] > 0
        return u, overflow

    return local_apply


# the reference's shard_map wrapper of the local apply; over torch.distributed
# there is nothing to wrap, so its name binds the same function
make_sharded_se_rpy_apply = make_se_local_apply
