"""Dense cell-list broad phase and the pair-list formats.

Port of mundy_tpu/neighbor/cell_list.py (the parts the LCP spheres and
chromatin lines run): bin particles into a dense (ncells, capacity) table
with one stable sort, gather the 27-cell stencil per particle in chunks,
keep the first K in-cutoff candidates in stencil order (for all bodies, or
for a subset by global id: `neighbor_matrix_query`), gather the raw
stencil of a few query points (`neighbor_candidates`), and compact a
neighbor matrix into the unique i < j pair list of the granular app or the
i-sorted ordered pair list of the constraint pipeline. Shapes and
capacities are python ints; overflow is a 0-d bool tensor the host reads
between blocks.

The scatters that JAX runs with mode="drop" write into one extra dump slot
that is cut off afterwards, as in neighbor/rows.py.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from mundy_tpu_torch.core.containers import frozen_dataclass, static_field
from mundy_tpu_torch.geom.periodicity import Metric


@frozen_dataclass
class CellGrid:
    """Static grid geometry."""

    origin: torch.Tensor  # (3,) lower corner of the binned domain
    cell_size: torch.Tensor  # (3,) cell edge lengths
    dims: tuple = static_field(default=(1, 1, 1))  # (nx, ny, nz)
    periodic: tuple = static_field(default=(False, False, False))


@frozen_dataclass
class CellList:
    """Dense bucketed cells: entries[c, k] = particle index or -1."""

    grid: CellGrid
    entries: torch.Tensor  # (ncells, cell_capacity) int32
    counts: torch.Tensor  # (ncells,) int32
    cell_of: torch.Tensor  # (N,) int64 cell index per particle
    overflow: torch.Tensor  # () bool, some cell exceeded capacity


class NeighborMatrix(NamedTuple):
    """Per-particle dense neighbor ids (the force-kernel format)."""

    idx: torch.Tensor  # (N, K) int32 neighbor ids, N marks empty slots
    mask: torch.Tensor  # (N, K) bool
    overflow: torch.Tensor  # () bool, a particle had more than K neighbors


class PairList(NamedTuple):
    """Compacted pairs (the constraint-assembly format)."""

    i: torch.Tensor  # (C,) int32
    j: torch.Tensor  # (C,) int32
    mask: torch.Tensor  # (C,) bool
    num_pairs: torch.Tensor  # () int32
    overflow: torch.Tensor  # () bool, more than C pairs found


def make_cell_grid(domain_low, domain_high, min_cell_size: float,
                   periodic=(False, False, False), dtype=torch.float32,
                   device=None) -> CellGrid:
    """As many cells as fit with edge >= min_cell_size (>= the largest pair
    cutoff, so all neighbors of a particle live in its 27 cells)."""
    low = np.asarray(domain_low, dtype=np.float64)
    high = np.asarray(domain_high, dtype=np.float64)
    extent = high - low
    dims = np.maximum(np.floor(extent / min_cell_size).astype(int), 1)
    cell = extent / dims
    return CellGrid(
        origin=torch.as_tensor(low, dtype=dtype, device=device),
        cell_size=torch.as_tensor(cell, dtype=dtype, device=device),
        dims=tuple(int(d) for d in dims),
        periodic=tuple(bool(p) for p in periodic),
    )


def _cell_coords(grid: CellGrid, pos: torch.Tensor) -> torch.Tensor:
    """Integer cell coords of each position, wrapped (periodic axes) or
    clamped into the grid."""
    rel = (pos - grid.origin) / grid.cell_size
    c = torch.floor(rel).to(torch.int64)
    dims = torch.as_tensor(grid.dims, dtype=torch.int64, device=pos.device)
    per = torch.as_tensor(grid.periodic, dtype=torch.bool, device=pos.device)
    wrapped = torch.remainder(c, dims)
    clamped = torch.minimum(torch.clamp(c, min=0), dims - 1)
    return torch.where(per, wrapped, clamped)


def _linear_cell(grid: CellGrid, c: torch.Tensor) -> torch.Tensor:
    nx, ny, _nz = grid.dims
    return c[..., 0] + nx * (c[..., 1] + ny * c[..., 2])


def build_cell_list(pos: torch.Tensor, grid: CellGrid, cell_capacity: int,
                    valid: Optional[torch.Tensor] = None) -> CellList:
    """Bin particles into the dense (ncells, capacity) table: one stable sort
    by cell id, within-cell rank by a running-max segment trick, one
    scatter. Particles past a cell's capacity are dropped and flag
    overflow. Rows with valid=False (the padded slots of a capacity-bounded
    buffer) go to cell `ncells`: they enter no cell and no count."""
    n = pos.shape[0]
    dev = pos.device
    ncells = int(np.prod(grid.dims))
    cell_of = _linear_cell(grid, _cell_coords(grid, pos))
    if valid is not None:
        cell_of = torch.where(valid, cell_of, ncells)

    order = torch.argsort(cell_of, stable=True)
    sorted_cells = cell_of[order]
    first_of_run = torch.zeros(n, dtype=torch.bool, device=dev)
    first_of_run[1:] = sorted_cells[1:] != sorted_cells[:-1]
    ar = torch.arange(n, device=dev)
    start_of_cell = torch.cummax(torch.where(first_of_run, ar, 0), dim=0).values
    rank = ar - start_of_cell

    # bin ncells holds the dropped rows and is cut off
    counts = torch.bincount(cell_of, minlength=ncells + 1)[:ncells].to(torch.int32)
    overflow = (counts > cell_capacity).any()

    dump = ncells * cell_capacity
    keep = (rank < cell_capacity) & (sorted_cells < ncells)
    slot = torch.where(keep, sorted_cells * cell_capacity + rank, dump)
    entries = torch.full((dump + 1,), -1, dtype=torch.int32, device=dev)
    entries[slot] = order.to(torch.int32)
    return CellList(grid=grid, entries=entries[:dump].reshape(ncells, cell_capacity),
                    counts=counts, cell_of=cell_of, overflow=overflow)


def _neighbor_cells_of(grid: CellGrid, coords: torch.Tensor):
    """For cell coords (..., 3): (27 linear ids, validity) with wrap/clamp."""
    offs = torch.as_tensor(
        [(dx, dy, dz) for dx in (-1, 0, 1) for dy in (-1, 0, 1) for dz in (-1, 0, 1)],
        dtype=torch.int64, device=coords.device)
    nb = coords[..., None, :] + offs  # (..., 27, 3)
    dims = torch.as_tensor(grid.dims, dtype=torch.int64, device=coords.device)
    per = torch.as_tensor(grid.periodic, dtype=torch.bool, device=coords.device)
    in_range = (nb >= 0) & (nb < dims)
    valid = (in_range | per).all(dim=-1)
    nb = torch.where(per, torch.remainder(nb, dims),
                     torch.minimum(torch.clamp(nb, min=0), dims - 1))
    return _linear_cell(grid, nb), valid


def _compact_rows(cand: torch.Tensor, ok: torch.Tensor, k: int, empty_marker: int):
    """First-k hits of each row in candidate order -> (idx, mask, count)."""
    rows, ncand = cand.shape
    c = torch.cumsum(ok.to(torch.int32), dim=1)
    count = c[:, -1]
    targets = torch.arange(1, k + 1, dtype=torch.int32, device=cand.device)[None, :]
    lo = torch.zeros((rows, k), dtype=torch.int64, device=cand.device)
    hi = torch.full((rows, k), ncand, dtype=torch.int64, device=cand.device)
    for _ in range(max(1, int(np.ceil(np.log2(ncand))))):
        mid = (lo + hi) >> 1
        ge = torch.gather(c, 1, torch.clamp(mid, max=ncand - 1)) >= targets
        hi = torch.where(ge, mid, hi)
        lo = torch.where(ge, lo, mid + 1)
    found = targets <= count[:, None]
    idx = torch.gather(cand, 1, torch.clamp(lo, max=ncand - 1))
    return torch.where(found, idx, empty_marker), found, count


def neighbor_candidates(query_pos: torch.Tensor, clist: CellList) -> torch.Tensor:
    """(Q, 27 cap) int32 candidate ids (-1 = empty) around each query
    position: the raw 27-cell stencil, no distance filter, no compaction.
    Every body within one cell edge of a query is present; the caller
    filters by distance (the KMC candidate search queries only the
    crosslinker homes, Q << N)."""
    q = query_pos.shape[0]
    cap = clist.entries.shape[1]
    cells27, valid27 = _neighbor_cells_of(clist.grid, _cell_coords(clist.grid, query_pos))
    cand = torch.where(valid27[..., None], clist.entries[cells27], -1)  # (Q, 27, cap)
    return cand.reshape(q, 27 * cap)


def neighbor_matrix(pos: torch.Tensor, clist: CellList, search_radius,
                    metric: Optional[Metric] = None, max_neighbors: int = 32,
                    chunk: int = 4096,
                    exclude: Optional[torch.Tensor] = None) -> NeighborMatrix:
    """Per-particle neighbor ids within search_radius_i + search_radius_j
    (self-pairs dropped), the first max_neighbors in 27-cell stencil order.
    `exclude` is an optional (N, E) int table of particle ids to drop (the
    reference's ExcludeConnectedEntities filter; -1 excludes nothing).
    Chunked over particles so the (chunk, 27 cap) candidate table stays
    small. Every body queried: neighbor_matrix_query with gid = arange(N)."""
    n = pos.shape[0]
    gid = torch.arange(n, dtype=torch.int32, device=pos.device)
    return neighbor_matrix_query(pos, clist, pos, gid, search_radius, metric,
                                 max_neighbors, chunk, exclude)


def neighbor_matrix_query(pos_all: torch.Tensor, clist: CellList, query_pos: torch.Tensor,
                          query_gid: torch.Tensor, search_radius,
                          metric: Optional[Metric] = None, max_neighbors: int = 32,
                          chunk: int = 4096,
                          exclude: Optional[torch.Tensor] = None,
                          query_radius: Optional[torch.Tensor] = None) -> NeighborMatrix:
    """Neighbor rows for a subset of bodies: `query_pos` (Q, 3) with global
    ids `query_gid` (Q,) against the cell list built over `pos_all` (N, 3).
    `search_radius` is a scalar or (N,) per body; `exclude` an optional
    (Q, E) table of global ids to drop per query. The (Q, K) rows carry
    global ids and equal the matching rows of neighbor_matrix(pos_all, ...):
    the same candidate order, compaction and exclusions, so a rank can
    rebuild only its own rows. Padding queries carry gid -1 and find
    nothing. `query_radius` (Q,), when given, takes the place of
    `search_radius` (pass None there): the pair cutoff is twice each
    query's own radius, and a query whose radius is not positive finds
    nothing (the sharded spheres steps' contract: inactive slots carry a
    negative radius)."""
    n = pos_all.shape[0]
    q = query_pos.shape[0]
    dev = pos_all.device
    if query_radius is None:
        radius = torch.broadcast_to(torch.as_tensor(search_radius, dtype=pos_all.dtype,
                                                    device=dev), (n,))
    q_pad = ((q + chunk - 1) // chunk) * chunk
    qp = torch.cat([query_pos, query_pos.new_zeros((q_pad - q, 3))])
    qg = torch.cat([query_gid.to(torch.int32),
                    torch.full((q_pad - q,), -1, dtype=torch.int32, device=dev)])
    if exclude is not None:
        excl_p = torch.cat([exclude, exclude.new_full((q_pad - q, exclude.shape[1]), -1)])
    if query_radius is not None:
        qr = torch.cat([query_radius.to(pos_all.dtype), query_radius.new_zeros(q_pad - q)])
    coords_all = _cell_coords(clist.grid, qp)
    idx_parts, mask_parts, ovf = [], [], torch.zeros((), dtype=torch.bool, device=dev)
    for start in range(0, q_pad, chunk):
        sl = slice(start, start + chunk)
        p, me = qp[sl], qg[sl]
        cells27, valid27 = _neighbor_cells_of(clist.grid, coords_all[sl])
        cand = clist.entries[cells27]  # (chunk, 27, cap)
        cand = torch.where(valid27[..., None], cand, -1).reshape(chunk, -1)
        cand_idx = torch.clamp(cand, min=0).to(torch.int64)
        cand_pos = pos_all[cand_idx]
        if metric is None:
            sep = cand_pos - p[:, None, :]
        else:
            sep = metric.sep(p[:, None, :], cand_pos)
        d2 = (sep * sep).sum(-1)
        live = (me >= 0)[:, None]
        if query_radius is None:
            cutoff = radius[torch.clamp(me, min=0).to(torch.int64)][:, None] + radius[cand_idx]
        else:
            cutoff = 2.0 * qr[sl][:, None]
            live = live & (cutoff > 0)  # squaring would revive a negative radius
        ok = (cand >= 0) & (d2 <= cutoff * cutoff) & (cand != me[:, None]) & live
        if exclude is not None:
            ok &= (cand[:, :, None] != excl_p[sl][:, None, :]).all(dim=-1)
        row_idx, row_ok, count = _compact_rows(cand, ok, max_neighbors, n)
        idx_parts.append(row_idx)
        mask_parts.append(row_ok)
        ovf = ovf | (count > max_neighbors).any()
    idx = torch.cat(idx_parts)[:q].to(torch.int32)
    mask = torch.cat(mask_parts)[:q]
    return NeighborMatrix(idx=idx, mask=mask, overflow=ovf)


def build_pair_list(nmat: NeighborMatrix, capacity: int) -> PairList:
    """Unique (i < j) pairs of a neighbor matrix, compacted in row-major
    order into `capacity` slots. Padded slots carry i = j = 0 and
    mask=False; `num_pairs` counts every pair found, `overflow` flags more
    than `capacity` of them (the pairs past it are dropped)."""
    n, k = nmat.idx.shape
    dev = nmat.idx.device
    ii = torch.arange(n, dtype=torch.int32, device=dev)[:, None].expand(n, k).reshape(-1)
    jj = nmat.idx.reshape(-1).to(torch.int32)
    ok = nmat.mask.reshape(-1) & (ii < jj)
    num = ok.sum(dtype=torch.int32)
    slot = torch.cumsum(ok.to(torch.int32), dim=0) - 1
    dest = torch.where(ok & (slot < capacity), slot, capacity).to(torch.int64)
    i_out = torch.zeros(capacity + 1, dtype=torch.int32, device=dev)  # + the dump slot
    j_out = torch.zeros(capacity + 1, dtype=torch.int32, device=dev)
    mask_out = torch.zeros(capacity + 1, dtype=torch.bool, device=dev)
    i_out[dest] = ii
    j_out[dest] = jj
    mask_out[dest] = ok
    return PairList(i=i_out[:capacity], j=j_out[:capacity], mask=mask_out[:capacity],
                    num_pairs=num, overflow=num > capacity)


def build_pair_list_ordered(nmat: NeighborMatrix, capacity: int) -> PairList:
    """ALL ordered (i, j) neighbor entries of a front-packed neighbor matrix,
    sorted by i (row-major order), padded slots carrying i = j = N. Each
    contact appears twice, (i, j) and (j, i). No scatter: the row of slot p
    is found by a search over the rows' exclusive cumsum."""
    n, _k = nmat.idx.shape
    dev = nmat.idx.device
    cnt = nmat.mask.sum(dim=1, dtype=torch.int32)
    base = torch.cat([torch.zeros(1, dtype=torch.int32, device=dev),
                      torch.cumsum(cnt, dim=0, dtype=torch.int32)])
    num = base[n]
    pos_in = torch.arange(capacity, dtype=torch.int32, device=dev)
    valid = pos_in < num
    # row of slot p: the number of row ends <= p
    ii = torch.searchsorted(base[1:], pos_in, right=True).to(torch.int32)
    ii = torch.where(valid, ii, n)
    ii_safe = torch.clamp(ii, max=n - 1).to(torch.int64)
    lane = torch.where(valid, pos_in - base[ii_safe], 0).to(torch.int64)
    jj = torch.where(valid, nmat.idx[ii_safe, lane].to(torch.int32), n)
    return PairList(i=ii, j=jj, mask=valid, num_pairs=num, overflow=num > capacity)


def need_rebuild(pos: torch.Tensor, ref_pos: torch.Tensor, skin,
                 metric: Optional[Metric] = None) -> torch.Tensor:
    """() bool tensor: has any particle moved more than skin/2 since the
    list was built? With search radii inflated by `skin` the list stays
    valid until a displacement could close half the margin from each side.
    ref: objects_moved_too_much (HP1 driver `:1404-1427`)."""
    disp = pos - ref_pos if metric is None else metric.sep(ref_pos, pos)
    return torch.linalg.vector_norm(disp, dim=-1).max() > 0.5 * skin
