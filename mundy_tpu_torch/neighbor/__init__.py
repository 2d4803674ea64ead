"""Neighbor search: the dense cell list and the row-grid engine."""

from mundy_tpu_torch.neighbor.cell_list import (
    CellGrid,
    CellList,
    NeighborMatrix,
    PairList,
    build_cell_list,
    build_pair_list,
    build_pair_list_ordered,
    make_cell_grid,
    neighbor_candidates,
    neighbor_matrix,
)

__all__ = [
    "CellGrid",
    "CellList",
    "NeighborMatrix",
    "PairList",
    "build_cell_list",
    "build_pair_list",
    "build_pair_list_ordered",
    "make_cell_grid",
    "neighbor_candidates",
    "neighbor_matrix",
]
