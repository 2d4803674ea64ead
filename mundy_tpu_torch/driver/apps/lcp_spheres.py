"""BASELINE config #2: N spheres with LCP non-penetration constraints.

Port of mundy_tpu/driver/apps/lcp_spheres.py. Per step: constraints from
the skin-buffered ordered pair list (signed separation + normals at the
current positions), strided active-set compaction, matrix-free BBPGD with
warm-started multipliers, and an Euler step with the constraint velocities
plus Brownian drift. A skin trigger rebuilds the broad phase: the rows
engine with kernel K2 (ops/kernels/row_extract.py) when the box holds >= 5
cells per axis, else the cell list.

The mobility (`hydro`):
- "none": dry local drag, monodisperse or polydisperse (radii drawn as the
  reference draws them: numpy, seed + 777; per-body search radii in the
  broad phase, per-pair drag mobilities). BBPGD runs the banded Delassus
  apply; the force assembly runs kernel K3 (ops/kernels/seg_onehot.py)
  once per step, for the final velocity.
- "rpy_neighbors": RPY over the constraint neighbor matrix, with the
  overlap correction (mobility/rpy.py).
- "rpy_ewald": periodic RPY by the Ewald direct sum (mobility/ewald.py),
  r_cut = box / 4, its real part over a wide hydro neighbor matrix rebuilt
  with the broad phase.
- "rpy_spectral": periodic RPY by spectral Ewald (mobility/spectral.py):
  kernels K5s and K5i grid the wave part, the real part runs on the 3D
  cells, both rebinned once per step.
- "rpy_ring": dense all-pairs RPY (free separations, the overlap
  correction on), ring-rotated over the ranks of a parallel.comm.Group
  (parallel/ring_rpy.py); init Hilbert-orders the drawn positions so each
  rank's contiguous block is spatially local. The reference builds a mesh of
  every visible device and shards only the mobility; the port takes one
  rank unless given a group (`group=`, one process per rank), and then, as
  the reference, every rank holds the whole state (broad phase, pair list,
  active set, solve) and the mobility takes the rank's block of N / d
  bodies through the ring and all_gathers the (N, 3) velocities
  (num_spheres % ranks must be 0). The gathered velocities make every
  rank's positions the same bit for bit, and the host decisions that could
  still part the ranks are taken together: the BBPGD exit test
  (`PGDConfig.replicas`), the skin trigger and the overflow flag are pmaxes
  over the ranks, so no rank runs a ring apply that another skips.
In the RPY modes each BBPGD iteration applies D^T M D: the force assembly
through K3, the mobility, the separation rate.

The control flow is the reference's, step for step: before every step the
host reads the skin trigger and rebuilds when it fired, and the BBPGD loop
reads its exit condition once per iteration. The reference's jit
recompiles on a capacity change are plain capacity changes here; the
shrink hysteresis (two consecutive blocks) is kept exactly, because it
decides the trajectory; the between-block refit keeps one more spare slot
of rows_k than the reference (`_refit_broad`).

ref: `scrap/lcp_spheres/StkNgpLCP.cpp` main + time loop (SURVEY.md 3.1).
"""

from __future__ import annotations

import dataclasses
import math as _math
from typing import Optional

import numpy as np
import torch

from mundy_tpu_torch.constraints.collision import (
    active_pair_subset_strided,
    body_pair_starts,
    collision_setup_spheres,
    make_band_delassus_apply,
    pair_dual_slots,
    remap_gamma,
    resolve_collisions,
)
from mundy_tpu_torch.core.config import validate_config
from mundy_tpu_torch.core.containers import frozen_dataclass
from mundy_tpu_torch.driver.apps.spheres import polydisperse_radii
from mundy_tpu_torch.driver.regrow import grow_int, run_blocks
from mundy_tpu_torch.dynamics.brownian import brownian_velocity_keyed
from mundy_tpu_torch.dynamics.integrators import euler_step
from mundy_tpu_torch.geom.periodicity import periodic
from mundy_tpu_torch.io.telemetry import at_step, host_read, trace
from mundy_tpu_torch.mobility.ewald import build_ewald_rpy, ewald_rpy_apply
from mundy_tpu_torch.mobility.local_drag import local_drag_mobility
from mundy_tpu_torch.mobility.rpy import rpy_apply_neighbors
from mundy_tpu_torch.mobility.spectral import (
    build_spectral_ewald,
    make_se_geometry_tiles,
    se_bin_geom,
    se_rpy_apply_cells,
)
from mundy_tpu_torch.neighbor.cell_list import (
    build_cell_list,
    build_pair_list_ordered,
    make_cell_grid,
    neighbor_matrix,
)
from mundy_tpu_torch.neighbor.cells3d import build_cells3d, make_cell_grid3d
from mundy_tpu_torch.neighbor.rows import make_row_grid, neighbor_matrix_rows
from mundy_tpu_torch.ops.segments import segment_windows
from mundy_tpu_torch.parallel.comm import Group
from mundy_tpu_torch.parallel.ring_rpy import (
    hilbert_shard_permutation,
    make_replicated_ring_apply,
)

_DTYPES = {"float32": torch.float32, "float64": torch.float64}


def row_occupancy(pos: torch.Tensor, box_size: float, grid) -> torch.Tensor:
    """(ny * nz,) int32 count of the positions in each (y, z) row of `grid`,
    on the positions' device: y and z wrapped into [0, box_size], floor
    divided by the row cell edges, clamped into the grid. Bit-equal to numpy's
    `np.mod`, `//` and `np.bincount` chain in the positions' dtype (both
    divide floor as Python does). No host read: `torch.bincount` on CUDA
    reads its input's max on the host, integer `index_add_` does not."""
    cell_y, cell_z = grid.cell_yz.tolist()  # a host tensor: no device read
    p = torch.remainder(pos[:, 1:3], box_size)
    iy = torch.div(p[:, 0], cell_y, rounding_mode="floor").to(torch.int64)
    iz = torch.div(p[:, 1], cell_z, rounding_mode="floor").to(torch.int64)
    row = iy.clamp_(max=grid.ny - 1) * grid.nz + iz.clamp_(max=grid.nz - 1)
    occ = torch.zeros((grid.ny * grid.nz,), dtype=torch.int32, device=pos.device)
    return occ.index_add_(0, row, torch.ones_like(row, dtype=torch.int32))


@dataclasses.dataclass
class LCPSpheresConfig:
    """Validated config of the reference's LCPSpheresConfig, field for field."""

    num_spheres: int = 10_000
    box_size: float = 40.0
    radius: float = 0.5
    polydispersity: float = 0.0  # r_i = radius * (1 + U(-p, p)), hydro "none" only
    viscosity: float = 1.0
    diffusion_coeff: float = 0.0
    dt: float = 1e-3
    num_steps: int = 100
    # pairs within 2r + buffer become constraint candidates
    constraint_buffer: float = 0.2
    # each step's BBPGD runs on pairs with sep0 < margin (+ deepest overlap);
    # None -> 0.5 * min(constraint_buffer, 0.25)
    active_margin: Optional[float] = None
    max_allowable_overlap: float = 1e-5
    max_col_iterations: int = 10_000
    hydro: str = "none"  # "none" | "rpy_neighbors" | "rpy_ewald" | "rpy_spectral" | "rpy_ring"
    pair_capacity_per_body: int = 2
    max_neighbors: int = 32
    cell_capacity: int = 16
    chunk: int = 32768
    seed: int = 1234
    dtype: str = "float32"
    log_every: int = 10

    def __validate__(self):
        assert self.hydro in ("none", "rpy_neighbors", "rpy_ewald",
                              "rpy_spectral", "rpy_ring"), self.hydro
        assert self.num_spheres > 0 and self.dt > 0
        assert 0.0 <= self.polydispersity < 1.0
        if self.polydispersity > 0:
            assert self.hydro == "none", "the RPY hydro modes assume equal radii"


@frozen_dataclass
class LCPSpheresState:
    pos: torch.Tensor  # (N, 3)
    gamma: torch.Tensor  # (A,) active-set warm-start multipliers
    gamma_sel: torch.Tensor  # (A,) int32 full-list slot per active pair (C = pad)
    gamma_full: torch.Tensor  # (C,) rebuild-time snapshot for set-entry warm starts
    key: tuple  # the run's two uint32 key words (python ints)
    step: int
    nmat: object  # NeighborMatrix (skin-buffered)
    pairs: object  # PairList (skin-buffered constraint candidates)
    hydro_nmat: object  # NeighborMatrix of the hydro sum (rpy_ewald: wider; else nmat)
    seg_starts: torch.Tensor  # (nb,) first-pair index per body block
    dual_full: torch.Tensor  # (C,) full-list slot of each pair's (j, i) duplicate
    prev_cum: torch.Tensor  # (C,) last step's active cumsum; zeros = invalid
    ref_pos: torch.Tensor  # positions at the last rebuild
    rebuild_count: int
    lcp_iters: int  # last solve's iterations
    lcp_iters_max: int
    lcp_residual: torch.Tensor
    lcp_alpha: torch.Tensor  # last solve's BB step (next solve's alpha0)
    act_count: torch.Tensor  # () last step's active-pair count
    act_block_max: torch.Tensor  # () last step's max active pairs per block
    overflow: torch.Tensor  # () bool, sticky


class LCPSpheresSim:
    """Assembled LCP spheres simulation for LCPSpheresConfig on one device,
    or, in `rpy_ring` mode with a `group` of several ranks, on this rank of
    the group (its device)."""

    def __init__(self, config: LCPSpheresConfig, device="cuda", group: Optional[Group] = None):
        self.config = c = config
        validate_config(config)
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("LCPSpheresSim(device='cuda') needs a CUDA "
                               "device, and torch sees none")
        self.ring_apply = None
        self.group = None  # the ranks of a replicated rpy_ring run
        if c.hydro == "rpy_ring":
            group = group if group is not None else Group.single(self.device)
            if group.size > 1:
                self.group = group
            self.ring_apply = make_replicated_ring_apply(
                group, c.num_spheres, c.radius, c.viscosity, include_self=True,
                overlap_correction=True)
        self.dtype = _DTYPES[c.dtype]
        box = [c.box_size] * 3
        self.metric = periodic(box, dtype=self.dtype, device=self.device)
        kw = dict(dtype=self.dtype, device=self.device)
        self.radii = self.search_radii = None
        if c.polydispersity > 0:
            rr = polydisperse_radii(c)
            self.radii = torch.as_tensor(rr, **kw)
            self.search_radius = float(rr.max()) + 0.5 * c.constraint_buffer
            self.search_radii = self.radii + torch.tensor(0.5 * c.constraint_buffer, **kw)
            self.inv_drag = 1.0 / (6.0 * _math.pi * c.viscosity * self.radii)
        else:
            self.search_radius = c.radius + 0.5 * c.constraint_buffer
        self.grid = make_cell_grid([0, 0, 0], box, 2 * self.search_radius,
                                   (True,) * 3, self.dtype, device=self.device)
        self.pair_capacity = c.pair_capacity_per_body * c.num_spheres
        # 1024 bodies per assembly block; block b's active pairs live at the
        # strided slots [b*W, b*W + count_b), W right-sized at init()
        self.seg_block = 1024
        self.seg_window = max(2048, 8 * self.seg_block)
        self.active_margin = (c.active_margin if c.active_margin is not None
                              else 0.5 * min(c.constraint_buffer, 0.25))
        self.nb_blocks = -(-c.num_spheres // self.seg_block)
        self.act_window = 512
        # rows-broad-phase caps, grown by regrow() on overflow and right-sized
        # down by init() and _refit_broad()
        self.rows_k = 20
        self.rows_slack = 1.9
        self._broad_shrink_streak = 0
        self._act_shrink_streak = 0
        self.ewald = self.spectral = None
        if c.hydro == "rpy_spectral":
            # FFT wave sum + a real-space cutoff of a few spacings, the real
            # part on the dense 3D cells (no hydro neighbor matrix)
            self.spectral = build_spectral_ewald(c.box_size, c.radius, c.viscosity,
                                                 tol=1e-4, n_particles=c.num_spheres, **kw)
            self.se_geom = make_se_geometry_tiles(self.spectral, c.num_spheres)
            self.hydro_cells_grid = make_cell_grid3d(box, self.spectral.base.r_cut,
                                                     c.num_spheres, **kw)
        if c.hydro == "rpy_ewald":
            # the direct sum with r_cut ~ box/4 (balancing k-modes against
            # real-space pairs); its neighbor matrix is built beside the
            # tighter constraint search
            r_cut = 0.25 * c.box_size
            self.ewald = build_ewald_rpy(c.box_size, c.radius, c.viscosity,
                                         xi=3.0 / r_cut, r_cut=r_cut, tol=1e-4, **kw)
            self.hydro_search = 0.5 * r_cut
            self.hydro_grid = make_cell_grid([0, 0, 0], box, 2 * self.hydro_search,
                                             (True,) * 3, self.dtype, device=self.device)

    @property
    def act_capacity(self) -> int:
        """Total active-pair slots of the strided layout (nb blocks x W)."""
        return self.nb_blocks * self.act_window

    def _n_cells(self) -> int:
        return int(self.config.box_size // (2 * self.search_radius))

    def _pair_run_bound(self) -> int:
        """Max pairs per body: the broad phase's neighbor cap."""
        c = self.config
        return (min(c.max_neighbors, self.rows_k) if self._n_cells() >= 5
                else c.max_neighbors)

    def _radius(self) -> torch.Tensor:
        """The (N,) radii of a polydisperse system, else the 0-d radius."""
        if self.radii is not None:
            return self.radii
        return torch.tensor(self.config.radius, dtype=self.dtype, device=self.device)

    def _search_radii(self) -> torch.Tensor:
        """The cell-list search radius: per body, or the 0-d one."""
        if self.search_radii is not None:
            return self.search_radii
        return torch.tensor(self.search_radius, dtype=self.dtype, device=self.device)

    def _broad_phase(self, pos):
        c = self.config
        if self._n_cells() >= 5:
            nmat = neighbor_matrix_rows(
                pos, float(self.search_radius), (c.box_size,) * 3,
                max_neighbors=min(c.max_neighbors, self.rows_k),
                capacity_slack=self.rows_slack, search_radii=self.search_radii)
            clist_ovf = torch.zeros((), dtype=torch.bool, device=self.device)
        else:
            clist = build_cell_list(pos, self.grid, c.cell_capacity)
            nmat = neighbor_matrix(
                pos, clist, self._search_radii(),
                metric=self.metric, max_neighbors=c.max_neighbors,
                chunk=min(c.chunk, max(256, c.num_spheres)))
            clist_ovf = clist.overflow
        pairs = build_pair_list_ordered(nmat, self.pair_capacity)
        starts = body_pair_starts(nmat)
        seg = segment_windows(pairs.i, c.num_spheres, self.seg_block,
                              self.seg_window, body_starts=starts)
        # a missing dual (asymmetric pair list) overflows only for pairs that
        # can reach contact before the next rebuild: pairs within ~1 ulp of
        # the search radius round the cutoff test per direction
        setup_reb = collision_setup_spheres(pos, self._radius(), pairs,
                                            metric=self.metric)
        near = setup_reb.sep0 < torch.tensor(0.5 * c.constraint_buffer,
                                             dtype=self.dtype, device=self.device)
        dual_full, dual_missing = pair_dual_slots(pairs, starts, nmat, near=near)
        ovf = clist_ovf | nmat.overflow | pairs.overflow | seg.overflow | dual_missing
        hmat = nmat
        if self.ewald is not None:
            hcl = build_cell_list(pos, self.hydro_grid, 4 * c.cell_capacity)
            # a small chunk: the (chunk, 27 cap) candidates of the wide search
            hmat = neighbor_matrix(
                pos, hcl, torch.tensor(self.hydro_search, dtype=self.dtype,
                                       device=self.device),
                metric=self.metric, max_neighbors=8 * c.max_neighbors,
                chunk=min(4096, max(256, c.num_spheres)))
            ovf = ovf | hcl.overflow | hmat.overflow
        return nmat, pairs, hmat, seg.starts, dual_full, ovf

    def init(self, pos: Optional[torch.Tensor] = None,
             key_words: Optional[tuple] = None) -> LCPSpheresState:
        """Initial state, with the reference's right-sizing of the pair
        capacity, row slack, rows K, assembly window and active window. With
        no arguments the positions are drawn uniformly in the box from a
        torch.Generator seeded with config.seed and the key is (0, seed); in
        `rpy_ring` the drawn positions are Hilbert-ordered, as the reference
        orders its own. Pass `pos` (N, 3) and `key_words` to start from the
        reference's state (its positions, in their order, and the key words
        of its state key)."""
        c = self.config
        if pos is None:
            gen = torch.Generator(device=self.device).manual_seed(c.seed)
            pos = torch.rand((c.num_spheres, 3), generator=gen, dtype=self.dtype,
                             device=self.device) * c.box_size
            if self.ring_apply is not None:
                # the stk::balance role: Hilbert-order the drawn positions so
                # each rank's contiguous block of the ring is spatially local
                perm = hilbert_shard_permutation(pos, [0.0] * 3, [c.box_size] * 3)
                pos = pos[torch.as_tensor(perm, device=self.device)]
        if key_words is None:
            key_words = (0, c.seed & 0xFFFFFFFF)
        pos = torch.as_tensor(pos, dtype=self.dtype, device=self.device)
        nmat, pairs, hmat, seg_starts, dual_full, ovf = self._broad_phase(pos)
        # every BBPGD iteration streams the full capacity: right-size it to
        # 1.3x the measured candidate count (+margin)
        count = int(pairs.num_pairs)
        tight = ((int(count * 1.3) + 512 + 1023) // 1024) * 1024
        resize = tight != self.pair_capacity
        self.pair_capacity = tight
        if self._refit_rows_slack(pos):
            resize = True
        if self._n_cells() >= 5 and not bool(nmat.overflow):
            kmax = int(nmat.mask.sum(dim=1).max())
            k_tight = max(4, -(-(kmax + 1) // 4) * 4)
            if k_tight < min(c.max_neighbors, self.rows_k):
                self.rows_k = k_tight
                resize = True
        if resize:  # windows need the un-truncated pair list
            nmat, pairs, hmat, seg_starts, dual_full, ovf = self._broad_phase(pos)
        counts = np.diff(np.append(seg_starts.cpu().numpy(), int(pairs.num_pairs)))
        w_tight = (int(counts.max() * 1.5) + 511) // 512 * 512
        if w_tight != self.seg_window:
            self.seg_window = w_tight
            nmat, pairs, hmat, seg_starts, dual_full, ovf = self._broad_phase(pos)
        # active window from the near-contact per-block maximum (a cold start
        # is the high-water mark), 1.1x slack on a 64 grid
        setup0 = collision_setup_spheres(pos, self._radius(), pairs, metric=self.metric)
        act = pairs.mask & (setup0.sep0 < self._dyn_margin(setup0))
        n_act = int(act.sum())
        act_i = torch.where(act, pairs.i, c.num_spheres).cpu().numpy()
        blk = np.bincount(act_i[act_i < c.num_spheres] // self.seg_block, minlength=1)
        self.act_window = max(64, (int(blk.max() * 1.1) + 63) // 64 * 64)
        kw = dict(dtype=self.dtype, device=self.device)
        return LCPSpheresState(
            pos=pos,
            gamma=torch.zeros((self.act_capacity,), **kw),
            gamma_sel=torch.full((self.act_capacity,), self.pair_capacity,
                                 dtype=torch.int32, device=self.device),
            gamma_full=torch.zeros((self.pair_capacity,), **kw),
            key=tuple(int(k) for k in key_words), step=0,
            nmat=nmat, pairs=pairs, hydro_nmat=hmat, seg_starts=seg_starts,
            dual_full=dual_full,
            prev_cum=torch.zeros((self.pair_capacity,), dtype=torch.int32,
                                 device=self.device),
            ref_pos=pos, rebuild_count=1, lcp_iters=0, lcp_iters_max=0,
            lcp_residual=torch.zeros((), **kw),
            lcp_alpha=torch.full((), torch.nan, **kw),
            act_count=torch.tensor(n_act, dtype=torch.int32, device=self.device),
            act_block_max=torch.tensor(int(blk.max()), dtype=torch.int32,
                                       device=self.device),
            overflow=ovf)

    def _refit_rows_slack(self, pos) -> bool:
        """Set rows_slack so the row capacity sits just above the measured
        max row occupancy (counted on the positions' device; one scalar read).
        Returns True when the slack changed (the caller rebuilds)."""
        c = self.config
        if self._n_cells() < 5:
            return False
        with trace("refit.rows_slack"):
            g = make_row_grid([0, 0, 0], [c.box_size] * 3, 2 * self.search_radius,
                              c.num_spheres, capacity_slack=self.rows_slack,
                              dtype=self.dtype, align=8)
            occ_max = host_read("refit.occ_max", row_occupancy(pos, c.box_size, g).max())
        mean = c.num_spheres / (g.ny * g.nz)
        target_cap = ((int(occ_max * 1.12) + 6 + 7) // 8) * 8
        slack = max(1.15, (target_cap - 8) / mean)
        if abs(slack - self.rows_slack) / self.rows_slack < 0.05:
            return False
        self.rows_slack = slack
        return True

    def _scatter_gamma(self, gamma_full, state) -> torch.Tensor:
        """The active multipliers written onto a full-list snapshot at their
        full-list slots (pads, slot == its length, are dropped)."""
        cap = gamma_full.shape[0]
        out = torch.cat([gamma_full, gamma_full.new_zeros(1)])
        sel = state.gamma_sel.to(torch.int64)
        out[sel] = torch.where(sel < cap, state.gamma, 0.0)
        return out[:cap]

    def _rebuild(self, state: LCPSpheresState) -> LCPSpheresState:
        at_step(state.step)
        with trace("rebuild"):
            nmat, pairs, hmat, seg_starts, dual_full, ovf = self._broad_phase(state.pos)
            # warm-start multipliers survive the rebuild by pair identity:
            # scatter the active ones onto the old full list, remap into the
            # new list
            gfull_old = self._scatter_gamma(
                torch.zeros((self.pair_capacity,), dtype=self.dtype, device=self.device),
                state)
            gamma_full = remap_gamma(state.pairs, gfull_old, pairs,
                                     probes=self._pair_run_bound(),
                                     old_starts=body_pair_starts(state.nmat),
                                     old_nmat=state.nmat)
        return state.replace(
            nmat=nmat, pairs=pairs, hydro_nmat=hmat, seg_starts=seg_starts,
            dual_full=dual_full, prev_cum=torch.zeros_like(state.prev_cum),
            gamma=torch.zeros_like(state.gamma),
            gamma_sel=torch.full_like(state.gamma_sel, self.pair_capacity),
            gamma_full=gamma_full, ref_pos=state.pos,
            rebuild_count=state.rebuild_count + 1,
            overflow=state.overflow | ovf)

    def _mobility(self, pos: torch.Tensor, hydro_nmat) -> tuple:
        """(apply, overflow) of the hydro mode at these positions. `overflow`
        flags the spectral mode's per-step binning (SE tiles, 3D cells): an
        overflowed body leaves the hydro sum, so it must reach the state's
        flag."""
        c = self.config
        no_ovf = torch.zeros((), dtype=torch.bool, device=self.device)
        if c.hydro == "none":
            if self.radii is not None:
                return (lambda f: self.inv_drag[:, None] * f), no_ovf
            return (lambda f: local_drag_mobility(f, c.radius, c.viscosity)), no_ovf
        if c.hydro == "rpy_spectral":
            # bin once per step: positions are fixed across the solve's applies
            pieces = se_bin_geom(self.se_geom, pos, self.dtype)
            cells = build_cells3d(pos, self.hydro_cells_grid)
            return (lambda f: se_rpy_apply_cells(
                self.spectral, cells, pos, f, (c.box_size,) * 3, self.se_geom,
                pieces=pieces)[0]), pieces[1] | cells.overflow
        if c.hydro == "rpy_ewald":
            return (lambda f: ewald_rpy_apply(self.ewald, pos, f, hydro_nmat,
                                              self.metric)), no_ovf
        if c.hydro == "rpy_ring":
            return (lambda f: self.ring_apply(pos, f)), no_ovf
        return (lambda f: rpy_apply_neighbors(pos, f, hydro_nmat, c.radius, c.viscosity,
                                              metric=self.metric,
                                              overlap_correction=True)), no_ovf

    def _dyn_margin(self, setup) -> torch.Tensor:
        """Active-set margin = static margin + deepest current overlap (a
        deep cold-start contact moves its bodies that far in one step)."""
        sep0 = torch.where(setup.pairs.mask, setup.sep0, torch.inf)
        deepest = torch.clamp(-sep0.min(), min=0.0)
        return torch.tensor(self.active_margin, dtype=self.dtype,
                            device=self.device) + deepest

    def _inner_step(self, state: LCPSpheresState) -> LCPSpheresState:
        """Constraint assembly + BBPGD + Euler against the skin-buffered
        pair list (separations and normals from the current positions)."""
        c = self.config
        fused_drag = c.hydro == "none"
        at_step(state.step)
        with trace("step"):
            with trace("assemble"):
                setup_full = collision_setup_spheres(state.pos, self._radius(), state.pairs,
                                                     metric=self.metric)
                act = active_pair_subset_strided(
                    setup_full, self._dyn_margin(setup_full), c.num_spheres,
                    self.seg_block, self.act_window, state.seg_starts,
                    dual_full=state.dual_full if fused_drag else None,
                    prev=(state.prev_cum, state.gamma, self.act_window),
                    gamma_full=state.gamma_full)
                mobility, hydro_ovf = self._mobility(state.pos, state.hydro_nmat)
                apply_band = None
                if fused_drag:
                    # scalar mobility: the banded Delassus apply (the active
                    # list is i-sorted, so M[p, q] lives within the per-body
                    # neighbor cap)
                    if self.radii is not None:
                        nsafe = c.num_spheres - 1
                        mob_i = self.inv_drag[torch.clamp(act.setup.pairs.i, max=nsafe).long()]
                        mob_j = self.inv_drag[torch.clamp(act.setup.pairs.j, max=nsafe).long()]
                    else:
                        mob_i = mob_j = torch.tensor(
                            1.0 / (6.0 * _math.pi * c.viscosity * c.radius),
                            dtype=self.dtype, device=self.device)
                    apply_band = make_band_delassus_apply(act.setup, act.dual, c.dt,
                                                          self._pair_run_bound(),
                                                          mobility_i=mob_i, mobility_j=mob_j)
            # Brownian drift is a known velocity: it enters the LCP's constant
            # term so the solve enforces non-penetration of the end-of-step
            # positions
            u_ext = None
            if c.diffusion_coeff > 0:
                with trace("noise"):
                    u_ext = brownian_velocity_keyed(
                        state.key, state.step,
                        torch.arange(c.num_spheres, dtype=torch.int32, device=self.device),
                        c.diffusion_coeff, c.dt, dtype=self.dtype)
            with trace("solve"):
                gamma, vel, res = resolve_collisions(
                    act.setup, mobility, c.num_spheres, c.dt,
                    max_allowable_overlap=c.max_allowable_overlap,
                    max_iterations=c.max_col_iterations, gamma0=act.gamma0,
                    u_ext=u_ext, alpha0=state.lcp_alpha, apply_override=apply_band,
                    replicas=self.group)
            with trace("integrate"):
                if u_ext is not None:
                    vel = vel + u_ext
                new_pos = euler_step(state.pos, vel,
                                     torch.tensor(c.dt, dtype=self.dtype, device=self.device),
                                     metric=self.metric)
        return state.replace(
            pos=new_pos, gamma=gamma, gamma_sel=act.sel, prev_cum=act.cum,
            step=state.step + 1, lcp_iters=res.num_iters,
            lcp_iters_max=max(state.lcp_iters_max, res.num_iters),
            lcp_residual=res.residual, lcp_alpha=res.alpha,
            act_count=act.n_act, act_block_max=act.block_max.to(torch.int32),
            overflow=state.overflow | act.overflow | hydro_ovf)

    def _moved(self, state: LCPSpheresState) -> bool:
        disp = self.metric.sep(state.ref_pos, state.pos)
        skin_sq = torch.tensor((0.5 * self.config.constraint_buffer) ** 2,
                               dtype=self.dtype, device=self.device)
        fired = ((disp * disp).sum(-1).max() > skin_sq).reshape(1)
        if self.group is not None:
            fired = self.group.pmax(fired.to(torch.int32)) > 0
        return host_read("skin", fired[0])

    def step(self, state: LCPSpheresState) -> LCPSpheresState:
        """One step, rebuilding first when the skin trigger fired."""
        if self._moved(state):
            state = self._rebuild(state)
        return self._inner_step(state)

    def run_block(self, state: LCPSpheresState, n_steps: int,
                  resize: bool = True) -> LCPSpheresState:
        """n_steps steps (a skin rebuild before any step whose trigger fired,
        as the reference's bursts do), then, unless `resize` is False, the
        between-block refits of the rows broad phase and the active window."""
        for _ in range(n_steps):
            state = self.step(state)
        if self.group is not None:  # every rank reads the same flag
            ovf = self.group.pmax(state.overflow.reshape(1).to(torch.int32))[0] > 0
            state = state.replace(overflow=ovf)
        if resize:
            with trace("refit"):
                state = self._refit_broad(state)
                state = self._resize_active(state)
        return state

    def _refit_broad(self, state: LCPSpheresState) -> LCPSpheresState:
        """Between blocks: shrink rows_k to the measured max neighbor count
        and rows_slack to the measured max row occupancy. A shrink must be
        demanded by two consecutive blocks. rows_k keeps two slots above the
        measured max (init keeps one): over hundreds of rebuilds of millions
        of spheres the max reaches one above its reading, and one slot over
        rows_k overflows and regrows (4,194,304 spheres: K 8 from a reading
        of 7 overflowed near step 700)."""
        c = self.config
        if self._n_cells() < 5 or host_read("refit.overflow", state.overflow):
            return state
        kmax = int(host_read("refit.kmax", state.nmat.mask.sum(dim=1).max()))
        k_tight = max(4, -(-(kmax + 2) // 4) * 4)
        want_k = k_tight < min(c.max_neighbors, self.rows_k)
        slack_old = self.rows_slack
        want_slack = self._refit_rows_slack(state.pos)
        if not (want_k or want_slack):
            self._broad_shrink_streak = 0
            return state
        if self._broad_shrink_streak < 1:
            self.rows_slack = slack_old  # defer (hysteresis)
            self._broad_shrink_streak += 1
            return state
        self._broad_shrink_streak = 0
        if want_k:
            self.rows_k = k_tight
        return self._rebuild(state)

    def _resize_active(self, state: LCPSpheresState) -> LCPSpheresState:
        """Between blocks: re-fit the active window W to the measured
        per-block maximum. Growing is immediate; a shrink by less than 25%
        must be demanded by two consecutive blocks."""
        blk_max = int(host_read("resize.blk_max", state.act_block_max))
        target_w = max(64, (int(blk_max * 1.1) + 63) // 64 * 64)
        if target_w == self.act_window:
            self._act_shrink_streak = 0
            return state
        if (target_w <= self.act_window and self._act_shrink_streak < 1
                and target_w > 0.75 * self.act_window):
            self._act_shrink_streak += 1
            return state
        self._act_shrink_streak = 0
        # W moves every strided slot: fold the live multipliers into the
        # full-list snapshot (the warm start's fallback) instead
        gfull = self._scatter_gamma(state.gamma_full, state)
        self.act_window = target_w
        return state.replace(
            gamma=torch.zeros((self.act_capacity,), dtype=self.dtype, device=self.device),
            gamma_sel=torch.full((self.act_capacity,), self.pair_capacity,
                                 dtype=torch.int32, device=self.device),
            gamma_full=gfull, prev_cum=torch.zeros_like(state.prev_cum))

    def regrow(self, state: LCPSpheresState) -> LCPSpheresState:
        """Grow every overflow-bounded capacity and rebuild from the state's
        positions; warm-start multipliers are remapped by pair identity into
        the bigger list (driver/regrow.py). The spectral mode's SE tile rows
        and 3D-cell capacity grow too, as the chromatin app grows them; the
        reference's LCP app leaves them, so its overflow there persists until
        run() gives up (ROADMAP queue 3)."""
        c = self.config
        probes = self._pair_run_bound()
        old = torch.zeros((self.pair_capacity,), dtype=self.dtype, device=self.device)
        self.pair_capacity = grow_int(self.pair_capacity, align=1024)
        self.seg_window = grow_int(self.seg_window, align=512)
        self.act_window = grow_int(self.act_window, align=256)
        self.rows_k = grow_int(self.rows_k, align=4)
        self.rows_slack *= 1.5
        c.max_neighbors = grow_int(c.max_neighbors)
        c.cell_capacity = grow_int(c.cell_capacity)
        if self.spectral is not None:
            self.se_geom = self.se_geom._replace(R=grow_int(self.se_geom.R))
            g3 = self.hydro_cells_grid
            self.hydro_cells_grid = g3.replace(capacity=grow_int(g3.capacity))
        nmat, pairs, hmat, seg_starts, dual_full, ovf = self._broad_phase(state.pos)
        gamma_full = remap_gamma(state.pairs, self._scatter_gamma(old, state), pairs,
                                 probes=probes, old_starts=body_pair_starts(state.nmat),
                                 old_nmat=state.nmat)
        return state.replace(
            nmat=nmat, pairs=pairs, hydro_nmat=hmat, seg_starts=seg_starts,
            dual_full=dual_full,
            prev_cum=torch.zeros((self.pair_capacity,), dtype=torch.int32,
                                 device=self.device),
            gamma=torch.zeros((self.act_capacity,), dtype=self.dtype, device=self.device),
            gamma_sel=torch.full((self.act_capacity,), self.pair_capacity,
                                 dtype=torch.int32, device=self.device),
            gamma_full=gamma_full, ref_pos=state.pos, overflow=ovf)

    def run(self, state: Optional[LCPSpheresState] = None, log=print):
        c = self.config
        if state is None:
            state = self.init()

        def status(s, done, tps):
            return (f"step {done}/{c.num_steps}  tps={tps:.2f}  "
                    f"lcp_iters={s.lcp_iters}  "
                    f"residual={float(s.lcp_residual):.2e}  "
                    f"overflow={bool(s.overflow)}")

        return run_blocks(self, state, c.num_steps, c.log_every, log, status)

    def max_overlap(self, state: LCPSpheresState) -> float:
        """Largest pair overlap r_i + r_j - d over a fresh cell-list search
        (negative when no pair touches)."""
        c = self.config
        n = c.num_spheres
        clist = build_cell_list(state.pos, self.grid, c.cell_capacity)
        nmat = neighbor_matrix(state.pos, clist, self._search_radii(),
                               metric=self.metric, max_neighbors=c.max_neighbors,
                               chunk=min(c.chunk, max(256, n)))
        idx = torch.clamp(nmat.idx, max=n - 1).to(torch.int64)
        sep = self.metric.sep(state.pos[:, None, :], state.pos[idx])
        radius = torch.broadcast_to(self._radius(), (n,))
        d = torch.linalg.vector_norm(sep, dim=-1) - radius[:, None] - radius[idx]
        return float(-torch.where(nmat.mask, d, torch.inf).min())
