"""BASELINE config #5 and the HP1 pipeline: chromatin bead chains with
crosslinkers and Stokes mobility, periodic or confined.

Port of mundy_tpu/driver/apps/chromatin.py (ref: the HP1 pipeline,
`HP1_mock_rework_agents_text_mesh_neigh_linker.cpp`, time loop
`:1377-1524`). Per step:
    1. KMC crosslinker bind/unbind (`:1449-1456`, kmc/crosslinkers.py);
    2. forces: FENE-WCA backbone springs, Hertzian contact over the
       neighbor matrix (bonded pairs excluded), crosslinker Hookean
       springs, the spherical periphery wall (`:604-760`);
    3. velocities: local drag (`hydro="none"`), neighbor RPY
       (`"rpy_neighbors"`), the periodic spectral-Ewald RPY
       (`"rpy_spectral"`: the real-space correction on the 3D-cell engine,
       with the density split where init's cost model picks it, plus the
       wave sum through kernels K5s and K5i and cuFFT), or inside the
       spherical periphery the ambient RPY flow plus the no-slip
       boundary-integral correction (`:1487-1493`): all pairs
       (`"rpy_periphery"`) or the free-space spectral Stokes sum on a padded
       grid through K5s and K5i (`"rpy_periphery_spectral"`), with the flow
       at the quadrature nodes summed over all beads; then gid-keyed
       Brownian noise;
    4. the Euler update, wrapped into the periodic box.

Neighbor maintenance: the contact search goes through the row layout and
kernel K2 where the row layout is feasible, the cell list otherwise; the
crosslinker candidates come from their own capture-radius cell list, and
`rpy_periphery_spectral`'s real-space pairs from a cell list at the
free-space operator's cutoff. The searches are rebuilt before a step when
some bead moved more than skin/2 since the last rebuild; the host reads
that flag once per step.

`mesh=` takes a parallel.comm.Group: with `hydro="rpy_spectral"` every rank
holds the whole state and the mobility apply runs over the group
(parallel/spectral_shard.py: each rank grids its own block of N/d beads,
one psum of the grid, each rank's x-slab of the real space), its
velocities all-gathered, the reference's sharded mode of config #5.

Chains start on a Hilbert curve, their offsets and the crosslinker homes
drawn from numpy's default_rng(seed), as in the reference; the run's key is
the second half of the threefry split of (0, seed), as jax.random.split
gives it.
"""

from __future__ import annotations

import dataclasses
import math as _math
from typing import Optional

import numpy as np
import torch

from mundy_tpu_torch.core.config import validate_config
from mundy_tpu_torch.core.containers import frozen_dataclass
from mundy_tpu_torch.core.interop import key_words
from mundy_tpu_torch.driver.regrow import grow_int, run_blocks
from mundy_tpu_torch.dynamics.brownian import brownian_velocity_keyed, fold_in
from mundy_tpu_torch.forces.contact import hertzian_contact_forces
from mundy_tpu_torch.forces.springs import fenewca_chain_forces, hookean_spring_forces
from mundy_tpu_torch.geom.periodicity import free_space, periodic
from mundy_tpu_torch.kmc.crosslinkers import (
    BINDING_STATE,
    binding_rate_gaussian,
    crosslinker_kmc_step,
)
from mundy_tpu_torch.math.spacefill import hilbert_positions_and_directors
from mundy_tpu_torch.mobility.freespace import (
    build_freespace_stokes,
    freespace_geometry,
    freespace_rpy_apply,
)
from mundy_tpu_torch.mobility.local_drag import local_drag_mobility
from mundy_tpu_torch.mobility.periphery import build_sphere_periphery, no_slip_correction
from mundy_tpu_torch.mobility.rpy import rpy_apply_dense, rpy_apply_neighbors, rpy_flow_at
from mundy_tpu_torch.mobility.spectral import (
    build_spectral_ewald,
    make_se_geometry_tiles,
    se_bin_geom,
    se_rpy_apply_cells,
)
from mundy_tpu_torch.neighbor.cell_list import (
    NeighborMatrix,
    _compact_rows,
    build_cell_list,
    make_cell_grid,
    neighbor_candidates,
    neighbor_matrix,
)
from mundy_tpu_torch.neighbor.cells3d import (
    build_cells3d,
    build_cells3d_split,
    make_cell_grid3d,
)
from mundy_tpu_torch.neighbor.rows import (
    make_row_grid,
    neighbor_matrix_rows,
    rows_extract_feasible,
)
from mundy_tpu_torch.parallel.comm import Group
from mundy_tpu_torch.state.select import select
from mundy_tpu_torch.state.world import EntitySet, LinkSet

_DTYPES = {"float32": torch.float32, "float64": torch.float64}
_PERIPHERY_MODES = ("rpy_periphery", "rpy_periphery_spectral")


@dataclasses.dataclass
class ChromatinConfig:
    num_chains: int = 4
    beads_per_chain: int = 512
    bead_radius: float = 0.5
    # backbone FENE-WCA (Kremer-Grest)
    backbone_k: float = 30.0
    backbone_rmax: float = 1.5  # in units of 2 * bead_radius
    wca_epsilon: float = 1.0
    # nonbonded contact
    youngs_modulus: float = 1000.0
    poissons_ratio: float = 0.3
    # crosslinkers (HP1 dimers): the left head sits on its home bead, the
    # right head binds and unbinds nearby beads (ref `:177-360`)
    num_crosslinkers: int = 256
    crosslinker_k: float = 10.0
    crosslinker_rest_length: float = 1.5
    binding_rate: float = 10.0  # A prefactor
    unbinding_rate: float = 1.0  # koff
    kt: float = 1.0
    # the leading `hetero_fraction` of every chain joins part "hetero";
    # homes and binding targets come from `binding_selector` (state/select)
    hetero_fraction: float = 1.0
    binding_selector: str = "hetero"
    # spherical periphery of this radius (0 disables)
    periphery_radius: float = 0.0
    periphery_stiffness: float = 200.0
    viscosity: float = 1.0
    diffusion_coeff: float = 0.1
    # "none" | "rpy_neighbors" | "rpy_spectral" | "rpy_periphery" (all-pairs
    # RPY + the no-slip periphery BIE correction; needs periphery_radius) |
    # "rpy_periphery_spectral" (free-space spectral Stokes + the same BIE)
    hydro: str = "none"
    periphery_order: int = 12  # BIE quadrature order (Q = 2 (order + 1)^2)
    periphery_cache: str = ""  # optional .npy path caching the dense M^-1
    # periodic box edge; 0 = free space. Required for "rpy_spectral"
    box_size: float = 0.0
    dt: float = 1e-4
    num_steps: int = 100
    skin: float = 0.4
    max_neighbors: int = 32
    # the crosslinker candidate search reaches out to where the Gaussian
    # binding rate falls to kmc_rate_floor of its peak
    kmc_rate_floor: float = 1e-3
    cell_capacity: int = 16
    chunk: int = 16384
    seed: int = 1234
    dtype: str = "float32"
    log_every: int = 100

    def __validate__(self):
        assert self.hydro in ("none", "rpy_neighbors", "rpy_spectral",
                              "rpy_periphery", "rpy_periphery_spectral"), \
            f"hydro '{self.hydro}' not one of: none, rpy_neighbors, " \
            "rpy_spectral, rpy_periphery, rpy_periphery_spectral"
        if self.hydro == "rpy_spectral":
            assert self.box_size > 0, "rpy_spectral needs a periodic box_size"
        if self.hydro in _PERIPHERY_MODES:
            assert self.periphery_radius > 0, \
                f"{self.hydro} needs a periphery_radius confinement"
        assert self.periphery_radius == 0 or self.box_size == 0, \
            "periphery confinement and a periodic box are exclusive"
        assert self.num_crosslinkers >= 0


@frozen_dataclass
class ChromatinState:
    """Crosslinkers live in a LinkSet("beads", "beads"): indices[:, 0] is
    the home bead, indices[:, 1] the right head's target (meaningful iff
    active), active marks the doubly-bound springs, fields["state"] holds
    BINDING_STATE."""

    pos: torch.Tensor  # (N, 3) beads
    xl: LinkSet
    key: tuple  # the run's two uint32 key words (python ints)
    step: int
    nmat: NeighborMatrix  # contact search, and the pairs of the neighbor RPY
    hydro_nmat: NeighborMatrix  # free-space real-space pairs; nmat in other modes
    kmc_nmat: NeighborMatrix  # crosslinker candidates (X, kmc_K)
    ref_pos: torch.Tensor  # positions at the last rebuild
    rebuild_count: int
    overflow: torch.Tensor  # () bool, sticky

    @property
    def xl_home(self) -> torch.Tensor:
        return self.xl.indices[:, 0]

    @property
    def xl_state(self) -> torch.Tensor:
        return self.xl.fields["state"]

    @property
    def xl_bound_to(self) -> torch.Tensor:
        return torch.where(self.xl.active, self.xl.indices[:, 1], -1)


def chromatin_state_from_numpy(pos, xl_indices, xl_active, xl_state, key, step, nmat,
                               kmc_nmat, ref_pos, rebuild_count, overflow,
                               device="cpu", hydro_nmat=None) -> ChromatinState:
    """A ChromatinState from the reference ChromatinState's arrays, to
    continue a JAX run in the port: pos and ref_pos (N, 3) in one dtype;
    the crosslinker LinkSet's indices (X, 2), active (X,) and
    fields["state"] (X,); key: the two uint32 words of the raw threefry key;
    step, rebuild_count: ints; nmat, kmc_nmat, hydro_nmat: the contact,
    crosslinker and free-space hydro searches, carried with core/interop's
    neighbor_matrix_from_numpy (hydro_nmat defaults to nmat, as in every
    mode but rpy_periphery_spectral); overflow: the sticky flag."""
    def t(a, dtype=None):
        return torch.as_tensor(np.array(a), dtype=dtype, device=device)

    pos, ref_pos = t(pos), t(ref_pos)
    if ref_pos.dtype != pos.dtype:
        raise TypeError("pos and ref_pos must share one dtype")
    xl = LinkSet(indices=t(xl_indices, torch.int32), active=t(xl_active, torch.bool),
                 fields={"state": t(xl_state, torch.int32)}, targets=("beads", "beads"))
    return ChromatinState(pos=pos, xl=xl, key=key_words(key), step=int(step), nmat=nmat,
                          hydro_nmat=nmat if hydro_nmat is None else hydro_nmat,
                          kmc_nmat=kmc_nmat, ref_pos=ref_pos,
                          rebuild_count=int(rebuild_count),
                          overflow=t(bool(overflow), torch.bool))


class ChromatinSim:
    """Chromatin simulation for ChromatinConfig on one device (the card
    unless the caller asks for "cpu")."""

    def __init__(self, config: ChromatinConfig, device="cuda", mesh=None):
        """`mesh`: an optional parallel.comm.Group over which the
        rpy_spectral mobility runs sharded (every rank builds the sim with
        the same config and steps it in step with the others)."""
        self.config = c = config
        validate_config(config)
        self._mesh = mesh
        self.sharded_se = None
        if mesh is not None:
            if not isinstance(mesh, Group):
                raise TypeError(f"mesh= takes a parallel.comm.Group, got {type(mesh).__name__}")
            if c.hydro != "rpy_spectral":
                raise ValueError(f"mesh= shards the rpy_spectral mobility; hydro is "
                                 f"{c.hydro!r}")
            n = c.num_chains * c.beads_per_chain
            if n % mesh.size != 0:
                raise ValueError(f"the sharded spectral hydro needs N % ranks == 0 (N {n}, "
                                 f"{mesh.size} ranks)")
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("ChromatinSim(device='cuda') needs a CUDA device, and "
                               "torch sees none")
        self.dtype = _DTYPES[c.dtype]
        kw = dict(dtype=self.dtype, device=self.device)
        self.N = c.num_chains * c.beads_per_chain
        self.X = c.num_crosslinkers
        self.periodic = c.box_size > 0
        self.search_radius = c.bead_radius + 0.5 * c.skin
        # crosslinker capture radius: rest length + the Gaussian rate tail
        tail = _math.sqrt(2.0 * c.kt * _math.log(1.0 / c.kmc_rate_floor)
                          / max(c.crosslinker_k, 1e-12))
        self.kmc_capture = c.crosslinker_rest_length + tail
        if self.periodic:
            extent = 0.5 * c.box_size
            self.metric = periodic([c.box_size] * 3, **kw)
            low, high, per = [0, 0, 0], [c.box_size] * 3, (True,) * 3
        else:
            extent = self._domain_extent()
            self.metric = free_space(**kw)
            low, high, per = -extent * np.ones(3), extent * np.ones(3), (False,) * 3
        self.grid = make_cell_grid(low, high, 2 * self.search_radius, per, **kw)
        self.domain = extent
        if self.X > 0:
            kmc_cut = self.kmc_capture + c.skin
            self.kmc_grid = make_cell_grid(low, high, kmc_cut, per, **kw)
            # clustering-aware capacity: touching-bead chains pack to ~close
            # packing locally whatever the box-mean density
            d = 2.0 * c.bead_radius
            cell_vol = float(np.prod(self.kmc_grid.cell_size.cpu().numpy().astype(np.float64)))
            pack = 0.74 / ((_math.pi / 6.0) * d ** 3) * cell_vol
            cap = int(pack + 6.0 * _math.sqrt(pack + 4.0) + 8.0)
            self.kmc_cell_capacity = min(((cap + 7) // 8) * 8, self.N)
            # candidate row capacity after the distance compaction
            # (close-packed bound on beads within kmc_cut; regrown)
            in_r = 0.74 * ((kmc_cut + c.bead_radius) / c.bead_radius) ** 3
            self.kmc_K = min(((int(in_r + 6.0 * _math.sqrt(in_r + 4.0) + 8.0) + 7) // 8) * 8,
                             self.N)
        self.rows_slack = 1.9  # rows broad-phase slot slack (regrown)
        # the contact K lives on the sim: init right-sizes it, regrow widens it
        self.contact_K = c.max_neighbors
        self.cell_capacity = c.cell_capacity
        self.spectral = None
        self.hydro_split = None
        if c.hydro == "rpy_spectral":
            # r_cut from the local bead spacing (touching chains), not the
            # box-mean spacing
            r_cut = min(0.25 * c.box_size, 3.5 * 2.0 * c.bead_radius)
            s2 = _math.sqrt(max(_math.log(1e4), 1.0))
            self.spectral = build_spectral_ewald(c.box_size, c.bead_radius, c.viscosity,
                                                 tol=1e-4, xi=s2 / r_cut, r_cut=r_cut, **kw)
            # 3D-tile gridding; R right-sized from measured occupancy at init
            self.se_geom = make_se_geometry_tiles(self.spectral, self.N, capacity_slack=1.5)
            # real-space cells: capacity from the close-packing bound
            d = 2.0 * c.bead_radius
            edge = self.spectral.base.r_cut
            pack_cell = 0.74 * (edge / d) ** 3
            cap = int(pack_cell + 6 * _math.sqrt(pack_cell + 4) + 4)
            cap = min(((cap + 7) // 8) * 8, self.N)
            g3 = make_cell_grid3d([c.box_size] * 3, edge, self.N, **kw)
            self.hydro_cells_grid = g3.replace(capacity=max(g3.capacity, cap))
        self.periphery = None
        if c.hydro in _PERIPHERY_MODES:
            self.periphery = build_sphere_periphery(c.periphery_order, c.periphery_radius,
                                                    cache_path=c.periphery_cache or None,
                                                    **kw)
        self.freespace = None
        if c.hydro == "rpy_periphery_spectral":
            # free-space spectral Stokes over the sphere's bounding box; r_cut
            # from the local (touching-chain) spacing
            rp = c.periphery_radius
            r_cut = min(0.5 * rp, 3.5 * 2.0 * c.bead_radius)
            self.freespace = build_freespace_stokes(2.0 * rp, c.bead_radius, c.viscosity,
                                                    origin=(-rp, -rp, -rp), extent=2.0 * rp,
                                                    r_cut=r_cut, tol=1e-4, **kw)
            # tile gridding of the padded grid; R right-sized at init
            self.fs_geom = freespace_geometry(self.freespace, self.N, capacity_slack=3.0)
            # the real-space pairs: their own search at the operator's r_cut,
            # on a grid of their own (the contact grid's cells are far
            # narrower than r_cut, and the 27-cell stencil reaches one cell)
            self.fs_hydro_search = 0.5 * self.freespace.se.base.r_cut
            self.fs_hydro_K = 96
            self.fs_grid = make_cell_grid(-rp * np.ones(3), rp * np.ones(3),
                                          2.0 * self.fs_hydro_search, (False,) * 3, **kw)
            self.fs_cell_capacity = 256
        # bonded-exclusion table for contact: previous and next bead
        bead = np.arange(self.N)
        per_chain = c.beads_per_chain
        prev = np.where((bead % per_chain) > 0, bead - 1, -1)
        nxt = np.where((bead % per_chain) < per_chain - 1, bead + 1, -1)
        self.exclude = torch.as_tensor(np.stack([prev, nxt], 1), dtype=torch.int32,
                                       device=self.device)
        self._gids = torch.arange(self.N, dtype=torch.int32, device=self.device)
        self._xl_gids = torch.arange(self.X, dtype=torch.int32, device=self.device)
        self._dt = torch.tensor(c.dt, **kw)
        self._k = {name: torch.tensor(v, **kw) for name, v in (
            ("backbone_k", c.backbone_k),
            ("backbone_rmax", c.backbone_rmax * 2.0 * c.bead_radius),
            ("sigma", 2.0 * c.bead_radius), ("wca_epsilon", c.wca_epsilon),
            ("crosslinker_k", c.crosslinker_k),
            ("crosslinker_rest_length", c.crosslinker_rest_length),
            ("unbinding_rate", c.unbinding_rate), ("bead_radius", c.bead_radius),
            ("youngs_modulus", c.youngs_modulus), ("poissons_ratio", c.poissons_ratio))}

    def _domain_extent(self) -> float:
        c = self.config
        if c.periphery_radius > 0:
            return c.periphery_radius + 2 * c.bead_radius
        s = 2  # Hilbert lattice footprint
        while s**3 < c.beads_per_chain:
            s *= 2
        return max(2.0 * s * c.bead_radius * 2, 16 * c.bead_radius) * max(
            1, int(np.ceil(c.num_chains ** (1 / 3))))

    # ------------------------------------------------------------------
    def _initial_positions(self, rng) -> torch.Tensor:
        """Chains on a Hilbert curve, one per cell of a non-overlapping grid
        of cells, jittered within the room their cell leaves."""
        c = self.config
        spacing = 2.0 * c.bead_radius  # touching beads along the curve
        n_side = max(int(np.ceil(c.num_chains ** (1.0 / 3.0))), 1)
        cell = 2.0 * self.domain / n_side
        pts, _ = hilbert_positions_and_directors(c.beads_per_chain, side_length=spacing)
        pts = pts[: c.beads_per_chain]
        footprint = pts.max(axis=0) - pts.min(axis=0)
        jitter_room = np.maximum(0.5 * (cell - footprint.max()) - spacing, 0.0)
        center = pts.mean(axis=0)
        chains = []
        for ci in range(c.num_chains):
            cx, cy, cz = ci % n_side, (ci // n_side) % n_side, ci // (n_side * n_side)
            center_cell = (np.array([cx, cy, cz]) + 0.5) * cell - self.domain
            offset = center_cell + rng.uniform(-1, 1, 3) * 0.5 * jitter_room
            chains.append(pts - center + offset)
        pos = torch.as_tensor(np.concatenate(chains), dtype=self.dtype, device=self.device)
        if self.periodic:
            pos = self.metric.wrap(pos + 0.5 * c.box_size)
        if c.periphery_radius > 0:
            r = torch.sqrt((pos * pos).sum(1))
            max_r = c.periphery_radius - 2 * c.bead_radius
            pos = pos * torch.clamp(max_r / torch.clamp(r.max(), min=1e-6), max=1.0)
        return pos

    @staticmethod
    def _room(occ: int) -> int:
        """1.5 x a measured occupancy + 8, rounded up to 8."""
        return ((int(occ * 1.5) + 8 + 7) // 8) * 8

    @classmethod
    def _measured_tile_R(cls, g, q: np.ndarray) -> int:
        """The room for the fullest tile's count, for the positions q (from
        the grid's origin) binned as se_bin_tiles bins them."""
        nt1 = g.G // g.m
        h = g.box / g.G
        it = np.clip((q / (g.m * h)).astype(int), 0, nt1 - 1)
        tile = (it[:, 0] * nt1 + it[:, 1]) * nt1 + it[:, 2]
        return cls._room(int(np.bincount(tile, minlength=nt1 ** 3).max()))

    def _right_size_hydro(self, p: np.ndarray) -> None:
        """SE tile R and 3D-cell capacity from the measured occupancy, and
        the density split from a cost model over the measured histogram."""
        need = self._measured_tile_R(self.se_geom, p)
        if need != self.se_geom.R:
            self.se_geom = self.se_geom._replace(R=max(need, 8))
        g3 = self.hydro_cells_grid
        edge = g3.edge.cpu().numpy()
        dims = np.asarray([g3.nx, g3.ny, g3.nz])
        ic = np.clip((p / edge).astype(int), 0, dims - 1)
        counts3 = np.bincount((ic[:, 0] * g3.ny + ic[:, 1]) * g3.nz + ic[:, 2],
                              minlength=dims.prod())
        occ3 = int(counts3.max())
        cap3 = max(8, ((int(occ3 * 1.4) + 4 + 7) // 8) * 8)
        if cap3 < g3.capacity:
            self.hydro_cells_grid = g3.replace(capacity=cap3)
        # density split: the dense pair scan costs ~ capacity^2 per cell;
        # the split runs it at c_lo and corrects the dense cells compactly:
        #   A ~ n_cells 27 c_lo^2, B'+C'D' ~ DC 27 (c_lo ex + ex (c_lo + ex)),
        #   scatter ~ 130 DC 27 c_lo,
        # enabled only when it beats the plain scan by >= 20%
        self.hydro_split = None
        n_cells3 = int(dims.prod())
        cap_now = self.hydro_cells_grid.capacity
        no_split = float(n_cells3) * 27.0 * cap_now * cap_now
        best = (no_split, None)
        for c_lo in range(8, cap_now, 8):
            n_dense = int(np.sum(counts3 > c_lo))
            if n_dense == 0:
                continue
            ex = max(8, ((int((occ3 - c_lo) * 1.4) + 8 + 7) // 8) * 8)
            dc = max(64, ((int(n_dense * 1.5) + 63) // 64) * 64)
            est = (n_cells3 * 27.0 * c_lo * c_lo + dc * 27.0 * (c_lo * ex + ex * (c_lo + ex))
                   + 130.0 * dc * 27.0 * c_lo)
            if est < best[0]:
                best = (est, (c_lo, ex, dc))
        if best[1] is not None and best[0] < 0.8 * no_split:
            c_lo, c_ex, dc_cap = best[1]
            self.hydro_split_grid = self.hydro_cells_grid.replace(capacity=c_lo)
            self.hydro_split = (c_ex, dc_cap)

    def _right_size_freespace(self, p: np.ndarray, pos: torch.Tensor) -> None:
        """The padded grid's tile R from the measured occupancy of the
        shifted positions, by the reference's 1.5 x + 8 rule (it sizes its
        rows layout so): the padded box is mostly empty and the chains are
        clustered, so the Poisson bound is hopeless. Then the hydro search's
        cell capacity and K, by the same rule where the reference's 256 and
        96 overflow (HP1's chains overflow K at init; the reference leaves
        both as they are). All three only grow here."""
        need = self._measured_tile_R(self.fs_geom,
                                     p - np.asarray(self.freespace.origin)[None, :])
        if need > self.fs_geom.R:
            self.fs_geom = self.fs_geom._replace(R=need)
        hcl = build_cell_list(pos, self.fs_grid, self.fs_cell_capacity)
        if bool(hcl.overflow):
            self.fs_cell_capacity = self._room(int(hcl.counts.max()))
            hcl = build_cell_list(pos, self.fs_grid, self.fs_cell_capacity)
        chunk = min(self.config.chunk, max(256, self.N))
        hmat = neighbor_matrix(pos, hcl, self.fs_hydro_search, metric=None,
                               max_neighbors=self.fs_hydro_K, chunk=chunk)
        if bool(hmat.overflow):
            # room for all 27 cells' candidates: the count is exact
            full = neighbor_matrix(pos, hcl, self.fs_hydro_search, metric=None,
                                   max_neighbors=27 * self.fs_cell_capacity, chunk=chunk)
            self.fs_hydro_K = self._room(int(full.mask.sum(1).max()))

    def _right_size_rows(self, p: np.ndarray) -> None:
        """Contact rows slack from the measured row occupancy (Hilbert
        chains cluster 2-3x over the mean)."""
        c = self.config
        rg = make_row_grid([0, 0, 0], (c.box_size,) * 3, 2.0 * float(self.search_radius),
                           self.N, capacity_slack=self.rows_slack, align=8)
        iy = np.clip((p[:, 1] / (c.box_size / rg.ny)).astype(int), 0, rg.ny - 1)
        iz = np.clip((p[:, 2] / (c.box_size / rg.nz)).astype(int), 0, rg.nz - 1)
        occ = int(np.bincount(iy * rg.nz + iz, minlength=rg.ny * rg.nz).max())
        need = int(occ * 1.3) + 8
        if need > rg.row_capacity:
            mean = self.N / (rg.ny * rg.nz)
            self.rows_slack = max(self.rows_slack, (need - 8) / mean)

    def init(self, key_words: Optional[tuple] = None) -> ChromatinState:
        """Initial state, as the reference's init(key): `key_words` are the
        two words of the key the reference is given (default (0, seed), what
        jax.random.PRNGKey(seed) holds); the run keeps the second half of its
        split. Then every right-sizing the reference measures: SE tile R,
        hydro cell capacity and density split, rows slack, contact_K and
        kmc_K; and the free-space tile R, hydro cell capacity and hydro K,
        which the reference does not measure."""
        c = self.config
        key = (0, c.seed & 0xFFFFFFFF) if key_words is None else tuple(int(k) for k in key_words)
        run_key = fold_in(key, 1)  # jax.random.split(key)[1] for threefry keys
        rng = np.random.default_rng(c.seed)
        pos = self._initial_positions(rng)
        if self.spectral is not None or self.freespace is not None or self.periodic:
            p = pos.cpu().numpy()
            if self.spectral is not None:
                self._right_size_hydro(p)
            if self.freespace is not None:
                self._right_size_freespace(p, pos)
            if self.periodic:
                self._right_size_rows(p)
            if self._mesh is not None:
                self._make_sharded_se()

        # bead parts + selector: crosslinker homes and targets come from
        # `binding_selector` over the declared parts
        per = c.beads_per_chain
        chain_pos = np.arange(self.N) % per
        hetero = chain_pos < max(1, int(round(c.hetero_fraction * per)))
        dev = self.device
        self.beads = EntitySet(
            fields={},
            parts={"hetero": torch.as_tensor(hetero, device=dev),
                   "euchro": torch.as_tensor(~hetero, device=dev),
                   "chain_end": torch.as_tensor((chain_pos == 0) | (chain_pos == per - 1),
                                                device=dev)},
            active=torch.ones(self.N, dtype=torch.bool, device=dev), capacity=self.N)
        self.bind_allowed = select(self.beads, c.binding_selector)
        allowed_idx = np.nonzero(self.bind_allowed.cpu().numpy())[0]
        if allowed_idx.size == 0:
            raise ValueError(f"binding_selector {c.binding_selector!r} selects no beads")
        home = torch.as_tensor(
            allowed_idx[rng.integers(0, allowed_idx.size, size=max(self.X, 1))][: self.X],
            dtype=torch.int32, device=dev)
        xl = LinkSet(indices=torch.stack([home, home], dim=1),
                     active=torch.zeros(self.X, dtype=torch.bool, device=dev),
                     fields={"state": torch.full((self.X,), BINDING_STATE.LEFT_BOUND,
                                                 dtype=torch.int32, device=dev)},
                     targets=("beads", "beads"))
        nmat, hmat, kmat, ovf = self._build_nmat(pos, home)
        # right-size the candidate capacities from the measured occupancy:
        # every step gathers (N, contact_K) and (X, kmc_K) rows
        resize = False
        if not bool(nmat.overflow):
            kmax = int(nmat.mask.sum(1).max())
            tight = max(12, ((int(kmax * 1.6) + 4 + 3) // 4) * 4)
            if tight < self.contact_K:
                self.contact_K = tight
                resize = True
        if self.X > 0 and not bool(kmat.overflow):
            kk = int(kmat.mask.sum(1).max())
            tightk = max(16, ((int(kk * 1.5) + 8 + 7) // 8) * 8)
            if tightk < self.kmc_K:
                self.kmc_K = tightk
                resize = True
        if resize:
            nmat, hmat, kmat, ovf = self._build_nmat(pos, home)
        return ChromatinState(pos=pos, xl=xl, key=run_key, step=0, nmat=nmat,
                              hydro_nmat=hmat, kmc_nmat=kmat, ref_pos=pos,
                              rebuild_count=1, overflow=ovf)

    def broad_phase(self) -> str:
        """Which broad phase the contact search takes at the current capacities:
        "rows" (the row layout and kernel K2) or "cell_list"."""
        return "rows" if self._rows_grid(self.search_radius, self.contact_K) else "cell_list"

    def _rows_grid(self, search_radius: float, max_neighbors: int):
        """The row grid of the contact search when the row layout is
        feasible at this shape (a periodic box of >= 5 cells per axis, within
        K2's envelope on the card), else None."""
        c = self.config
        if not self.periodic or int((2 * self.domain) // (2 * search_radius)) < 5:
            return None
        rg = make_row_grid([0, 0, 0], (c.box_size,) * 3, 2.0 * float(search_radius), self.N,
                           capacity_slack=self.rows_slack, align=8, device=self.device)
        n_excl = self.exclude.shape[1]
        return rg if rows_extract_feasible(rg, max_neighbors + n_excl) else None

    def _build_search(self, pos: torch.Tensor, search_radius: float, max_neighbors: int):
        """The contact search at its own cutoff: the row broad phase (K2)
        with the bonded exclusions as a post-filter when feasible, else the
        cell list with the exclusion table."""
        c = self.config
        rg = self._rows_grid(search_radius, max_neighbors)
        if rg is not None:
            n_excl = self.exclude.shape[1]
            nmat = neighbor_matrix_rows(pos, float(search_radius), (c.box_size,) * 3,
                                        max_neighbors=max_neighbors + n_excl,
                                        capacity_slack=self.rows_slack, grid=rg)
            excl_hit = (nmat.idx[:, :, None] == self.exclude[:, None, :]).any(-1)
            nmat = nmat._replace(mask=nmat.mask & ~excl_hit,
                                 idx=torch.where(excl_hit, self.N, nmat.idx))
            return nmat, nmat.overflow
        clist = build_cell_list(pos, self.grid, self.cell_capacity)
        nmat = neighbor_matrix(pos, clist, search_radius,
                               metric=self.metric if self.periodic else None,
                               max_neighbors=max_neighbors,
                               chunk=min(c.chunk, max(256, self.N)), exclude=self.exclude)
        return nmat, clist.overflow | nmat.overflow

    def _min_image(self, d: torch.Tensor) -> torch.Tensor:
        if not self.periodic:
            return d
        box = self.config.box_size
        return d - box * torch.round(d / box)

    def _component_seps(self, pos: torch.Tensor, home: torch.Tensor, idx: torch.Tensor):
        """(dx, dy, dz) from each crosslinker home to its candidates: three
        scalar gathers, minimum image per component (cubic box)."""
        hl, il = home.long(), idx.long()
        return tuple(self._min_image(pos[:, a][il] - pos[:, a][hl][:, None]) for a in range(3))

    def _make_sharded_se(self) -> None:
        """(Re)build the sharded spectral mobility at the current SE tile R
        and 3D-cell capacity (each rank's binning reuses the R right-sized
        for the whole N, a safe bound for any subset)."""
        from mundy_tpu_torch.parallel.spectral_shard import make_sharded_se_rpy_apply

        c = self.config
        self.sharded_se = make_sharded_se_rpy_apply(self._mesh, self.spectral, self.se_geom,
                                                    self.hydro_cells_grid, self.N,
                                                    (c.box_size,) * 3)

    def _build_kmc_candidates(self, pos: torch.Tensor, home: torch.Tensor):
        """Crosslinker candidates at their own cutoff (capture + skin): the X
        homes queried against a capture-radius cell list, compacted to the
        kmc_K in-cutoff slots. The skin trigger keeps them a superset of the
        in-capture partners between rebuilds. (X, kmc_K) NeighborMatrix."""
        c = self.config
        clist = build_cell_list(pos, self.kmc_grid, self.kmc_cell_capacity)
        cand = neighbor_candidates(pos[home.long()], clist)  # (X, 27 cap)
        dx, dy, dz = self._component_seps(pos, home, torch.clamp(cand, min=0))
        d2 = dx * dx + dy * dy + dz * dz
        cut = self.kmc_capture + c.skin
        ok = (cand >= 0) & (cand != home[:, None]) & (d2 < cut * cut)
        idx, mask, count = _compact_rows(cand, ok, self.kmc_K, self.N)
        ovf = clist.overflow | (count > self.kmc_K).any()
        return NeighborMatrix(idx=idx.to(torch.int32), mask=mask, overflow=ovf), ovf

    def _build_nmat(self, pos: torch.Tensor, home: torch.Tensor):
        """(contact nmat, hydro nmat, crosslinker candidates, overflow); the
        hydro search is its own only in rpy_periphery_spectral, at the
        free-space operator's cutoff."""
        c = self.config
        nmat, ovf = self._build_search(pos, self.search_radius, self.contact_K)
        if self.X > 0:
            kmat, kovf = self._build_kmc_candidates(pos, home)
            ovf = ovf | kovf
        else:
            kmat = nmat
        hmat = nmat
        if self.freespace is not None:
            hcl = build_cell_list(pos, self.fs_grid, self.fs_cell_capacity)
            hmat = neighbor_matrix(pos, hcl, self.fs_hydro_search, metric=None,
                                   max_neighbors=self.fs_hydro_K,
                                   chunk=min(c.chunk, max(256, self.N)))
            ovf = ovf | hcl.overflow | hmat.overflow
        return nmat, hmat, kmat, ovf

    # ------------------------------------------------------------------
    def _kmc(self, state: ChromatinState) -> ChromatinState:
        """Crosslinker bind/unbind sweep over the dedicated candidates,
        restricted to `binding_selector` beads."""
        c = self.config
        if self.X == 0:
            return state
        cand_idx = torch.clamp(state.kmc_nmat.idx, max=self.N - 1)
        cand_mask = state.kmc_nmat.mask & self.bind_allowed[cand_idx.long()]
        home = state.xl_home
        dx, dy, dz = self._component_seps(state.pos, home, cand_idx)
        dr = torch.sqrt(dx * dx + dy * dy + dz * dz)
        rates = binding_rate_gaussian(dr, c.crosslinker_k, c.crosslinker_rest_length, c.kt,
                                      c.binding_rate)
        out = crosslinker_kmc_step(state.key, state.step, state.xl_state, state.xl_bound_to,
                                   cand_idx, rates, cand_mask,
                                   koff=self._k["unbinding_rate"], dt=c.dt,
                                   gid=self._xl_gids)
        xl = state.xl
        indices = torch.stack([home, torch.where(out.bound_to >= 0, out.bound_to, home)],
                              dim=1)
        xl = xl.replace(indices=indices, active=out.state == BINDING_STATE.DOUBLY_BOUND,
                        fields={"state": out.state})
        return state.replace(xl=xl)

    def _forces(self, state: ChromatinState) -> torch.Tensor:
        c = self.config
        pos = state.pos
        k = self._k
        metric = self.metric if self.periodic else None
        f = fenewca_chain_forces(pos, c.beads_per_chain, k["backbone_k"], k["backbone_rmax"],
                                 k["sigma"], k["wca_epsilon"], metric=metric)
        f = f + hertzian_contact_forces(pos, k["bead_radius"], k["youngs_modulus"],
                                        k["poissons_ratio"], state.nmat, metric=metric)
        if self.X > 0:
            # active links are the doubly-bound springs
            f = f + hookean_spring_forces(pos, state.xl.indices[:, 0], state.xl.indices[:, 1],
                                          k["crosslinker_k"], k["crosslinker_rest_length"],
                                          mask=state.xl.active, metric=metric)
        if c.periphery_radius > 0:
            # spherical wall: Hertzian-like push-back of beads poking out
            r = torch.sqrt((pos * pos).sum(1))
            over = torch.clamp(r + c.bead_radius - c.periphery_radius, min=0.0)
            mag = c.periphery_stiffness * over * torch.sqrt(over)
            nhat = pos / torch.clamp(r, min=1e-12)[:, None]
            f = f - mag[:, None] * nhat
        return f

    def _velocity(self, state: ChromatinState, f: torch.Tensor):
        """(velocity, overflow) of the hydro mode, before the noise."""
        c = self.config
        if c.hydro == "none":
            return local_drag_mobility(f, c.bead_radius, c.viscosity), state.overflow
        if c.hydro == "rpy_spectral" and self.sharded_se is not None:
            # every rank holds the whole state: it passes its own block, and
            # the blocks of velocities are all-gathered
            g = self._mesh
            nl = self.N // g.size
            own = slice(g.rank * nl, (g.rank + 1) * nl)
            vel_l, se_ovf = self.sharded_se(state.pos[own], f[own], pos_all=state.pos, f_all=f)
            return torch.cat(g.all_gather(vel_l)), state.overflow | se_ovf
        if c.hydro == "rpy_spectral":
            pieces = se_bin_geom(self.se_geom, state.pos, self.dtype)
            if self.hydro_split is not None:
                c_ex, dc_cap = self.hydro_split
                cells = build_cells3d_split(state.pos, self.hydro_split_grid, c_ex, dc_cap)
            else:
                cells = build_cells3d(state.pos, self.hydro_cells_grid)
            vel, se_ovf = se_rpy_apply_cells(self.spectral, cells, state.pos, f,
                                             (c.box_size,) * 3, self.se_geom, pieces=pieces)
            # both the SE binning and the 3D cells drop bodies on overflow
            return vel, state.overflow | cells.overflow | se_ovf
        if c.hydro in _PERIPHERY_MODES:
            overflow = state.overflow
            if c.hydro == "rpy_periphery":
                vel = rpy_apply_dense(state.pos, f, c.bead_radius, c.viscosity,
                                      overlap_correction=True)
            else:
                vel, fs_ovf = freespace_rpy_apply(self.freespace, state.pos, f,
                                                  state.hydro_nmat, geom=self.fs_geom)
                overflow = overflow | fs_ovf  # the binning drops bodies on overflow
            # the ambient flow at the quadrature nodes, exact over all beads
            # (O(N Q)), then the densities and their double-layer flow
            u_surf = rpy_flow_at(self.periphery.points, state.pos, f, c.bead_radius,
                                 c.viscosity)
            return vel + no_slip_correction(self.periphery, u_surf, state.pos), overflow
        return rpy_apply_neighbors(state.pos, f, state.nmat, c.bead_radius, c.viscosity,
                                   overlap_correction=True), state.overflow

    def _inner_step(self, state: ChromatinState) -> ChromatinState:
        c = self.config
        state = self._kmc(state)
        f = self._forces(state)
        vel, overflow = self._velocity(state, f)
        if c.diffusion_coeff > 0:
            # gid-keyed counter stream: a pure function of (key, step, gid)
            vel = vel + brownian_velocity_keyed(state.key, state.step, self._gids,
                                                c.diffusion_coeff, c.dt, dtype=self.dtype)
        new_pos = state.pos + self._dt * vel
        if self.periodic:
            new_pos = self.metric.wrap(new_pos)
        return state.replace(pos=new_pos, step=state.step + 1, overflow=overflow)

    def _rebuild(self, state: ChromatinState) -> ChromatinState:
        nmat, hmat, kmat, ovf = self._build_nmat(state.pos, state.xl_home)
        return state.replace(nmat=nmat, hydro_nmat=hmat, kmc_nmat=kmat, ref_pos=state.pos,
                             rebuild_count=state.rebuild_count + 1,
                             overflow=state.overflow | ovf)

    def _moved(self, state: ChromatinState) -> bool:
        """Has some bead moved more than skin/2 since the last rebuild (no
        minimum image: a wrap counts as a move, as in the reference)?"""
        disp = state.pos - state.ref_pos
        d2 = (disp * disp).sum(-1).max()
        if self._mesh is not None:  # every rank takes the same path through the collectives
            d2 = self._mesh.pmax(d2.reshape(1))[0]
        return bool(d2 > (0.5 * self.config.skin) ** 2)

    def run_block(self, state: ChromatinState, n_steps: int) -> ChromatinState:
        """n_steps steps, each preceded by a rebuild when the skin trigger
        fired; the host reads the trigger once per step."""
        fired = n_steps > 0 and self._moved(state)
        for i in range(n_steps):
            if fired:
                state = self._rebuild(state)
            state = self._inner_step(state)
            fired = i + 1 < n_steps and self._moved(state)
        return state

    def regrow(self, state: ChromatinState) -> ChromatinState:
        """Grow every overflow-bounded capacity (contact cells and K, rows
        slack, KMC candidate cells and K, SE tile R, hydro cells and split,
        and the free-space tile R, hydro cells and K, which the reference
        leaves as they are) and rebuild the searches from the state's
        positions (driver/regrow.py)."""
        self.cell_capacity = grow_int(self.cell_capacity)
        self.contact_K = grow_int(self.contact_K)
        self.rows_slack *= 1.5
        if self.X > 0:
            self.kmc_cell_capacity = min(grow_int(self.kmc_cell_capacity), self.N)
            self.kmc_K = min(grow_int(self.kmc_K), self.N)
        if self.spectral is not None:
            self.se_geom = self.se_geom._replace(R=grow_int(self.se_geom.R))
            g3 = self.hydro_cells_grid
            self.hydro_cells_grid = g3.replace(capacity=grow_int(g3.capacity))
            if self.hydro_split is not None:
                c_ex, dc_cap = self.hydro_split
                self.hydro_split = (grow_int(c_ex), grow_int(dc_cap))
            if self._mesh is not None:
                self._make_sharded_se()
        if self.freespace is not None:
            self.fs_geom = self.fs_geom._replace(R=grow_int(self.fs_geom.R))
            self.fs_cell_capacity = grow_int(self.fs_cell_capacity)
            self.fs_hydro_K = grow_int(self.fs_hydro_K)
        nmat, hmat, kmat, ovf = self._build_nmat(state.pos, state.xl_home)
        return state.replace(nmat=nmat, hydro_nmat=hmat, kmc_nmat=kmat, ref_pos=state.pos,
                             overflow=ovf)

    def doubly_bound(self, state: ChromatinState) -> int:
        return int((state.xl_state == BINDING_STATE.DOUBLY_BOUND).sum()) if self.X else 0

    def run(self, state: Optional[ChromatinState] = None, log=print):
        c = self.config
        if state is None:
            state = self.init()

        def status(s, done, tps):
            return (f"step {done}/{c.num_steps}  tps={tps:.2f}  "
                    f"doubly_bound={self.doubly_bound(s)}/{self.X}  "
                    f"rebuilds={s.rebuild_count}  overflow={bool(s.overflow)}")

        return run_blocks(self, state, c.num_steps, c.log_every, log, status)
