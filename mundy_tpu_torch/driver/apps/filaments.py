"""BASELINE config #4: flexible filaments (flagella), chained
spherocylinder segments with Kirchhoff bending/twist mechanics and
collision.

Port of mundy_tpu/driver/apps/filaments.py. Per step:
    1. rod internal forces: the gradient of the discrete rod energy, by
       torch.autograd (mech/rod.py);
    2. segment-segment Hertzian contact across filaments (adjacent segments
       of one filament excluded), split to each segment's two nodes by the
       arc parameter of the contact;
    3. the optional active rest-curvature wave (the swimming drive);
    4. the overdamped resistive-force-theory node update, gid-keyed
       Brownian noise, and the edge-frame transport.

Two contact engines, as in the reference. `nmat` (the default): a neighbor
matrix, built in float32 with >= 5 cells per axis through the row layout
(kernel K2, ops/kernels/row_extract.py) with the adjacency post-filter,
otherwise by the cell list with the adjacency `exclude` table; its narrow
phase gathers candidates in plain PyTorch. `rows`: the segments live in the
dense row layout, and kernel K4's filaments op (ops/kernels/row_segments.py)
computes the node-split contact forces. The control flow is the
reference's: every block begins with a rebuild, and the skin test after
every inner step ends the inner loop; the host reads the trigger once per
step. State is (F, M, 3) node positions, each filament unwrapped relative
to its first node.
"""

from __future__ import annotations

import dataclasses
import math as _math
from typing import Optional, Union

import numpy as np
import torch

from mundy_tpu_torch.core.config import validate_config
from mundy_tpu_torch.core.containers import frozen_dataclass
from mundy_tpu_torch.driver.regrow import grow_int, run_blocks
from mundy_tpu_torch.dynamics.brownian import brownian_velocity_keyed
from mundy_tpu_torch.forces.contact import effective_youngs
from mundy_tpu_torch.geom.distance import segment_closest_planes
from mundy_tpu_torch.geom.periodicity import periodic
from mundy_tpu_torch.mech import RodState, init_rod_edges, rod_internal_forces, update_rod_edges
from mundy_tpu_torch.neighbor.cell_list import (
    NeighborMatrix,
    build_cell_list,
    make_cell_grid,
    neighbor_matrix,
)
from mundy_tpu_torch.neighbor.rows import (
    RowState,
    build_rows,
    make_row_grid,
    neighbor_matrix_rows,
    orthorhombic_lengths,
    rows_extract_feasible,
)
from mundy_tpu_torch.ops.kernels.row_segments import row_segment_filaments_sym

_DTYPES = {"float32": torch.float32, "float64": torch.float64}


def segment_contact_split_forces(payload_own, payload_all, idx, mask, box, two_r,
                                 r_eff, e_eff):
    """Hertzian segment-segment contact of `payload_own` rows against the
    candidates `idx` (masked by `mask`) gathered from `payload_all`; payload
    rows are [mid(3), half_edge(3)]. Returns (f_start, f_end), each
    (S_own, 3): the contact force split to the segment's two nodes by the
    arc parameter of the closest point. Candidates sit on (K, S_own)
    component planes, as in the reference. `box`: the orthorhombic
    ((lx, ly, lz), (px, py, pz)) of neighbor/rows.orthorhombic_lengths (the
    reference's triclinic branch has no caller in the port)."""
    n_all = payload_all.shape[0]
    cand = payload_all[torch.clamp(idx, max=n_all - 1).long()]  # (S_own, K, 6)
    candT = cand.permute(2, 1, 0)  # (6, K, S_own)
    ownT = payload_own.T
    SX = candT[0] - ownT[0][None, :]
    SY = candT[1] - ownT[1][None, :]
    SZ = candT[2] - ownT[2][None, :]
    (lx, ly, lz), (px, py, pz) = box
    if px:
        SX = SX - lx * torch.round(SX * (1.0 / lx))
    if py:
        SY = SY - ly * torch.round(SY * (1.0 / ly))
    if pz:
        SZ = SZ - lz * torch.round(SZ * (1.0 / lz))
    s, _t, DX, DY, DZ, d2 = segment_closest_planes(
        SX, SY, SZ, ownT[3][None, :], ownT[4][None, :], ownT[5][None, :],
        candT[3], candT[4], candT[5])
    d2c = torch.clamp(d2, min=1e-24)
    rinv = torch.rsqrt(d2c)
    delta = torch.clamp(-(d2c * rinv - two_r), min=0.0)
    # hertzian_pair_force with python-float constants: 4/3 E* sqrt(R*)
    # rounds to the working dtype once
    mag = (4.0 / 3.0) * e_eff * _math.sqrt(r_eff) * delta * torch.sqrt(delta)
    w = torch.where(mask.T, -(mag * rinv), 0.0)  # (K, S_own)
    fx, fy, fz = w * DX, w * DY, w * DZ
    ws, we = 1.0 - s, s
    f_start = torch.stack([(ws * fx).sum(0), (ws * fy).sum(0), (ws * fz).sum(0)], dim=-1)
    f_end = torch.stack([(we * fx).sum(0), (we * fy).sum(0), (we * fz).sum(0)], dim=-1)
    return f_start, f_end


def rft_velocity(pos, f, inv_drag, drag_anisotropy):
    """Resistive-force-theory mobility: v = F_par/gamma_par +
    F_perp/gamma_perp along the node tangent from the adjacent edges. The
    anisotropy is what turns a curvature wave into net propulsion."""
    edge_t = pos[:, 1:, :] - pos[:, :-1, :]
    edge_t = edge_t / torch.clamp(torch.linalg.vector_norm(edge_t, dim=-1, keepdim=True),
                                  min=1e-12)
    node_t = torch.cat([edge_t[:, :1, :], 0.5 * (edge_t[:, :-1, :] + edge_t[:, 1:, :]),
                        edge_t[:, -1:, :]], dim=1)
    node_t = node_t / torch.clamp(torch.linalg.vector_norm(node_t, dim=-1, keepdim=True),
                                  min=1e-12)
    f_par = torch.sum(f * node_t, dim=-1, keepdim=True) * node_t
    return inv_drag * (f_par + (f - f_par) / drag_anisotropy)


def rest_curvature_wave(step: int, n_fil: int, s_arc: torch.Tensor, amplitude,
                        wave_k, wave_omega, dt) -> torch.Tensor:
    """Active rest-curvature wave kappa0(s, t) = amplitude sin(wave_k s -
    wave_omega t) about the body-1 axis, (n_fil, n_edges - 1, 3) over the
    interior arc lengths `s_arc`; filament-independent. t = step * dt is
    taken in the working dtype on the host, as the reference rounds it."""
    k0 = s_arc.new_zeros((s_arc.shape[0], 3))
    if amplitude != 0.0:
        wt = wave_omega * (torch.tensor(step, dtype=s_arc.dtype) * dt)  # 0-d, host
        k0[:, 0] = amplitude * torch.sin(wave_k * s_arc - wt)
    return k0.expand(n_fil, -1, -1)


@dataclasses.dataclass
class FilamentsConfig:
    num_filaments: int = 64
    nodes_per_filament: int = 16
    segment_length: float = 1.0
    radius: float = 0.25
    bend_modulus: float = 5.0
    stretch_stiffness: float = 200.0
    youngs_modulus: float = 500.0
    poissons_ratio: float = 0.3
    viscosity: float = 1.0
    # resistive-force-theory drag anisotropy: gamma_perp / gamma_par. 1.0 =
    # isotropic (no self-propulsion possible); slender-body value ~2.
    drag_anisotropy: float = 2.0
    diffusion_coeff: float = 0.0
    # active curvature wave (sperm swimming): kappa0(s, t) =
    # amplitude * sin(wave_k * s - wave_omega * t) about the body-1 axis
    active_amplitude: float = 0.0
    wave_k: float = 1.0
    wave_omega: float = 1.0
    box_size: float = 40.0
    dt: float = 1e-4
    num_steps: int = 100
    skin: float = 0.3
    max_neighbors: int = 24
    cell_capacity: int = 16
    chunk: int = 8192
    seed: int = 1234
    dtype: str = "float64"
    log_every: int = 100
    # "nmat" = neighbor-matrix narrow phase (the default: robust to chains
    # aligned with the row axis), "rows" = dense row-block engine with
    # kernel K4's filaments op, "auto" = nmat
    contact_engine: str = "auto"

    def __validate__(self):
        assert self.nodes_per_filament >= 3
        assert self.contact_engine in ("auto", "rows", "nmat")


@frozen_dataclass
class FilamentsState:
    pos: torch.Tensor  # (F, M, 3), each filament unwrapped
    rod: RodState  # edge frames per filament
    key: tuple  # the run's two uint32 key words (python ints)
    step: int
    nmat: Union[RowState, NeighborMatrix]  # the contact engine's structure
    ref_pos: torch.Tensor  # (S, 3) segment midpoints at the last rebuild
    rebuild_count: int
    overflow: torch.Tensor  # () bool, sticky



def filaments_state_from_numpy(pos, edge_q, tangent, length, key, step, nmat,
                               ref_pos, rebuild_count, overflow,
                               device="cpu") -> FilamentsState:
    """A FilamentsState from the reference FilamentsState's arrays, to
    continue a JAX run in the port: pos (F, M, 3) and the RodState arrays
    edge_q (F, E, 4), tangent (F, E, 3), length (F, E), all in one dtype;
    key: the two uint32 words of the raw threefry key; step, rebuild_count:
    ints; nmat: the contact engine's structure, carried across with
    core/interop's row_state_from_numpy (rows engine) or
    neighbor_matrix_from_numpy; ref_pos: (S, 3) midpoints at the last
    rebuild; overflow: the sticky flag."""
    def t(a, dtype=None):
        return torch.as_tensor(np.array(a), dtype=dtype, device=device)

    pos = t(pos)
    rod = RodState(edge_q=t(edge_q), tangent=t(tangent), length=t(length))
    ref_pos = t(ref_pos)
    if any(a.dtype != pos.dtype for a in (*rod, ref_pos)):
        raise TypeError("positions, rod frames and ref_pos must share one dtype")
    k0, k1 = (int(w) for w in np.asarray(key, dtype=np.uint32).reshape(-1))
    return FilamentsState(pos=pos, rod=rod, key=(k0, k1), step=int(step), nmat=nmat,
                          ref_pos=ref_pos, rebuild_count=int(rebuild_count),
                          overflow=t(bool(overflow), torch.bool))

class FilamentsSim:
    """Filaments simulation for FilamentsConfig on one device (the card
    unless the caller asks for "cpu")."""

    def __init__(self, config: FilamentsConfig, device="cuda"):
        self.config = c = config
        validate_config(config)
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("FilamentsSim(device='cuda') needs a CUDA device, "
                               "and torch sees none")
        self.dtype = _DTYPES[c.dtype]
        self.F = c.num_filaments
        self.M = c.nodes_per_filament
        self.E = self.M - 1  # segments per filament
        self.S = self.F * self.E  # total segments
        box = [c.box_size] * 3
        kw = dict(dtype=self.dtype, device=self.device)
        self.metric = periodic(box, **kw)
        self.box_static = orthorhombic_lengths(self.metric)
        self.search_radius = 0.5 * c.segment_length + c.radius + 0.5 * c.skin
        self.grid = make_cell_grid([0, 0, 0], box, 2 * self.search_radius,
                                   (True,) * 3, **kw)
        # the default is the neighbor-matrix engine: a filament aligned near
        # the row (x) axis drops all its segments into one (y, z) row, so
        # the row engine's R follows the worst row (R = 728 for a mean row
        # occupancy of 24 at 2000 x 50)
        self.contact_engine = c.contact_engine if c.contact_engine != "auto" else "nmat"
        if self.contact_engine == "rows":
            # align=8 keeps the reference's slot layout
            self.row_grid = make_row_grid([0, 0, 0], box, 2 * self.search_radius,
                                          self.S, capacity_slack=1.9, align=8, **kw)
            if self.row_grid.ny < 5 or self.row_grid.nz < 5:
                self.contact_engine = "nmat"
        self.inv_drag = 1.0 / (6.0 * _math.pi * c.viscosity * c.radius)
        self.e_eff = effective_youngs(c.youngs_modulus, c.youngs_modulus,
                                      c.poissons_ratio, c.poissons_ratio)
        # rows-layout broad-phase capacity slack (grown by regrow)
        self.rows_slack = 1.9
        # adjacency exclusion table: same-filament neighbors k-1, k+1
        seg_ids = np.arange(self.S)
        k = seg_ids % self.E
        left = np.where(k > 0, seg_ids - 1, -1)
        right = np.where(k < self.E - 1, seg_ids + 1, -1)
        self.exclude = torch.as_tensor(np.stack([left, right], 1), dtype=torch.int32,
                                       device=self.device)
        self.dt = torch.tensor(c.dt, **kw)
        self._seg_gids = torch.arange(self.S, dtype=torch.int32, device=self.device)
        self._node_gids = torch.arange(self.F * self.M, dtype=torch.int32,
                                       device=self.device)
        self._s_arc = torch.arange(1, self.E, **kw) * c.segment_length

    # ------------------------------------------------------------------
    def _segments(self, pos: torch.Tensor):
        """(S, 3) starts, ends, midpoints from (F, M, 3) nodes."""
        a = pos[:, :-1, :].reshape(self.S, 3)
        b = pos[:, 1:, :].reshape(self.S, 3)
        return a, b, 0.5 * (a + b)

    def _rows_extract_grid(self):
        c = self.config
        return make_row_grid([0, 0, 0], (c.box_size,) * 3, 2 * float(self.search_radius),
                             self.S, capacity_slack=self.rows_slack, dtype=self.dtype,
                             align=8, device=self.device)

    def _build_nmat(self, pos: torch.Tensor):
        c = self.config
        _a, _b, mid = self._segments(pos)
        if self.contact_engine == "rows":
            rows = build_rows(mid, self._seg_gids, self.row_grid)
            return rows, rows.overflow
        # the neighbor matrix through the row layout (K2) where the row
        # extraction admits the grid: the adjacency exclusion rides as 2
        # extra neighbor lanes and a post-filter
        n_cells = int(c.box_size // (2 * self.search_radius))
        if self.dtype == torch.float32 and n_cells >= 5:
            k_want = c.max_neighbors + 2
            rg = self._rows_extract_grid()
            if rows_extract_feasible(rg, k_want):
                nmat = neighbor_matrix_rows(mid, float(self.search_radius),
                                            (c.box_size,) * 3, max_neighbors=k_want,
                                            grid=rg)
                excl_hit = (nmat.idx[:, :, None] == self.exclude[:, None, :]).any(-1)
                nmat = nmat._replace(mask=nmat.mask & ~excl_hit,
                                     idx=torch.where(excl_hit, self.S, nmat.idx))
                return nmat, nmat.overflow
        clist = build_cell_list(mid, self.grid, c.cell_capacity)
        nmat = neighbor_matrix(mid, clist, self.search_radius, metric=self.metric,
                               max_neighbors=c.max_neighbors,
                               chunk=min(c.chunk, max(256, self.S)),
                               exclude=self.exclude)
        return nmat, clist.overflow | nmat.overflow

    def _contact_node_forces(self, pos: torch.Tensor, nmat) -> torch.Tensor:
        """Hertzian segment contact -> node forces (F, M, 3), by the engine
        the search structure was built for."""
        c = self.config
        if self.contact_engine == "rows":
            f_start, f_end = self._contact_split_rows(pos, nmat)
        else:
            a, b, mid = self._segments(pos)
            payload = torch.cat([mid, 0.5 * (b - a)], dim=1)  # (S, 6): mid, half-edge
            f_start, f_end = segment_contact_split_forces(
                payload, payload, nmat.idx, nmat.mask, self.box_static,
                2.0 * c.radius, float(0.5 * c.radius), float(self.e_eff))
        node_f = torch.zeros((self.F, self.M, 3), dtype=self.dtype, device=self.device)
        node_f[:, :-1, :] += f_start.reshape(self.F, self.E, 3)
        node_f[:, 1:, :] += f_end.reshape(self.F, self.E, 3)
        return node_f

    def row_contact_args(self, pos: torch.Tensor, rows: RowState) -> tuple:
        """The arguments that the row engine's step passes to kernel K4's
        filaments op (ops/kernels/row_segments.row_segment_filaments_sym) at
        nodes `pos` on the row layout `rows`: the current midpoints and
        half-edges refreshed into the layout by one gather, the mask, the
        gids and the contact constants."""
        a, b, mid = self._segments(pos)
        e = 0.5 * (b - a)  # half-edge: a = mid - e, b = mid + e
        safe = torch.clamp(rows.gid.long(), max=self.S - 1)
        row_mid = torch.where(rows.valid[..., None], mid[safe], rows.pos)
        row_e = torch.where(rows.valid[..., None], e[safe], 0.0)
        return (row_mid, row_e, rows.valid, rows.gid, self.box_static[0],
                self.config.radius, self.e_eff, self.E)

    def _contact_split_rows(self, pos: torch.Tensor, rows: RowState):
        """The row engine's narrow phase (kernel K4's filaments op), its
        node-split force sums scattered back to segments."""
        fs_rows, fe_rows = row_segment_filaments_sym(*self.row_contact_args(pos, rows))
        idx = torch.where(rows.valid.reshape(-1), rows.gid.reshape(-1).long(), self.S)
        out = []
        for f_rows in (fs_rows, fe_rows):
            f = torch.zeros((self.S + 1, 3), dtype=self.dtype, device=self.device)
            f[idx] = f_rows.reshape(-1, 3)  # gids are unique; index S is the dump
            out.append(f[:self.S])
        return out

    def _inner_step(self, state: FilamentsState) -> FilamentsState:
        c = self.config
        pos = state.pos
        k0 = rest_curvature_wave(state.step, self.F, self._s_arc, c.active_amplitude,
                                 c.wave_k, c.wave_omega, c.dt)
        f_rod, tau = rod_internal_forces(state.rod, pos, k0, c.bend_modulus,
                                         c.stretch_stiffness, c.segment_length)
        f = f_rod + self._contact_node_forces(pos, state.nmat)
        vel = rft_velocity(pos, f, self.inv_drag, c.drag_anisotropy)
        if c.diffusion_coeff > 0:
            # gid-keyed counter stream: a pure function of (key, step, gid)
            bv = brownian_velocity_keyed(state.key, state.step, self._node_gids,
                                         c.diffusion_coeff, c.dt, dtype=self.dtype)
            vel = vel + bv.reshape(self.F, self.M, 3)
        new_pos = pos + self.dt * vel
        rod = update_rod_edges(state.rod, new_pos, twist_rate=self.inv_drag * tau,
                               dt=self.dt)
        return state.replace(pos=new_pos, rod=rod, step=state.step + 1)

    def _rebuild(self, state: FilamentsState) -> FilamentsState:
        nmat, ovf = self._build_nmat(state.pos)
        return state.replace(nmat=nmat, ref_pos=self._segments(state.pos)[2],
                             rebuild_count=state.rebuild_count + 1,
                             overflow=state.overflow | ovf)

    def _skin_fired(self, state: FilamentsState) -> bool:
        disp = self.metric.sep(state.ref_pos, self._segments(state.pos)[2])
        return bool((disp * disp).sum(-1).max() > (0.5 * self.config.skin) ** 2)

    def run_block(self, state: FilamentsState, n_steps: int) -> FilamentsState:
        """n_steps steps: a rebuild at the start of the block and after every
        step that moved a segment midpoint beyond skin/2, as in the
        reference."""
        done = 0
        while done < n_steps:
            state = self._rebuild(state)
            fired = False
            while done < n_steps and not fired:
                state = self._inner_step(state)
                done += 1
                # the trigger only decides the next iteration: skip the
                # read (and its sync) once the block is complete
                fired = done < n_steps and self._skin_fired(state)
        return state

    # ------------------------------------------------------------------
    def init(self, pos: Optional[torch.Tensor] = None,
             key_words: Optional[tuple] = None) -> FilamentsState:
        """Initial state. With no arguments: straight filaments from start
        points drawn uniformly in the box along normal-drawn directions,
        from a torch.Generator seeded with config.seed, wrapped and then
        unwrapped relative to each filament's first node; the key is
        (0, seed), what jax.random.PRNGKey(seed) holds, not the key the JAX
        `init` splits off, so the default trajectories differ. Pass `pos`
        (F, M, 3), the unwrapped nodes the JAX `init` returns, and
        `key_words` to start from its state. Then, as the reference: the rod
        frames, the row-slack right-sizing of the float32 row-extraction
        build, and the grow-then-tighten row capacity of the row engine."""
        c = self.config
        if self.E * c.segment_length + 2 * c.radius >= c.box_size / 2:
            raise ValueError("filament longer than half the box")
        kw = dict(dtype=self.dtype, device=self.device)
        if pos is None:
            gen = torch.Generator(device=self.device).manual_seed(c.seed)
            start = torch.rand((self.F, 3), generator=gen, **kw) * c.box_size
            d = torch.randn((self.F, 3), generator=gen, **kw)
            d = d / torch.linalg.vector_norm(d, dim=1, keepdim=True)
            arc = torch.arange(self.M, **kw) * c.segment_length
            pos = start[:, None, :] + arc[None, :, None] * d[:, None, :]
            pos = self.metric.wrap(pos.reshape(-1, 3)).reshape(self.F, self.M, 3)
            pos = pos[:, :1, :] + self.metric.sep(pos[:, :1, :], pos)
        pos = torch.as_tensor(pos, **kw)
        if key_words is None:
            key_words = (0, c.seed & 0xFFFFFFFF)
        rod = init_rod_edges(pos)
        n_cells = int(c.box_size // (2 * self.search_radius))
        if self.contact_engine == "nmat" and self.dtype == torch.float32 and n_cells >= 5:
            # right-size the row-extraction slack from the measured midpoint
            # row occupancy: a straight filament near the x axis drops all
            # its segments into one (y, z) row (~15x the mean)
            rg = self._rows_extract_grid()
            p = np.mod(self._segments(pos)[2].cpu().numpy(), c.box_size)
            iy = np.clip((p[:, 1] / (c.box_size / rg.ny)).astype(int), 0, rg.ny - 1)
            iz = np.clip((p[:, 2] / (c.box_size / rg.nz)).astype(int), 0, rg.nz - 1)
            occ = int(np.bincount(iy * rg.nz + iz, minlength=rg.ny * rg.nz).max())
            need = int(occ * 1.3) + 8
            if need > rg.row_capacity:
                mean = self.S / (rg.ny * rg.nz)
                self.rows_slack = max(self.rows_slack, (need - 8) / mean)
        nmat, ovf = self._build_nmat(pos)
        if self.contact_engine == "rows":
            # right-size the row capacity from the measured max occupancy:
            # grow until the build fits (on overflow the measure is capped),
            # then tighten once
            for _ in range(8):
                if not bool(ovf):
                    break
                R = self.row_grid.row_capacity
                self.row_grid = self.row_grid.replace(row_capacity=((int(R * 1.5) + 7) // 8) * 8)
                nmat, ovf = self._build_nmat(pos)
            occ = int(nmat.valid.reshape(-1, self.row_grid.row_capacity).sum(1).max())
            tight = ((int(occ * 1.125) + 4 + 7) // 8) * 8
            if tight != self.row_grid.row_capacity:
                self.row_grid = self.row_grid.replace(row_capacity=tight)
                nmat, ovf = self._build_nmat(pos)
        return FilamentsState(pos=pos, rod=rod, key=tuple(int(k) for k in key_words),
                              step=0, nmat=nmat, ref_pos=self._segments(pos)[2],
                              rebuild_count=1, overflow=ovf)

    def regrow(self, state: FilamentsState) -> FilamentsState:
        """Grow the neighbor capacities and rebuild (driver/regrow.py)."""
        c = self.config
        c.cell_capacity = grow_int(c.cell_capacity)
        c.max_neighbors = grow_int(c.max_neighbors)
        if self.contact_engine == "rows":
            self.row_grid = self.row_grid.replace(
                row_capacity=grow_int(self.row_grid.row_capacity))
        self.rows_slack *= 1.5
        nmat, ovf = self._build_nmat(state.pos)
        return state.replace(nmat=nmat, ref_pos=self._segments(state.pos)[2],
                             overflow=ovf)

    def run(self, state: Optional[FilamentsState] = None, log=print):
        c = self.config
        if state is None:
            state = self.init()

        def status(s, done, tps):
            return (f"step {done}/{c.num_steps}  tps={tps:.2f}  "
                    f"rebuilds={s.rebuild_count}  overflow={bool(s.overflow)}")

        return run_blocks(self, state, c.num_steps, c.log_every, log, status)
