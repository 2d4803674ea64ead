"""Sharded filaments: rod mechanics and segment contact over the ranks.

Port of mundy_tpu/parallel/filaments_shard.py over the ranks of a Group, the
filaments counterpart of parallel/chromatin_shard.py:

- each rank owns whole filaments (F % d == 0): the Kirchhoff rod internal
  forces, the edge-frame transport and the RFT mobility never cross ranks;
- the segment midpoints and half-edges are all-gathered once a step, one
  (S, 6) all_gather;
- each rank rebuilds only its own neighbor rows (`neighbor_matrix_query`
  against a cell list over all midpoints) and runs the neighbor-matrix
  narrow phase (driver/apps/filaments.segment_contact_split_forces) on its
  own segments, the arithmetic of FilamentsSim's `nmat` engine; it does not
  run kernel K4's filaments op, as the reference's engine does not;
- the noise is gid-keyed by node, so the stream is the single-device one.

The block loop rebuilds at every entry and then when the skin trigger (a
pmax of the midpoints' minimum-image displacement) fires, FilamentsSim's
cadence. On its cell-list search (float64) the trajectory is
FilamentsSim's until the first rebuild inside a block; from there the rows'
candidate order differs and the contact sums round differently.
"""

from __future__ import annotations

import torch

from mundy_tpu_torch.dynamics.brownian import brownian_velocity_keyed
from mundy_tpu_torch.mech import RodState, rod_internal_forces, update_rod_edges
from mundy_tpu_torch.neighbor.cell_list import build_cell_list, neighbor_matrix_query
from mundy_tpu_torch.parallel.chromatin_shard import ShardEngine
from mundy_tpu_torch.parallel.comm import Group
from mundy_tpu_torch.parallel.slab_rows import run_block


def filaments_shard_rules(config, d: int) -> None:
    """Raise ValueError, naming the rule, for a FilamentsConfig that the
    sharded filaments engine cannot split over d ranks."""
    if config.num_filaments % d != 0:
        raise ValueError(f"the sharded filaments engine needs num_filaments % ranks == 0 "
                         f"(ranks own whole filaments): {config.num_filaments} filaments over "
                         f"{d} ranks")


def make_sharded_filaments_step(group: Group, sim) -> ShardEngine:
    """The sharded filaments engine of `sim` (a FilamentsSim on this rank's
    device) on this rank of `group`, at the config's current max_neighbors
    and cell_capacity. The state dict counts `step` and `rebuild_count`
    (python ints, the same on every rank) and holds the sticky `overflow` of
    this rank."""
    from mundy_tpu_torch.driver.apps.filaments import (
        rest_curvature_wave,
        rft_velocity,
        segment_contact_split_forces,
    )

    c = sim.config
    d, r, dev = group.size, group.rank, sim.device
    filaments_shard_rules(c, d)
    F, M, E = sim.F, sim.M, sim.E
    Fl = F // d
    Sl = Fl * E
    K = c.max_neighbors
    own = slice(r * Fl, (r + 1) * Fl)
    seg_gids = torch.arange(r * Sl, (r + 1) * Sl, dtype=torch.int32, device=dev)
    node_gids = torch.arange(r * Fl * M, (r + 1) * Fl * M, dtype=torch.int32, device=dev)
    exclude = sim.exclude[r * Sl:(r + 1) * Sl]
    chunk = min(c.chunk, max(256, Sl))
    two_r, r_eff, e_eff = 2.0 * c.radius, float(0.5 * c.radius), float(sim.e_eff)

    def shard(state) -> dict:
        # empty contact rows: the block rebuilds at entry before a step reads them
        return {"pos": state.pos[own].clone(), "rod_q": state.rod.edge_q[own].clone(),
                "rod_t": state.rod.tangent[own].clone(),
                "rod_l": state.rod.length[own].clone(),
                "nmat_idx": torch.full((Sl, K), sim.S, dtype=torch.int32, device=dev),
                "nmat_mask": torch.zeros((Sl, K), dtype=torch.bool, device=dev),
                "ref_pos": state.ref_pos[r * Sl:(r + 1) * Sl].clone(),
                "key": tuple(state.key), "step": int(state.step),
                "rebuild_count": int(state.rebuild_count), "overflow": state.overflow.clone()}

    def payload(pos_own: torch.Tensor) -> torch.Tensor:
        """(Sl, 6) [midpoint, half-edge] of this rank's segments."""
        a = pos_own[:, :-1, :].reshape(Sl, 3)
        b = pos_own[:, 1:, :].reshape(Sl, 3)
        return torch.cat([0.5 * (a + b), 0.5 * (b - a)], dim=1)

    def inner_step(st: dict) -> dict:
        pos = st["pos"]
        rod = RodState(edge_q=st["rod_q"], tangent=st["rod_t"], length=st["rod_l"])
        k0 = rest_curvature_wave(st["step"], Fl, sim._s_arc, c.active_amplitude, c.wave_k,
                                 c.wave_omega, c.dt)
        f_rod, tau = rod_internal_forces(rod, pos, k0, c.bend_modulus, c.stretch_stiffness,
                                         c.segment_length)
        pay_own = payload(pos)
        pay_all = torch.cat(group.all_gather(pay_own))
        f_start, f_end = segment_contact_split_forces(pay_own, pay_all, st["nmat_idx"],
                                                      st["nmat_mask"], sim.box_static, two_r,
                                                      r_eff, e_eff)
        node_f = torch.zeros((Fl, M, 3), dtype=sim.dtype, device=dev)
        node_f[:, :-1, :] += f_start.reshape(Fl, E, 3)
        node_f[:, 1:, :] += f_end.reshape(Fl, E, 3)
        vel = rft_velocity(pos, f_rod + node_f, sim.inv_drag, c.drag_anisotropy)
        if c.diffusion_coeff > 0:
            bv = brownian_velocity_keyed(st["key"], st["step"], node_gids, c.diffusion_coeff,
                                         c.dt, dtype=sim.dtype)
            vel = vel + bv.reshape(Fl, M, 3)
        new_pos = pos + sim.dt * vel
        rod = update_rod_edges(rod, new_pos, twist_rate=sim.inv_drag * tau, dt=sim.dt)
        return {**st, "pos": new_pos, "rod_q": rod.edge_q, "rod_t": rod.tangent,
                "rod_l": rod.length, "step": st["step"] + 1}

    def moved(st: dict) -> bool:
        disp = sim.metric.sep(st["ref_pos"], payload(st["pos"])[:, :3])
        d2 = group.pmax((disp * disp).sum(-1).max().reshape(1))[0]
        return bool(d2 > (0.5 * c.skin) ** 2)

    def rebuild(st: dict) -> dict:
        pay_own = payload(st["pos"])
        mid_all = torch.cat(group.all_gather(pay_own))[:, :3]
        clist = build_cell_list(mid_all, sim.grid, c.cell_capacity)
        nmat = neighbor_matrix_query(mid_all, clist, pay_own[:, :3], seg_gids,
                                     sim.search_radius, metric=sim.metric, max_neighbors=K,
                                     chunk=chunk, exclude=exclude)
        return {**st, "nmat_idx": nmat.idx, "nmat_mask": nmat.mask, "ref_pos": pay_own[:, :3],
                "overflow": st["overflow"] | clist.overflow | nmat.overflow,
                "rebuild_count": st["rebuild_count"] + 1}

    def step_block(st: dict, n_steps: int) -> dict:
        return run_block(st, n_steps, rebuild, inner_step, moved)

    def gather(st: dict) -> dict:
        """The whole arrays on every rank: positions (F, M, 3) and the rod
        frames, the overflow OR'd over ranks."""
        out = {name: torch.cat(group.all_gather(st[name]))
               for name in ("pos", "rod_q", "rod_t", "rod_l")}
        out["overflow"] = group.pmax(st["overflow"].reshape(1).to(torch.int32))[0] > 0
        return out

    return ShardEngine(shard, step_block, gather)
