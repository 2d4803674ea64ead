"""Full-step sharded chromatin: contact, FENE, KMC, springs and the hydro
modes over the ranks.

Port of mundy_tpu/parallel/chromatin_shard.py over the ranks of a Group (one
process per rank; the reference's psum is `Group.psum`, its tiled
all_gather `torch.cat(Group.all_gather(...))`, its pmax `Group.pmax`, its
axis index `group.rank`):

- beads are split into index blocks of whole chains (FENE bonds never cross
  ranks), crosslinkers into index blocks;
- positions are all-gathered once a step: every rank holds the whole (N, 3)
  array, the ghost exchange of a system whose contacts are dense and global;
- each rank rebuilds only its own neighbor rows (`neighbor_matrix_query`
  against a cell list over all beads: the rows of the single-device
  cell-list search) and its own crosslinkers' candidate rows, computes
  contact, FENE-WCA and wall forces for its own beads and KMC for its own
  crosslinkers with gid-keyed draws, so the stream is the single-device
  one;
- the crosslinker springs touch any bead and are summed by one (N, 3) psum;
- hydro "rpy_spectral" runs parallel/spectral_shard.make_se_local_apply on
  the gathered positions (K5s and K5i on each rank's own beads); hydro
  "rpy_periphery" runs the dense RPY of this rank's target rows against all
  sources, its own beads' part of the flow at the quadrature nodes (one
  psum), its (3Q/d, 3Q) row slab of M^-1 (full float32 products, no TF32)
  and one all_gather of the densities.

The block loop is ChromatinSim's: a rebuild before a step when the skin
trigger, a pmax of the plain displacement, fired; every rank reads the same
reduced values and takes the same path through the collectives. Sharding a
state searches its rows again at its reference positions, so the rows, and
the KMC picks that depend on their order, are the single-device sim's at
every step, across blocks too (the reference's engine rebuilds at every
block entry, which reorders the candidate rows and changes the picks). With
no crosslinkers and hydro "none" the trajectory is the single-device
ChromatinSim's bit for bit (on its cell-list search); the crosslinker psum
and the hydro reductions sum in another order.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from mundy_tpu_torch.dynamics.brownian import brownian_velocity_keyed
from mundy_tpu_torch.forces.contact import hertzian_contact_forces
from mundy_tpu_torch.forces.springs import fenewca_chain_forces, hookean_spring_forces
from mundy_tpu_torch.kmc.crosslinkers import (
    BINDING_STATE,
    binding_rate_gaussian,
    crosslinker_kmc_step,
)
from mundy_tpu_torch.mobility.local_drag import local_drag_mobility
from mundy_tpu_torch.mobility.periphery import double_layer_flow
from mundy_tpu_torch.mobility.rpy import _rpy_pair_velocity, rpy_flow_at, rpy_self_mobility
from mundy_tpu_torch.neighbor.cell_list import (
    NeighborMatrix,
    build_cell_list,
    neighbor_matrix_query,
)
from mundy_tpu_torch.parallel.comm import Group

HYDRO_MODES = ("none", "rpy_spectral", "rpy_periphery")


class ShardEngine(NamedTuple):
    """A whole-chain (or whole-filament) block engine on one rank:
    shard(app_state) -> this rank's state dict (every rank holds the whole
    app state); step_block(state, n_steps) -> state; gather(state) -> the
    whole arrays on every rank (a collective)."""

    shard: Callable
    step_block: Callable
    gather: Callable


def chromatin_shard_rules(config, d: int) -> None:
    """Raise ValueError, naming the rule, for a ChromatinConfig that the
    sharded chromatin engine cannot split over d ranks."""
    c = config
    if c.hydro not in HYDRO_MODES:
        raise ValueError(f"the sharded chromatin engine runs hydro {', '.join(HYDRO_MODES)}; "
                         f"got {c.hydro!r}")
    if c.num_chains % d != 0:
        raise ValueError(f"the sharded chromatin engine needs num_chains % ranks == 0 (ranks "
                         f"own whole chains): {c.num_chains} chains over {d} ranks")
    if c.num_crosslinkers % d != 0:
        raise ValueError(f"the sharded chromatin engine needs num_crosslinkers % ranks == 0: "
                         f"{c.num_crosslinkers} crosslinkers over {d} ranks")


def _blocks_of(n: int, d: int, r: int) -> slice:
    nl = n // d
    return slice(r * nl, (r + 1) * nl)


def make_sharded_chromatin_step(group: Group, sim) -> ShardEngine:
    """The sharded chromatin engine of `sim` (a ChromatinSim on this rank's
    device, after init) on this rank of `group`, at the sim's current
    capacities (contact_K, kmc_K, cell capacities, SE tile R, 3D-cell
    capacity: rebuild the engine after a regrow). The state dict counts
    `step` and `rebuild_count` (python ints, the same on every rank) and
    holds the sticky `overflow` of this rank."""
    c = sim.config
    d, r, dev = group.size, group.rank, sim.device
    chromatin_shard_rules(c, d)
    N, X = sim.N, sim.X
    Nl, Xl = N // d, X // d
    own = _blocks_of(N, d, r)
    xown = _blocks_of(X, d, r)
    K = sim.contact_K
    dtype = sim.dtype
    metric = sim.metric if sim.periodic else None
    k = sim._k
    gids = torch.arange(r * Nl, (r + 1) * Nl, dtype=torch.int32, device=dev)
    xl_gids = torch.arange(r * Xl, (r + 1) * Xl, dtype=torch.int32, device=dev)
    exclude = sim.exclude[own]
    chunk = min(c.chunk, max(256, Nl))

    se_apply = None
    if c.hydro == "rpy_spectral":
        from mundy_tpu_torch.parallel.spectral_shard import make_se_local_apply

        # the tile R and cell capacity right-sized for the whole N: a safe
        # bound for any rank's subset
        se_apply = make_se_local_apply(group, sim.spectral, sim.se_geom, sim.hydro_cells_grid,
                                       N, (c.box_size,) * 3)
    minv_blk = None
    if c.hydro == "rpy_periphery":
        m = sim.periphery.m_inv
        q3 = m.shape[0]
        rb = -(-q3 // d)  # the quadrature rows of M^-1 this rank holds
        minv_blk = torch.cat([m, m.new_zeros((d * rb - q3, q3))])[r * rb:(r + 1) * rb]

    def shard(state) -> dict:
        st = {"pos": state.pos[own].clone(), "ref_pos": state.ref_pos[own].clone(),
              "key": tuple(state.key),
              "step": int(state.step), "rebuild_count": int(state.rebuild_count),
              "overflow": state.overflow.clone()}
        if X > 0:
            st.update(xl_home=state.xl.indices[xown, 0].clone(),
                      xl_target=state.xl.indices[xown, 1].clone(),
                      xl_state=state.xl.fields["state"][xown].clone(),
                      xl_active=state.xl.active[xown].clone())
        # the rows of the state's last rebuild, searched again at its
        # reference positions: the single-device sim's rows (on its
        # cell-list search), whose order the KMC picks depend on
        return {**st, **_search(st, st["ref_pos"])}

    def gather_pos(pos_own: torch.Tensor) -> torch.Tensor:
        return torch.cat(group.all_gather(pos_own))

    def _forces_own(st: dict, pos_rep: torch.Tensor) -> torch.Tensor:
        """FENE-WCA plus contact forces on this rank's beads (the
        crosslinker springs and the wall follow, the single-device sum's
        order)."""
        pos = st["pos"]
        f = fenewca_chain_forces(pos, c.beads_per_chain, k["backbone_k"], k["backbone_rmax"],
                                 k["sigma"], k["wca_epsilon"], metric=metric)
        nmat = NeighborMatrix(idx=st["nmat_idx"], mask=st["nmat_mask"], overflow=None)
        return f + hertzian_contact_forces(pos, k["bead_radius"], k["youngs_modulus"],
                                           k["poissons_ratio"], nmat, metric=metric,
                                           sources=pos_rep)

    def _wall(pos: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
        if c.periphery_radius <= 0:
            return f
        rr = torch.sqrt((pos * pos).sum(1))
        over = torch.clamp(rr + c.bead_radius - c.periphery_radius, min=0.0)
        mag = c.periphery_stiffness * over * torch.sqrt(over)
        nhat = pos / torch.clamp(rr, min=1e-12)[:, None]
        return f - mag[:, None] * nhat

    def _kmc_own(st: dict, pos_rep: torch.Tensor) -> dict:
        cand_idx = torch.clamp(st["kmc_idx"], max=N - 1)
        cand_mask = st["kmc_mask"] & sim.bind_allowed[cand_idx.long()]
        home = st["xl_home"]
        dx, dy, dz = sim._component_seps(pos_rep, home, cand_idx)
        dr = torch.sqrt(dx * dx + dy * dy + dz * dz)
        rates = binding_rate_gaussian(dr, c.crosslinker_k, c.crosslinker_rest_length, c.kt,
                                      c.binding_rate)
        bound_to = torch.where(st["xl_active"], st["xl_target"], -1)
        out = crosslinker_kmc_step(st["key"], st["step"], st["xl_state"], bound_to, cand_idx,
                                   rates, cand_mask, koff=k["unbinding_rate"], dt=c.dt,
                                   gid=xl_gids)
        return {**st, "xl_state": out.state,
                "xl_target": torch.where(out.bound_to >= 0, out.bound_to, home),
                "xl_active": out.state == BINDING_STATE.DOUBLY_BOUND}

    def _periph_apply(pos_own, pos_rep, f_own, f_all) -> torch.Tensor:
        """The rpy_periphery mobility: dense RPY of this rank's target rows
        against all sources, the flow at the nodes summed over ranks, this
        rank's slab of q = -M^-1 u, one all_gather of q, the double-layer
        flow at the own beads."""
        a, mu = c.bead_radius, c.viscosity
        src = torch.arange(N, device=dev)
        parts = []
        step = min(1024, Nl)
        for start in range(0, Nl, step):
            tgt = pos_own[start:start + step]
            u = _rpy_pair_velocity(tgt[:, None, :] - pos_rep[None, :, :], f_all[None, :, :], a,
                                   mu, overlap_correction=True)
            same = (r * Nl + start + torch.arange(tgt.shape[0], device=dev))[:, None] == src
            parts.append(torch.where(same[..., None], 0.0, u).sum(1))
        vel = torch.cat(parts) + rpy_self_mobility(f_own, a, mu)
        u_surf = group.psum(rpy_flow_at(sim.periphery.points, pos_own, f_own, a, mu))
        if (u_surf.is_cuda and u_surf.dtype == torch.float32
                and torch.backends.cuda.matmul.allow_tf32):
            raise RuntimeError("the periphery densities need full float32 products: "
                               "torch.backends.cuda.matmul.allow_tf32 is on")
        q_blk = -torch.matmul(minv_blk, u_surf.reshape(-1))
        q = torch.cat(group.all_gather(q_blk))[:minv_blk.shape[1]].reshape(-1, 3)
        return vel + double_layer_flow(sim.periphery, q, pos_own)

    def inner_step(st: dict) -> dict:
        pos_rep = gather_pos(st["pos"])
        if X > 0:
            st = _kmc_own(st, pos_rep)
        f = _forces_own(st, pos_rep)
        if X > 0:
            f_xl = hookean_spring_forces(pos_rep, st["xl_home"], st["xl_target"],
                                         k["crosslinker_k"], k["crosslinker_rest_length"],
                                         mask=st["xl_active"], metric=metric)
            f = f + group.psum(f_xl)[own]
        f = _wall(st["pos"], f)
        overflow = st["overflow"]
        if se_apply is not None:
            f_all = gather_pos(f)
            vel, se_ovf = se_apply(st["pos"], f, pos_all=pos_rep, f_all=f_all)
            overflow = overflow | se_ovf
        elif minv_blk is not None:
            vel = _periph_apply(st["pos"], pos_rep, f, gather_pos(f))
        else:
            vel = local_drag_mobility(f, c.bead_radius, c.viscosity)
        if c.diffusion_coeff > 0:
            vel = vel + brownian_velocity_keyed(st["key"], st["step"], gids, c.diffusion_coeff,
                                                c.dt, dtype=dtype)
        new_pos = st["pos"] + sim._dt * vel
        if sim.periodic:
            new_pos = sim.metric.wrap(new_pos)
        return {**st, "pos": new_pos, "step": st["step"] + 1, "overflow": overflow}

    def moved(st: dict) -> bool:
        # the plain difference, as ChromatinSim's trigger: equal rebuild
        # cadences keep the KMC candidate rows equal
        disp = st["pos"] - st["ref_pos"]
        d2 = group.pmax((disp * disp).sum(-1).max().reshape(1))[0]
        return bool(d2 > (0.5 * c.skin) ** 2)

    def _search(st: dict, pos_own: torch.Tensor) -> dict:
        """This rank's contact rows and crosslinker candidates at the
        positions pos_own of its beads (every rank calls it: a gather)."""
        pos_rep = gather_pos(pos_own)
        clist = build_cell_list(pos_rep, sim.grid, sim.cell_capacity)
        nmat = neighbor_matrix_query(pos_rep, clist, pos_own, gids, sim.search_radius,
                                     metric=metric, max_neighbors=K, chunk=chunk,
                                     exclude=exclude)
        out = {"nmat_idx": nmat.idx, "nmat_mask": nmat.mask,
               "overflow": st["overflow"] | clist.overflow | nmat.overflow}
        if X > 0:
            kmat, kovf = sim._build_kmc_candidates(pos_rep, st["xl_home"])
            out.update(kmc_idx=kmat.idx, kmc_mask=kmat.mask, overflow=out["overflow"] | kovf)
        return out

    def rebuild(st: dict) -> dict:
        return {**st, **_search(st, st["pos"]), "ref_pos": st["pos"],
                "rebuild_count": st["rebuild_count"] + 1}

    def step_block(st: dict, n_steps: int) -> dict:
        """ChromatinSim.run_block's cadence: a rebuild before a step when the
        skin trigger fired, read once a step."""
        fired = n_steps > 0 and moved(st)
        for i in range(n_steps):
            if fired:
                st = rebuild(st)
            st = inner_step(st)
            fired = i + 1 < n_steps and moved(st)
        return st

    def gather(st: dict) -> dict:
        """The whole arrays on every rank: positions and the positions of
        the last rebuild (N, 3), the crosslinker state, target and active
        flag (X,), the overflow OR'd over ranks."""
        out = {"pos": gather_pos(st["pos"]), "ref_pos": gather_pos(st["ref_pos"]),
               "overflow": group.pmax(st["overflow"].reshape(1).to(torch.int32))[0] > 0}
        if X > 0:
            for key in ("xl_state", "xl_target"):
                out[key] = torch.cat(group.all_gather(st[key]))
            out["xl_active"] = torch.cat(group.all_gather(st["xl_active"].to(torch.int32))) > 0
        return out

    return ShardEngine(shard, step_block, gather)

