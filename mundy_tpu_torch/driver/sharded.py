"""Multi-rank execution from the production CLI: `--devices N`.

Port of mundy_tpu/driver/sharded.py. The reference's drivers run at any rank
count with no app change (`mpirun -n N`). The reference wraps a
single-device app sim and routes its steps onto the app's sharded engine
over a device mesh; the port is SPMD over torch.distributed instead: every
rank builds the app sim and a `ShardedSim` around it with its
parallel.comm.Group, shards the app state at the first block, steps the
engine, and gathers back (an all_gather) the ordinary app state on every
rank, so checkpoints, the results broker and the regrow loop work
unchanged. Between blocks the engine's own slab state stays with the
wrapper.

App -> engine routes:

| app         | engine                                        | decomposition |
|-------------|-----------------------------------------------|---------------|
| spheres     | parallel/slab_rows.py (K6)                    | z-slab rows   |
| lcp_spheres | parallel/balanced_lcp.py                      | balanced z-slabs (count-allocated) |
| rods        | parallel/slab_segments.py (K4)                | z-slab rows   |
| filaments   | parallel/filaments_shard.py                   | whole-filament blocks |
| chromatin   | parallel/chromatin_shard.py (K5s, K5i with rpy_spectral) | whole-chain blocks |
| granular    | parallel/granular_shard.py                    | balanced z-slabs + migrating history |

The spheres route takes the flat SpheresSim's state (the app the CLI runs)
or RowSpheresSim's, the rods route RodsSim's or RowRodsSim's, the
lcp_spheres route LCPSpheresState's positions, key and step, the granular
route GranularState's positions and velocities, the chromatin and filaments
routes the whole app state (every rank holds it; the engine keeps its own
block). Each route refuses what its engine does not run (polydisperse
spheres; ellipsoids and friction; LCP hydro modes other than "none"), and
`refuse_unported`, which main calls before any rank starts, refuses
chromatin hydro modes other than "none", "rpy_spectral" and
"rpy_periphery", and chains, crosslinkers, filaments or rpy_ring spheres
that do not split evenly over the ranks. The balanced engines need at least
two ranks.

LCP `hydro="rpy_ring"` takes no ShardedSim: LCPSpheresSim(config,
group=group) is distributed itself (every rank holds the whole state, the
ring shards the mobility, as the reference's LCPSpheresSim over a mesh of
every visible device), so `rank_sim` hands main that sim on each rank.

`regrow` grows what overflowed and re-shards from the last good state. The
slab engines grow their row capacity (driver/regrow.grow_int, as the
single-device row engines grow theirs; the reference's wrapper grows
max_neighbors and cell_capacity, which no slab engine reads: ROADMAP queue
3). The balanced engines grow max_neighbors and cell_capacity, as the
reference's wrapper does, and, where the engine's overflow bits name them,
the own and ghost buffers (own_slack, ghost_slack), which the reference's
regrow cannot cure. A ghost two ring hops away (a slab thinner than the
ghost margin) no capacity cures: regrow raises, naming the contract (ROADMAP
queue 3). The filaments route grows max_neighbors and cell_capacity, as the
reference's wrapper does. The chromatin engine reads its capacities from the
sim, so its route runs the sim's own regrow: the contact K and cells, the
KMC candidates, the SE tile R and the 3D-cell capacity (the reference's
wrapper grows only max_neighbors and cell_capacity, so an SE or hydro-cell
overflow never cures there: ROADMAP queue 3). Both engines are built anew
at the next block, at the sim's capacities of that moment (after init's
right-sizing too).
"""

from __future__ import annotations

from typing import Optional

import torch

from mundy_tpu_torch.driver.regrow import grow_int
from mundy_tpu_torch.neighbor.rows import build_rows
from mundy_tpu_torch.parallel.balanced_slab import OVF_GHOST, OVF_HOP, OVF_OWN, ovf_bits_of
from mundy_tpu_torch.parallel.chromatin_shard import (
    chromatin_shard_rules,
    make_sharded_chromatin_step,
)
from mundy_tpu_torch.parallel.comm import Group
from mundy_tpu_torch.parallel.filaments_shard import (
    filaments_shard_rules,
    make_sharded_filaments_step,
)
from mundy_tpu_torch.parallel.ring_rpy import ring_split_rule

_DTYPES = {"float32": torch.float32, "float64": torch.float64}
ROUTED = ("spheres", "rods", "lcp_spheres", "granular", "chromatin", "filaments")
BALANCED = ("lcp_spheres", "granular")
BLOCKS = ("chromatin", "filaments")  # the whole-chain and whole-filament block engines


def ring_route(app: str, config) -> bool:
    """Whether the app runs over ranks as LCPSpheresSim(group=) itself."""
    return app == "lcp_spheres" and config.hydro == "rpy_ring"


def refuse_unported(app: str, config=None, d: int = 1) -> None:
    """Raise ValueError, before any rank starts, for what no sharded engine
    runs over d ranks: an app with no route or a config its engine cannot
    split (each message names the rule)."""
    if app not in ROUTED:
        raise ValueError(f"--devices > 1: no sharded engine for app '{app}'")
    if config is None:
        return
    if ring_route(app, config):
        ring_split_rule(config.num_spheres, d)
    if app == "chromatin":
        chromatin_shard_rules(config, d)
    elif app == "filaments":
        filaments_shard_rules(config, d)


def rank_sim(spec: dict, group: Group) -> tuple:
    """(config, sim, plan line) of this rank of `--devices N` for an app
    spec: LCPSpheresSim over the group for LCP rpy_ring, else ShardedSim
    around the app's sim."""
    from mundy_tpu_torch.driver.configurator import build_simulation, config_from_spec

    app, config = config_from_spec(spec)
    if ring_route(app, config):
        from mundy_tpu_torch.driver.apps.lcp_spheres import LCPSpheresSim

        d = group.size
        return (config, LCPSpheresSim(config, device=group.device, group=group),
                f"sharded over {d} ranks: LCP rpy_ring, every rank the whole state, the "
                f"mobility ring-rotated in blocks of {config.num_spheres // d} spheres")
    config, sim = build_simulation(spec, device=group.device)
    sim = ShardedSim(app, sim, group)
    return config, sim, sim.describe()


class ShardedSim:
    """Wraps `sim` (this rank's copy) so run_block steps over the ranks of
    `group`. States in and out are ordinary app states; the engine's slab
    state is held between blocks."""

    def __init__(self, app: str, sim, group: Group, row_capacity: Optional[int] = None,
                 own_slack: float = 1.5, ghost_slack: float = 3.0):
        refuse_unported(app, sim.config, group.size)
        self.app = app
        self.sim = sim
        self.config = sim.config
        self.group = group
        self.row_capacity = row_capacity  # the slab engines
        self.own_slack, self.ghost_slack = own_slack, ghost_slack  # the balanced engines
        self._ovf_bits = 0  # the balanced engines' overflow bits of the last block
        self._dict = None
        self._build()

    def describe(self) -> str:
        """One line on the decomposition (main prints it on rank 0)."""
        eng, d = self.engine, self.group.size
        if self.app == "chromatin":
            c = self.config
            return (f"sharded over {d} ranks: the whole-chain block chromatin engine, "
                    f"{c.num_chains // d} chains and {c.num_crosslinkers // d} crosslinkers "
                    f"per rank, hydro {c.hydro}")
        if self.app == "filaments":
            return (f"sharded over {d} ranks: the whole-filament block filaments engine, "
                    f"{self.config.num_filaments // d} filaments per rank")
        if self.app in BALANCED:
            return (f"sharded over {d} ranks: the density-balanced z-slab {self.app} engine, "
                    f"own capacity {eng.n_cap} and ghost capacity {eng.g_cap} per rank")
        return (f"sharded over {d} ranks: the {eng.grid.nz}-plane z-slab engine, "
                f"{eng.nzl} planes per rank, {eng.rebuild_mode} rebuilds")

    # the sim surface that main and the broker use
    def positions(self, state):
        fn = getattr(self.sim, "positions", None)
        return fn(state) if fn is not None else state.pos

    def init(self, *args, **kwargs):
        return self.sim.init(*args, **kwargs)

    # ------------------------------------------------------------------
    def _build(self):
        c, g = self.config, self.group
        dtype = _DTYPES[c.dtype]
        if self.app in BLOCKS:
            # built at the next _shard, at the sim's capacities then
            self.engine = None
        elif self.app == "spheres":
            if getattr(c, "polydispersity", 0.0):
                raise ValueError("--devices: the sharded spheres engine needs equal radii "
                                 "(polydispersity=0)")
            from mundy_tpu_torch.parallel.slab_rows import make_slab_rows_spheres_step

            self.engine = make_slab_rows_spheres_step(
                g, n_total=c.num_spheres, box_size=c.box_size, radius=c.radius,
                youngs=c.youngs_modulus, poisson=c.poissons_ratio, viscosity=c.viscosity,
                diffusion=c.diffusion_coeff, dt=c.dt, skin=c.skin, dtype=dtype,
                row_capacity=self.row_capacity)
        elif self.app == "lcp_spheres":
            if c.hydro != "none" or getattr(c, "polydispersity", 0.0):
                raise ValueError("--devices: the sharded LCP engine runs the dry "
                                 "equal-radius pipeline (hydro='none', polydispersity=0)")
            from mundy_tpu_torch.parallel.balanced_lcp import make_balanced_lcp_step

            self.engine = make_balanced_lcp_step(
                g, n_total=c.num_spheres, box_size=c.box_size, radius=c.radius, dt=c.dt,
                viscosity=c.viscosity, diffusion_coeff=c.diffusion_coeff,
                constraint_buffer=c.constraint_buffer,
                max_allowable_overlap=c.max_allowable_overlap,
                max_col_iterations=min(c.max_col_iterations, 1000), own_slack=self.own_slack,
                ghost_slack=self.ghost_slack, max_neighbors=c.max_neighbors,
                cell_capacity=c.cell_capacity, dtype=dtype)
        elif self.app == "granular":
            from mundy_tpu_torch.parallel.granular_shard import make_granular_slab_step

            self.engine = make_granular_slab_step(
                g, n_total=c.num_spheres, box_size=c.box_size, radius=c.radius,
                density=c.density, gravity=c.gravity, friction_coeff=c.friction_coeff,
                normal_spring=c.normal_spring, normal_damping=c.normal_damping,
                tang_spring=c.tang_spring, tang_damping=c.tang_damping,
                wall_spring=c.wall_spring, dt=c.dt, skin=c.skin, own_slack=self.own_slack,
                ghost_slack=self.ghost_slack, max_neighbors=c.max_neighbors,
                cell_capacity=c.cell_capacity, dtype=dtype)
        else:
            if c.shape != "spherocylinder" or c.friction:
                raise ValueError("--devices: the sharded rods engine runs the frictionless "
                                 "spherocylinder narrow phase")
            from mundy_tpu_torch.parallel.slab_segments import make_slab_rods_step

            self.engine = make_slab_rods_step(
                g, n_total=c.num_rods, box_size=c.box_size, length=c.length,
                radius=c.radius, youngs=c.youngs_modulus, poisson=c.poissons_ratio,
                viscosity=c.viscosity, diffusion=c.diffusion_coeff,
                rot_diffusion=c.rot_diffusion_coeff, dt=c.dt, skin=c.skin, dtype=dtype,
                row_capacity=self.row_capacity)

    # ------------------------------------------------------------------
    def _shard(self, state) -> dict:
        """The engine's slab state from an app state: positions (and
        quaternions) in gid order; the key and step from the state, so the
        keyed noise continues the single-device stream."""
        if self.app in BLOCKS:
            make = (make_sharded_chromatin_step if self.app == "chromatin"
                    else make_sharded_filaments_step)
            self.engine = make(self.group, self.sim)
            return self.engine.shard(state)
        pos = self.positions(state)
        if self.app == "spheres":
            return self.engine.init(pos, state.key, state.step)
        if self.app == "lcp_spheres":
            return self.engine.init(state.key, pos=pos, step0=state.step)
        if self.app == "granular":
            return self.engine.init(pos, state.vel)
        quat = self.sim.quaternions(state) if hasattr(state, "rows") else state.quat
        return self.engine.init(pos, state.key, state.step, quat=quat)

    def _gather(self, dd: dict, state, n_done: int):
        """The engine's state -> the app state on every rank (positions, and
        quaternions or velocities, scattered by gid from an all_gather of
        every rank's buffer; the step; the overflow flag OR'd over ranks)."""
        if self.app in BALANCED:
            return self._gather_balanced(dd, state, n_done)
        if self.app in BLOCKS:
            return self._gather_blocks(dd, state)
        n = self.config.num_spheres if self.app == "spheres" else self.config.num_rods
        chans = [dd["pos"]] + ([dd["quat"]] if self.app == "rods" else [])
        vals = torch.cat(chans + [dd["valid"][..., None].to(dd["pos"].dtype)], dim=-1)
        vals = torch.cat(self.group.all_gather(vals), dim=1).reshape(-1, vals.shape[-1])
        gid = torch.cat(self.group.all_gather(dd["gid"]), dim=1).reshape(-1)
        valid = (vals[:, -1] > 0.5) & (gid < n)
        flat = torch.zeros((n + 1, vals.shape[1] - 1), dtype=vals.dtype, device=vals.device)
        if self.app == "rods":
            flat[:, 3] = 1.0  # the identity for a rod a build dropped
        flat[torch.where(valid, gid.to(torch.int64), n)] = vals[:, :-1]
        flat = flat[:n]
        ovf = self.group.pmax(dd["overflow"].reshape(1).to(torch.int32))[0] > 0
        pos = flat[:, :3].contiguous()
        sim, step = self.sim, dd["step"]
        if self.app == "spheres":
            if hasattr(state, "rows"):  # RowSpheresState: re-sort into its rows
                rows = build_rows(pos, sim._gids(), sim.grid)
                return state.replace(rows=rows, step=step, overflow=ovf | rows.overflow)
            return state.replace(pos=pos, ref_pos=pos, step=step, overflow=ovf)
        quat = flat[:, 3:].contiguous()
        if hasattr(state, "rows"):  # RowRodsState
            rows = build_rows(pos, sim._gids(), sim.grid)
            return state.replace(rows=rows, quat=sim._payload_to_rows(quat, rows), step=step,
                                 overflow=ovf | rows.overflow)
        return state.replace(pos=pos, quat=quat, ref_pos=pos, step=step, overflow=ovf)

    def _gather_balanced(self, dd: dict, state, n_done: int):
        g = self.group
        self._ovf_bits = ovf_bits_of(g, dd)
        ovf = torch.tensor(self._ovf_bits > 0, device=dd["pos"].device)
        if self.app == "granular":
            pos, vel = self.engine.gather(dd)
            return state.replace(pos=pos, vel=vel, ref_pos=pos, step=state.step + n_done,
                                 overflow=ovf)
        pos = self.engine.gather(dd)
        # every rank steps and solves alike; the max over ranks, as the reference's
        counts = g.pmax(torch.tensor([dd["step"], dd["lcp_iters"]], device=pos.device))
        return state.replace(pos=pos, ref_pos=pos, step=int(counts[0]),
                             lcp_iters=int(counts[1]), overflow=ovf)

    def _gather_blocks(self, dd: dict, state):
        """The block engines' state -> the app state: positions, rod frames
        or the crosslinker state and targets, the step, the rebuild count,
        the overflow OR'd over ranks. The chromatin state also takes the
        engine's positions of its last rebuild and the sim's own searches
        at them, so a checkpoint resumes the engine's rebuild cadence and
        KMC rows; the filaments engine rebuilds at every block entry, so its
        state keeps the searches of its input state with their positions."""
        g = self.engine.gather(dd)
        st = state.replace(pos=g["pos"], step=dd["step"], rebuild_count=dd["rebuild_count"],
                           overflow=g["overflow"])
        if self.app == "filaments":
            return st.replace(rod=state.rod._replace(edge_q=g["rod_q"], tangent=g["rod_t"],
                                                     length=g["rod_l"]))
        xl = state.xl
        if "xl_state" in g:
            indices = torch.stack([xl.indices[:, 0], g["xl_target"]], dim=1)
            xl = xl.replace(indices=indices, active=g["xl_active"],
                            fields={**xl.fields, "state": g["xl_state"]})
        nmat, hmat, kmat, ovf = self.sim._build_nmat(g["ref_pos"], xl.indices[:, 0])
        return st.replace(xl=xl, nmat=nmat, hydro_nmat=hmat, kmc_nmat=kmat,
                          ref_pos=g["ref_pos"], overflow=st.overflow | ovf)

    # ------------------------------------------------------------------
    def run_block(self, state, n_steps: int):
        if self._dict is None:
            self._dict = self._shard(state)
        self._dict = self.engine.step_block(self._dict, n_steps)
        out = self._gather(self._dict, state, n_steps)
        if bool(out.overflow):
            # drop the engine's state: regrow re-shards from the last good state
            self._dict = None
        return out

    def regrow(self, state):
        """Grow what overflowed and re-shard at the next block (from `state`,
        the last good one): the slab engines' row capacity; the balanced
        engines' max_neighbors and cell_capacity, and their own and ghost
        buffers where the overflow bits name them; the filaments engine's
        max_neighbors and cell_capacity; the chromatin engine's, which are
        the sim's, through the sim's own regrow. Raises for a ghost two ring hops
        away, which no capacity cures."""
        if self.app == "chromatin":
            # the engine reads its capacities from the sim: the contact K and
            # cells, the KMC candidates, the SE tile R and the 3D cells
            state = self.sim.regrow(state)
        elif self.app == "filaments":
            c = self.config
            c.max_neighbors = grow_int(c.max_neighbors)
            c.cell_capacity = grow_int(c.cell_capacity)
        elif self.app in BALANCED:
            bits = self._ovf_bits
            if bits & OVF_HOP:
                raise RuntimeError(
                    f"--devices {self.group.size}: a slab of the {self.app} engine is thinner "
                    "than its ghost margin (the one-hop ghost contract); no capacity cures "
                    "that: run on fewer ranks")
            c = self.config
            c.max_neighbors = grow_int(c.max_neighbors)
            c.cell_capacity = grow_int(c.cell_capacity)
            d = float(self.group.size)  # a slack of d holds every body
            if bits & OVF_OWN:
                self.own_slack = min(self.own_slack * 1.5, d)
            if bits & OVF_GHOST:
                self.ghost_slack = min(self.ghost_slack * 1.5, d)
        else:
            self.row_capacity = grow_int(self.engine.grid.row_capacity)
        self._dict = None
        self._build()
        return state.replace(overflow=torch.zeros((), dtype=torch.bool,
                                                  device=state.overflow.device))
