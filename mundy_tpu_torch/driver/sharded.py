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

App -> engine routes ported so far:

| app         | engine                           | decomposition |
|-------------|----------------------------------|---------------|
| spheres     | parallel/slab_rows.py (K6)       | z-slab rows   |
| lcp_spheres | parallel/balanced_lcp.py         | balanced z-slabs (count-allocated) |
| rods        | parallel/slab_segments.py (K4)   | z-slab rows   |
| granular    | parallel/granular_shard.py       | balanced z-slabs + migrating history |

The spheres route takes the flat SpheresSim's state (the app the CLI runs)
or RowSpheresSim's, the rods route RodsSim's or RowRodsSim's, the
lcp_spheres route LCPSpheresState's positions, key and step, the granular
route GranularState's positions and velocities; each refuses what its
engine does not run (polydisperse spheres; ellipsoids and friction; LCP
hydro modes other than "none"). The balanced engines need at least two
ranks. The other apps' engines wait (ROADMAP queue 1, item 8): chromatin
(step 3: chromatin_shard) and filaments (step 4: filaments_shard).

`regrow` grows what overflowed and re-shards from the last good state. The
slab engines grow their row capacity (driver/regrow.grow_int, as the
single-device row engines grow theirs; the reference's wrapper grows
max_neighbors and cell_capacity, which no slab engine reads: ROADMAP queue
3). The balanced engines grow max_neighbors and cell_capacity, as the
reference's wrapper does, and, where the engine's overflow bits name them,
the own and ghost buffers (own_slack, ghost_slack), which the reference's
regrow cannot cure. A ghost two ring hops away (a slab thinner than the
ghost margin) no capacity cures: regrow raises, naming the contract (ROADMAP
queue 3).
"""

from __future__ import annotations

from typing import Optional

import torch

from mundy_tpu_torch.driver.regrow import grow_int
from mundy_tpu_torch.neighbor.rows import build_rows
from mundy_tpu_torch.parallel.balanced_slab import OVF_GHOST, OVF_HOP, OVF_OWN, ovf_bits_of
from mundy_tpu_torch.parallel.comm import Group

_DTYPES = {"float32": torch.float32, "float64": torch.float64}
# the apps whose sharded engines wait, with their step of ROADMAP item 8
WAITING = {"chromatin": 3, "filaments": 4}
ROUTED = ("spheres", "rods", "lcp_spheres", "granular")
BALANCED = ("lcp_spheres", "granular")


def refuse_unported(app: str) -> None:
    """Raise NotImplementedError for an app whose sharded engine is not
    ported, naming its step of ROADMAP queue 1 item 8."""
    if app in WAITING:
        raise NotImplementedError(
            f"--devices > 1: the sharded engine of app '{app}' is not ported yet "
            f"(ROADMAP queue 1, item 8 step {WAITING[app]})")
    if app not in ROUTED:
        raise ValueError(f"--devices > 1: no sharded engine for app '{app}'")


class ShardedSim:
    """Wraps `sim` (this rank's copy) so run_block steps over the ranks of
    `group`. States in and out are ordinary app states; the engine's slab
    state is held between blocks."""

    def __init__(self, app: str, sim, group: Group, row_capacity: Optional[int] = None,
                 own_slack: float = 1.5, ghost_slack: float = 3.0):
        refuse_unported(app)
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
        if self.app == "spheres":
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
        buffers where the overflow bits name them. Raises for a ghost two
        ring hops away, which no capacity cures."""
        if self.app in BALANCED:
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
