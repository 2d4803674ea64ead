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

| app     | engine                         | decomposition |
|---------|--------------------------------|---------------|
| spheres | parallel/slab_rows.py (K6)     | z-slab rows   |
| rods    | parallel/slab_segments.py (K4) | z-slab rows   |

The spheres route takes the flat SpheresSim's state (the app the CLI runs)
or RowSpheresSim's, the rods route RodsSim's or RowRodsSim's; each refuses
what its engine does not run (polydisperse spheres; ellipsoids and
friction). The other apps' engines wait (ROADMAP queue 1, item 8):
lcp_spheres and granular (step 2: balanced_lcp, granular_shard), chromatin
(step 3: chromatin_shard) and filaments (step 4: filaments_shard).

`regrow` grows the slab engine's row capacity (driver/regrow.grow_int, as
the single-device row engines grow theirs) and re-shards from the last good
state; the reference's wrapper grows max_neighbors and cell_capacity, which
no slab engine reads (ROADMAP queue 3).
"""

from __future__ import annotations

from typing import Optional

import torch

from mundy_tpu_torch.driver.regrow import grow_int
from mundy_tpu_torch.neighbor.rows import build_rows
from mundy_tpu_torch.parallel.comm import Group

_DTYPES = {"float32": torch.float32, "float64": torch.float64}
# the apps whose sharded engines wait, with their step of ROADMAP item 8
WAITING = {"lcp_spheres": 2, "granular": 2, "chromatin": 3, "filaments": 4}


def refuse_unported(app: str) -> None:
    """Raise NotImplementedError for an app whose sharded engine is not
    ported, naming its step of ROADMAP queue 1 item 8."""
    if app in WAITING:
        raise NotImplementedError(
            f"--devices > 1: the sharded engine of app '{app}' is not ported yet "
            f"(ROADMAP queue 1, item 8 step {WAITING[app]})")
    if app not in ("spheres", "rods"):
        raise ValueError(f"--devices > 1: no sharded engine for app '{app}'")


class ShardedSim:
    """Wraps `sim` (this rank's copy) so run_block steps over the ranks of
    `group`. States in and out are ordinary app states; the engine's slab
    state is held between blocks."""

    def __init__(self, app: str, sim, group: Group, row_capacity: Optional[int] = None):
        refuse_unported(app)
        self.app = app
        self.sim = sim
        self.config = sim.config
        self.group = group
        self.row_capacity = row_capacity
        self._dict = None
        self._build()

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
        quat = self.sim.quaternions(state) if hasattr(state, "rows") else state.quat
        return self.engine.init(pos, state.key, state.step, quat=quat)

    def _gather(self, dd: dict, state):
        """The slab state -> the app state on every rank (positions, and
        quaternions, scattered by gid from an all_gather of every slab; the
        step; the overflow flag OR'd over ranks)."""
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

    # ------------------------------------------------------------------
    def run_block(self, state, n_steps: int):
        if self._dict is None:
            self._dict = self._shard(state)
        self._dict = self.engine.step_block(self._dict, n_steps)
        out = self._gather(self._dict, state)
        if bool(out.overflow):
            # drop the slab state: regrow re-shards from the last good state
            self._dict = None
        return out

    def regrow(self, state):
        """Grow the slab engine's row capacity and re-shard at the next
        block (from `state`, the last good one)."""
        self.row_capacity = grow_int(self.engine.grid.row_capacity)
        self._dict = None
        self._build()
        return state.replace(overflow=torch.zeros((), dtype=torch.bool,
                                                  device=state.overflow.device))
