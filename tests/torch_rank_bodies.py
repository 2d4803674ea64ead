"""Bodies that the multi-rank tests run on each rank (parallel.comm.spawn_ranks).

A spawned rank imports its target by module name in a fresh interpreter, so
these live in a module that imports torch and the port only: never JAX,
never the JAX package. Each body returns numpy arrays on rank 0 (None on the
others); the tests compare them with the JAX reference in their own process.
"""

import functools
import sys

import numpy as np
import torch

from mundy_tpu_torch.parallel.balanced_lcp import make_balanced_lcp_step
from mundy_tpu_torch.parallel.balanced_slab import make_balanced_settling_step, ovf_bits_of
from mundy_tpu_torch.parallel.granular_shard import make_granular_slab_step
from mundy_tpu_torch.parallel.ring_rpy import make_replicated_ring_apply
from mundy_tpu_torch.parallel.slab_rows import make_slab_rows_spheres_step
from mundy_tpu_torch.parallel.slab_segments import make_slab_rods_step


def gather_planes(group, x: torch.Tensor) -> np.ndarray:
    """The (ny, nz, R, ...) global array of every rank's (ny, nzl, R, ...)
    slab, in plane order."""
    return torch.cat(group.all_gather(x), dim=1).numpy()


def ring_apply(group, pos, forces, radius, viscosity, overlap_correction):
    """The ring apply of the (N, 3) inputs, this rank's block through the
    ring and the velocities all_gathered; rank 0 returns them."""
    apply = make_replicated_ring_apply(group, pos.shape[0], radius, viscosity,
                                       include_self=True,
                                       overlap_correction=overlap_correction)
    full = apply(torch.as_tensor(pos), torch.as_tensor(forces)).numpy()
    return full if group.rank == 0 else None


def _slab_run(group, make, kw, init_args, init_kw, steps, mode):
    eng = make(group, rebuild_mode=mode, **kw)
    st = eng.init(*init_args, **init_kw)
    first = {k: gather_planes(group, st[k]) for k in ("gid", "valid")}
    st = eng.step_block(st, steps)
    out = {k: gather_planes(group, v) for k, v in st.items()
           if isinstance(v, torch.Tensor) and v.ndim >= 3}
    ovf = group.pmax(st["overflow"].reshape(1).to(torch.int32))
    out.update(init_gid=first["gid"], init_valid=first["valid"], rebuilds=st["rebuilds"],
               step=st["step"], overflow=bool(ovf[0]), mode=eng.rebuild_mode, nzl=eng.nzl,
               grid=(eng.grid.ny, eng.grid.nz, eng.grid.row_capacity))
    return out


def slab_pair(group, kind, kw, init_args, init_kw, steps):
    """The slab engine of `kind` ("rows" or "rods") over `steps` steps in
    local and in global rebuild mode from the same start; rank 0 returns
    {mode: gathered state arrays and counters}."""
    make = make_slab_rows_spheres_step if kind == "rows" else make_slab_rods_step
    kw = dict(kw, dtype=torch.float64)
    out = {mode: _slab_run(group, make, kw, init_args, init_kw, steps, mode)
           for mode in ("local", "global")}
    return out if group.rank == 0 else None


def sharded_blocks(group, app, cfg, init, blocks):
    """ShardedSim over the app's row sim (RowSpheresSim or RowRodsSim) on the
    CPU, from init(**init), over `blocks` blocks; rank 0 returns the
    gathered positions (and quaternions) and the step."""
    from mundy_tpu_torch.driver.apps.rods_rows import RowRodsSim
    from mundy_tpu_torch.driver.apps.spheres_rows import RowSpheresSim
    from mundy_tpu_torch.driver.sharded import ShardedSim

    sim = (RowSpheresSim if app == "spheres" else RowRodsSim)(cfg, device="cpu")
    runner = ShardedSim(app, sim, group)
    st = sim.init(**init)
    for n in blocks:
        st = runner.run_block(st, n)
    out = {"pos": sim.positions(st).numpy(), "step": st.step,
           "overflow": bool(st.overflow)}
    if app == "rods":
        out["quat"] = sim.quaternions(st).numpy()
    return out if group.rank == 0 else None


def _stacked(group, state, keys) -> dict:
    """{key: (d, ...) numpy stack of every rank's state[key]}."""
    return {k: torch.stack(group.all_gather(state[k])).numpy() for k in keys}


def _summary(group, state) -> dict:
    bits = ovf_bits_of(group, state)
    return {"ovf_bits": bits, "overflow": bits > 0}


def balanced_settling(group, kw, pos, blocks):
    """The balanced settling engine from `pos` over `blocks` blocks; rank 0
    returns every rank's buffers stacked (gid, valid, pos, bounds), the
    gathered positions with each body's owner count, the bounds at init and
    the rebuilds."""
    eng = make_balanced_settling_step(group, dtype=torch.float64, **kw)
    st = eng.init(pos)
    out = {"init": _summary(group, st), "bounds0": st["bounds"].numpy(),
           "counts0": torch.stack(group.all_gather(st["valid"].sum().reshape(1))).numpy()}
    if not out["init"]["overflow"]:
        for n in blocks:
            st = eng.step_block(st, n)
        pos_all, seen = eng.gather(st)
        out.update(_stacked(group, st, ("gid", "valid", "pos")), bounds=st["bounds"].numpy(),
                   gathered=pos_all.numpy(), seen=seen.numpy(), rebuilds=st["rebuilds"],
                   n_cap=eng.n_cap, **_summary(group, st))
    return out if group.rank == 0 else None


def balanced_lcp(group, kw, key_words, pos, steps):
    """The balanced LCP engine from `pos` over `steps` steps in one block;
    rank 0 returns the per-step BBPGD iterations, the gathered positions,
    the rebuilds and every rank's gid buffer."""
    eng = make_balanced_lcp_step(group, dtype=torch.float64, **kw)
    st = eng.init(key_words, pos=pos)
    init = _summary(group, st)
    st = eng.step_block(st, steps)
    out = {"init": init, "iters": st["iters"], "pos": eng.gather(st).numpy(),
           "rebuilds": st["rebuilds"], "step": st["step"], **_summary(group, st),
           **_stacked(group, st, ("gid", "valid"))}
    return out if group.rank == 0 else None


def granular_slab(group, kw, pos, vel, steps):
    """The granular engine from (pos, vel) over `steps` steps in one block;
    rank 0 returns the gathered positions and velocities, the rebuilds, the
    largest tangential history and every rank's gid buffer."""
    eng = make_granular_slab_step(group, dtype=torch.float64, **kw)
    st = eng.init(pos, vel)
    init = _summary(group, st)
    st = eng.step_block(st, steps)
    p, v = eng.gather(st)
    tang = group.pmax(st["tang"].abs().max().reshape(1))[0]
    out = {"init": init, "pos": p.numpy(), "vel": v.numpy(), "rebuilds": st["rebuild_count"],
           "step": st["step"], "tang_max": float(tang), **_summary(group, st),
           **_stacked(group, st, ("gid", "valid"))}
    return out if group.rank == 0 else None


def lcp_sharded(group, cfg, steps):
    """ShardedSim over LCPSpheresSim (CPU) from its init, in one block;
    rank 0 returns the positions, the step and the overflow flag."""
    from mundy_tpu_torch.driver.apps.lcp_spheres import LCPSpheresSim
    from mundy_tpu_torch.driver.sharded import ShardedSim

    sim = LCPSpheresSim(cfg, device="cpu")
    runner = ShardedSim("lcp_spheres", sim, group)
    st = runner.run_block(sim.init(), steps)
    out = {"pos": st.pos.numpy(), "step": st.step, "lcp_iters": st.lcp_iters,
           "overflow": bool(st.overflow), "describe": runner.describe()}
    return out if group.rank == 0 else None


def granular_sharded(group, cfg, pos, blocks):
    """ShardedSim over GranularSim (CPU) from its init with positions `pos`,
    over `blocks` blocks; rank 0 returns positions, velocities and step."""
    from mundy_tpu_torch.driver.apps.granular import GranularSim
    from mundy_tpu_torch.driver.sharded import ShardedSim

    sim = GranularSim(cfg, device="cpu")
    runner = ShardedSim("granular", sim, group)
    st = sim.init(pos=torch.as_tensor(pos))
    for n in blocks:
        st = runner.run_block(st, n)
    out = {"pos": st.pos.numpy(), "vel": st.vel.numpy(), "step": st.step,
           "overflow": bool(st.overflow)}
    return out if group.rank == 0 else None


def regrow_balanced(group, cfg, pos, steps, own_slack, max_neighbors):
    """ShardedSim over GranularSim with a tight own buffer and neighbor rows,
    regrown as main's loop does until a block completes; rank 0 returns the
    regrows, the capacities and slack after them, and the positions."""
    from mundy_tpu_torch.driver.apps.granular import GranularSim
    from mundy_tpu_torch.driver.sharded import ShardedSim

    cfg.max_neighbors = max_neighbors
    sim = GranularSim(cfg, device="cpu")
    runner = ShardedSim("granular", sim, group, own_slack=own_slack)
    s0 = sim.init(pos=torch.as_tensor(pos))
    bits, regrows = [], 0
    st = runner.run_block(s0, steps)
    while bool(st.overflow):
        bits.append(runner._ovf_bits)
        runner.regrow(s0)
        regrows += 1
        st = runner.run_block(s0, steps)
    out = {"regrows": regrows, "bits": bits, "own_slack": runner.own_slack,
           "max_neighbors": cfg.max_neighbors, "pos": st.pos.numpy(), "step": st.step}
    return out if group.rank == 0 else None


def hop_fault(group, cfg, pos):
    """ShardedSim over GranularSim from a start whose slabs are thinner than
    the ghost margin: rank 0 returns the overflow bits and regrow's error."""
    from mundy_tpu_torch.driver.apps.granular import GranularSim
    from mundy_tpu_torch.driver.sharded import ShardedSim

    sim = GranularSim(cfg, device="cpu")
    runner = ShardedSim("granular", sim, group)
    s0 = sim.init(pos=torch.as_tensor(pos))
    st = runner.run_block(s0, 1)
    err = None
    try:
        runner.regrow(s0)
    except RuntimeError as e:
        err = str(e)
    out = {"overflow": bool(st.overflow), "bits": runner._ovf_bits, "error": err}
    return out if group.rank == 0 else None


def lcp_over_ranks(group, a_diag, q, mask, tol):
    """solve_lcp on this rank's contiguous block of a diagonal-plus-coupling
    LCP (A = diag(a) + a ring coupling between neighbouring entries, applied
    with the blocks' edge values exchanged), the group in PGDConfig; rank 0
    returns the gathered iterate, and every rank its iteration count."""
    from mundy_tpu_torch.math.convex import PGDConfig, solve_lcp
    from mundy_tpu_torch.parallel.comm import ring_perms

    n = q.shape[0] // group.size
    sl = slice(group.rank * n, (group.rank + 1) * n)
    a = torch.as_tensor(a_diag[sl])
    up, dn = ring_perms(group.size)

    def apply_A(x):
        left = group.ppermute(x[-1:].contiguous(), up)  # the previous block's last
        right = group.ppermute(x[:1].contiguous(), dn)  # the next block's first
        xl = torch.cat([left, x[:-1]])
        xr = torch.cat([x[1:], right])
        return a * x - 0.25 * (xl + xr)

    cfg = PGDConfig(max_iters=500, tol=tol, group=group)
    res = solve_lcp(apply_A, torch.as_tensor(q[sl]), config=cfg, mask=torch.as_tensor(mask[sl]))
    x = torch.cat(group.all_gather(res.x)).numpy()
    iters = [int(v) for v in group.all_gather(torch.tensor([res.num_iters]))]
    return {"x": x, "iters": iters, "residual": float(res.residual)} if group.rank == 0 else None


def field_reductions(group, x, y, mask):
    """fieldops' reductions over the group on this rank's block; rank 0
    returns {name: value}."""
    from mundy_tpu_torch.state import fieldops as tf

    n = x.shape[0] // group.size
    sl = slice(group.rank * n, (group.rank + 1) * n)
    tx, ty, tm = (torch.as_tensor(v[sl]) for v in (x, y, mask))
    out = {"dot": tf.field_dot(tx, ty, tm, axis_names=group),
           "nrm2": tf.field_nrm2(tx, tm, axis_names=group),
           "asum": tf.field_asum(tx, tm, axis_names=group),
           "amax": tf.field_amax(tx, tm, axis_names=group),
           "amin": tf.field_amin(tx, tm, axis_names=group)}
    return {k: float(v) for k, v in out.items()} if group.rank == 0 else None


@functools.lru_cache(maxsize=None)
def _se_op(box: float, n: int):
    """The float64 spectral-Ewald operator of a test box (built once a rank)."""
    from mundy_tpu_torch.mobility.spectral import build_spectral_ewald

    return build_spectral_ewald(box, 0.5, 1.0, tol=1e-4, n_particles=n, dtype=torch.float64,
                                device="cpu")


def se_sharded(group, box, n, kind, pos, forces, slack):
    """The sharded spectral-Ewald apply (parallel/spectral_shard.py) over
    this rank's block of the (n, 3) inputs, float64, with the tile or rows
    geometry sized for n / d bodies times `slack`; rank 0 returns the
    gathered velocities, the overflow flag, the geometry and the cells'
    x-slab split."""
    from mundy_tpu_torch.mobility.spectral import make_se_geometry, make_se_geometry_tiles
    from mundy_tpu_torch.neighbor.cells3d import make_cell_grid3d
    from mundy_tpu_torch.parallel.spectral_shard import make_sharded_se_rpy_apply

    f64 = torch.float64
    op = _se_op(box, n)
    make = make_se_geometry_tiles if kind == "tiles" else make_se_geometry
    geom = make(op, n // group.size, capacity_slack=slack)
    cells_grid = make_cell_grid3d([box] * 3, op.base.r_cut, n, dtype=f64, device="cpu")
    if kind == "column":  # every body in one binning column: a roomy cell capacity
        cells_grid = cells_grid.replace(capacity=max(cells_grid.capacity, n))
    apply = make_sharded_se_rpy_apply(group, op, geom, cells_grid, n, (box,) * 3)
    nl = n // group.size
    sl = slice(group.rank * nl, (group.rank + 1) * nl)
    u, ovf = apply(torch.as_tensor(pos[sl]), torch.as_tensor(forces[sl]))
    out = {"u": torch.cat(group.all_gather(u)).numpy(), "overflow": bool(ovf),
           "geom": tuple(geom)[:4], "nx": cells_grid.nx}
    return out if group.rank == 0 else None


def chromatin_engine(group, cfg, steps, carry=None):
    """parallel/chromatin_shard's engine over the port's ChromatinSim (CPU)
    from its init (or from `carry`, a ChromatinState's arrays for
    chromatin_state_from_numpy), over blocks of `steps`; rank 0 returns, per
    block, the gathered positions, crosslinker states and bound targets, and
    the overflow and rebuild count."""
    from mundy_tpu_torch.driver.apps.chromatin import ChromatinSim
    from mundy_tpu_torch.parallel.chromatin_shard import make_sharded_chromatin_step

    sim = ChromatinSim(cfg, device="cpu")
    s0 = sim.init()
    eng = make_sharded_chromatin_step(group, sim)
    st = eng.shard(s0)
    out = []
    for n in steps:
        st = eng.step_block(st, n)
        g = eng.gather(st)
        row = {"pos": g["pos"].numpy(), "overflow": bool(g["overflow"]),
               "rebuilds": st["rebuild_count"], "step": st["step"]}
        if "xl_state" in g:
            row["xl_state"] = g["xl_state"].numpy()
            row["bound_to"] = torch.where(g["xl_active"], g["xl_target"], -1).numpy()
        out.append(row)
    return out if group.rank == 0 else None


def chromatin_mesh(group, cfg, steps):
    """ChromatinSim(mesh=group) with hydro rpy_spectral from its init over
    `steps` steps; rank 0 returns the positions, the overflow flag and
    whether the sharded apply was built."""
    from mundy_tpu_torch.driver.apps.chromatin import ChromatinSim

    sim = ChromatinSim(cfg, device="cpu", mesh=group)
    st = sim.run_block(sim.init(), steps)
    out = {"pos": st.pos.numpy(), "overflow": bool(st.overflow),
           "sharded": sim.sharded_se is not None}
    return out if group.rank == 0 else None


def filaments_engine(group, cfg, pos, key_words, steps):
    """parallel/filaments_shard's engine over the port's FilamentsSim (CPU)
    from init(pos, key_words), over blocks of `steps`; rank 0 returns the
    gathered positions, the overflow flag and the rebuild count per block."""
    from mundy_tpu_torch.driver.apps.filaments import FilamentsSim
    from mundy_tpu_torch.parallel.filaments_shard import make_sharded_filaments_step

    sim = FilamentsSim(cfg, device="cpu")
    eng = make_sharded_filaments_step(group, sim)
    st = eng.shard(sim.init(pos=torch.as_tensor(pos), key_words=key_words))
    out = []
    for n in steps:
        st = eng.step_block(st, n)
        g = eng.gather(st)
        out.append({"pos": g["pos"].numpy(), "overflow": bool(g["overflow"]),
                    "rebuilds": st["rebuild_count"], "step": st["step"]})
    return out if group.rank == 0 else None


def block_route(group, app, cfg, blocks, init_kw=None, tight_k=None):
    """ShardedSim(app) over the port's ChromatinSim or FilamentsSim (CPU)
    from init(**init_kw), over `blocks`, regrown as main's loop does when a
    block overflows; `tight_k` first shrinks the contact rows (chromatin:
    the sim's contact_K; filaments: max_neighbors) so that the first block
    overflows. Rank 0 returns the positions, the step, the regrows, the
    contact width after them and the decomposition line, and for chromatin
    the positions of the last rebuild and the searches of the state."""
    from mundy_tpu_torch.driver.apps.chromatin import ChromatinSim
    from mundy_tpu_torch.driver.apps.filaments import FilamentsSim
    from mundy_tpu_torch.driver.sharded import ShardedSim

    sim = (ChromatinSim if app == "chromatin" else FilamentsSim)(cfg, device="cpu")
    runner = ShardedSim(app, sim, group)
    st = sim.init(**(init_kw or {}))
    if tight_k is not None:
        if app == "chromatin":
            sim.contact_K = tight_k
        else:
            cfg.max_neighbors = tight_k
    regrows = 0
    for n in blocks:
        new = runner.run_block(st, n)
        while bool(new.overflow):
            st = runner.regrow(st)
            regrows += 1
            new = runner.run_block(st, n)
        st = new
    out = {"pos": st.pos.numpy(), "step": st.step, "regrows": regrows,
           "describe": runner.describe(), "rebuilds": st.rebuild_count,
           "k": sim.contact_K if app == "chromatin" else cfg.max_neighbors}
    if app == "chromatin":
        out.update(ref_pos=st.ref_pos.numpy(), nmat_idx=st.nmat.idx.numpy(),
                   kmc_idx=st.kmc_nmat.idx.numpy())
    if app == "chromatin" and sim.X:
        out["xl_state"] = st.xl_state.numpy()
        out["bound_to"] = st.xl_bound_to.numpy()
    return out if group.rank == 0 else None


def run_all(group, jobs):
    """Run each (name, body, args) job in order on every rank; rank 0
    returns {name: result}, and under "jax_imported" whether any rank had
    JAX in sys.modules. One process group serves a test file."""
    res = {name: body(group, *args) for name, body, args in jobs}
    res["jax_imported"] = bool(group.pmax(torch.tensor(["jax" in sys.modules]).to(torch.int32)))
    return res if group.rank == 0 else None


def raise_on_rank(group, rank: int):
    """Raise on `rank`, return on the others: a failing rank."""
    if group.rank == rank:
        raise ValueError(f"rank {rank} fails on purpose")
    return group.rank


def sleep_on_rank(group, seconds: float):
    """Sleep past the launcher's timeout: a hung rank."""
    import time

    time.sleep(seconds)
    return group.rank


def _ring_lcp_run(group, cfg_kw, pos0, key_words, steps):
    """LCPSpheresSim(hydro="rpy_ring") over `group` from pos0: per-step
    counters, whether every rank holds the same counters and positions,
    the overlap before and after, and the ring's gamma against the dense
    operator's at the final state."""
    from mundy_tpu_torch.constraints.collision import collision_setup_spheres, resolve_collisions
    from mundy_tpu_torch.driver.apps.lcp_spheres import LCPSpheresConfig, LCPSpheresSim
    from mundy_tpu_torch.mobility.rpy import rpy_apply_dense
    from mundy_tpu_torch.ops.segments import SegmentWindows

    cfg = LCPSpheresConfig(**cfg_kw)
    sim = LCPSpheresSim(cfg, device="cpu", group=group)
    st = sim.init(pos=torch.as_tensor(pos0), key_words=key_words)
    over0 = sim.max_overlap(st)
    group.reset_counters()
    rows = []
    for _ in range(steps):
        st = sim.run_block(st, 1, resize=False)
        rows.append((st.lcp_iters, int(st.act_count), st.rebuild_count, bool(st.overflow)))
    moved = group.bytes_moved
    mine = torch.tensor(rows, dtype=torch.int64)
    same = (all(torch.equal(x, mine) for x in group.all_gather(mine))
            and all(torch.equal(x, st.pos) for x in group.all_gather(st.pos)))
    windows = SegmentWindows(starts=st.seg_starts, block_bodies=sim.seg_block,
                             window=sim.seg_window, overflow=torch.zeros((), dtype=torch.bool))
    setup = collision_setup_spheres(st.pos, torch.tensor(cfg.radius, dtype=torch.float64),
                                    st.pairs, metric=sim.metric, windows=windows)
    g_ring = resolve_collisions(setup, lambda f: sim.ring_apply(st.pos, f), cfg.num_spheres,
                                cfg.dt, max_allowable_overlap=1e-8, replicas=group)[0]
    g_dense = resolve_collisions(
        setup, lambda f: rpy_apply_dense(st.pos, f, cfg.radius, cfg.viscosity,
                                         overlap_correction=True),
        cfg.num_spheres, cfg.dt, max_allowable_overlap=1e-8, replicas=group)[0]
    return {"rows": rows, "pos": st.pos.numpy(), "ranks_agree": same, "over0": over0,
            "over1": sim.max_overlap(st), "gamma_err": float((g_ring - g_dense).abs().max()),
            "bytes": moved}


def ring_lcp(group, cfg_kw, pos0, key_words, steps, sizes):
    """LCP rpy_ring over the first d ranks for each d of `sizes` (a
    subgroup where d is less than the group); rank 0 returns {d: result}."""
    out = {}
    for d in sizes:
        sub = group if d == group.size else group.subgroup(range(d))
        if sub is not None:
            out[d] = _ring_lcp_run(sub, cfg_kw, pos0, key_words, steps)
    return out if group.rank == 0 else None


def _stack_slots(group, *xs) -> list:
    """Each (C, ...) slot array of this rank, every rank's stacked in rank
    order into (d C, ...), as numpy."""
    return [torch.cat(group.all_gather(x)).numpy() for x in xs]


def slab_v2(group, kw, state_np, key_words, steps):
    """parallel.sharded_step's v2 from the reference engine's arrays
    (core.interop), then `steps` steps; rank 0 returns the stacked slots
    after the init it would draw itself (from `pos`), after the carried
    state and after the steps, with each step's max overlap."""
    from mundy_tpu_torch.core.interop import slab_spheres_state_from_numpy
    from mundy_tpu_torch.parallel.sharded_step import make_slab_spheres_step

    step, init = make_slab_spheres_step(group, dtype=torch.float64, **kw)
    own = _stack_slots(group, *init(key_words, pos=torch.as_tensor(state_np["raw"]))[:3])
    st = slab_spheres_state_from_numpy(group.rank, group.size, state_np["pos"],
                                       state_np["active"], state_np["gid"], state_np["flags"])
    carried = _stack_slots(group, *st[:3])
    overlaps = []
    for s in range(steps):
        *st, mo = step(*st, key_words, s)
        overlaps.append(float(mo))
    out = dict(zip(("pos", "active", "gid"), _stack_slots(group, *st[:3])),
               flags=int(st[3]), overlaps=overlaps, own=own, carried=carried)
    return out if group.rank == 0 else None


def slab_v1(group, kw, raw, key_words, steps):
    """parallel.sharded_step's v1 from the (N, 3) positions over `steps`
    steps; rank 0 returns the gathered positions and the overlaps."""
    from mundy_tpu_torch.parallel.sharded_step import make_sharded_spheres_step

    step, init = make_sharded_spheres_step(group, dtype=torch.float64, **kw)
    pos = init(key_words, pos=torch.as_tensor(raw))
    overlaps = []
    for s in range(steps):
        pos, mo = step(pos, key_words, s)
        overlaps.append(float(mo))
    full = torch.cat(group.all_gather(pos)).numpy()
    return {"pos": full, "overlaps": overlaps} if group.rank == 0 else None


def slab_primitives(group, box, halo_width, halo_cap, pos, active, gid):
    """halo_exchange and migrate of parallel.slab on this rank's slots of
    the stacked (d C, ...) inputs; rank 0 returns every rank's outputs
    stacked."""
    from mundy_tpu_torch.parallel.slab import ShardState, halo_exchange, migrate

    c = pos.shape[0] // group.size
    sl = slice(group.rank * c, (group.rank + 1) * c)
    p, a, g = (torch.as_tensor(x[sl]) for x in (pos, active, gid))
    hp, hm, hovf = halo_exchange(p, a, group, box, halo_width, halo_cap)
    m = migrate(ShardState(p, a, g, torch.zeros((), dtype=torch.bool)), group, box)
    out = dict(zip(("halo_pos", "halo_mask", "halo_ovf", "pos", "active", "gid", "ovf"),
                   _stack_slots(group, hp, hm, hovf.reshape(1), m.pos, m.active, m.gid,
                                m.overflow.reshape(1))))
    return out if group.rank == 0 else None


def slab_lcp_run(group, kw, state_np, mode, steps):
    """parallel.slab_lcp from the reference engine's init state
    (core.interop) over `steps` steps in one block; rank 0 returns the
    gathered rows, the per-step iterations, the rebuilds and the flag."""
    from mundy_tpu_torch.core.interop import slab_lcp_state_from_numpy
    from mundy_tpu_torch.parallel.slab_lcp import make_slab_lcp_spheres_step

    init, step_block, _grid = make_slab_lcp_spheres_step(group, dtype=torch.float64,
                                                         rebuild_mode=mode, **kw)
    own = init(state_np["key"], pos=torch.as_tensor(state_np["raw"]))
    st = slab_lcp_state_from_numpy(group.rank, group.size, state_np, own["mode"])
    same_init = all(torch.equal(own[k], st[k]) for k in ("pos", "valid", "gid"))
    st = step_block(st, steps)
    out = {k: gather_planes(group, st[k]) for k in ("pos", "valid", "gid")}
    agree = group.all_gather(torch.tensor([int(same_init)] + st["iters"]))
    out.update(iters=st["iters"], lcp_iters=st["lcp_iters"], rebuilds=st["rebuilds"],
               overflow=bool(st["overflow"]), mode=st["mode"],
               init_equal=all(int(x[0]) for x in agree),
               iters_agree=all(torch.equal(x, agree[0]) for x in agree))
    return out if group.rank == 0 else None
