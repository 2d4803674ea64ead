"""Bodies that the multi-rank tests run on each rank (parallel.comm.spawn_ranks).

A spawned rank imports its target by module name in a fresh interpreter, so
these live in a module that imports torch and the port only: never JAX,
never the JAX package. Each body returns numpy arrays on rank 0 (None on the
others); the tests compare them with the JAX reference in their own process.
"""

import sys

import numpy as np
import torch

from mundy_tpu_torch.parallel.ring_rpy import make_ring_rpy_apply
from mundy_tpu_torch.parallel.slab_rows import make_slab_rows_spheres_step
from mundy_tpu_torch.parallel.slab_segments import make_slab_rods_step


def gather_planes(group, x: torch.Tensor) -> np.ndarray:
    """The (ny, nz, R, ...) global array of every rank's (ny, nzl, R, ...)
    slab, in plane order."""
    return torch.cat(group.all_gather(x), dim=1).numpy()


def ring_apply(group, pos, forces, radius, viscosity, overlap_correction):
    """This rank's block of the ring apply of the (N, 3) inputs; rank 0
    returns the gathered (N, 3) velocities."""
    n_loc = pos.shape[0] // group.size
    sl = slice(group.rank * n_loc, (group.rank + 1) * n_loc)
    apply = make_ring_rpy_apply(group, radius, viscosity, include_self=True,
                                overlap_correction=overlap_correction)
    u = apply(torch.as_tensor(pos[sl]), torch.as_tensor(forces[sl]))
    full = torch.cat(group.all_gather(u)).numpy()
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
