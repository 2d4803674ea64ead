"""CLI driver: `python -m mundy_tpu_torch.driver.main config.yaml [--set k=v ...]`.

Port of mundy_tpu/driver/main.py (the `main()` of the reference's app
drivers, CommandLineProcessor + getParametersFromYamlFile,
`HP1...neigh_linker.cpp:1021-1062`), with checkpoints and continuation as
the reference's `enable_continuation_if_available` (`:897-899`) handles
them. The sim runs on the card unless `--device cpu` is given; with no card
and no `--device cpu` the driver raises, never carrying on on the CPU. The
reference's JAX compile-cache and x64 switches have no counterpart: PyTorch
compiles nothing per run here, and each config's dtype selects float64.

`--devices N` (N > 1) runs the app SPMD over N ranks, one process each
(parallel.comm.spawn_ranks, which prints the ranks, the backend and the
devices; its rule: NCCL with a card per rank, gloo on the CPU or on a shared
card): every rank builds the sim and a driver.sharded.ShardedSim around it
(LCP rpy_ring: LCPSpheresSim over the ranks itself, driver.sharded.rank_sim)
and runs the same loop; rank 0 alone prints progress and writes the results
and checkpoints. What no sharded engine runs (driver.sharded.refuse_unported:
an app with no route, a config its engine cannot split over N ranks) raises
before any rank starts.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from mundy_tpu_torch.driver.configurator import (
    available_apps,
    build_simulation_from_yaml,
    config_from_spec,
    load_spec,
)
from mundy_tpu_torch.driver.sharded import rank_sim, refuse_unported
from mundy_tpu_torch.io import latest_checkpoint, load_checkpoint, save_checkpoint
from mundy_tpu_torch.parallel.comm import spawn_ranks


def _parse_overrides(pairs) -> dict:
    out = {}
    for p in pairs or []:
        if "=" not in p:
            raise SystemExit(f"--set expects key=value, got '{p}'")
        k, v = p.split("=", 1)
        try:
            out[k] = json.loads(v)
        except json.JSONDecodeError:
            out[k] = v
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=f"mundy_tpu_torch driver. Apps: {', '.join(available_apps())}")
    ap.add_argument("config", help="YAML config with 'app' and 'params'")
    ap.add_argument("--set", nargs="*", metavar="KEY=VALUE", dest="overrides",
                    help="parameter overrides (JSON-parsed values)")
    ap.add_argument("--checkpoint-dir", default=None,
                    help="directory for periodic checkpoints + continuation")
    ap.add_argument("--checkpoint-every", type=int, default=0,
                    help="steps between checkpoints (0 = only at end)")
    ap.add_argument("--continue", dest="resume", action="store_true",
                    help="resume from the latest checkpoint if present")
    ap.add_argument("--output-dir", default=None,
                    help="directory for trajectory frames + final VTK "
                         "(the IOBroker results role)")
    ap.add_argument("--output-every", type=int, default=0,
                    help="steps between trajectory frames (0 = final only)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the sim runs (default: the card)")
    ap.add_argument("--devices", type=int, default=0,
                    help="run sharded over N ranks (the reference's `mpirun -n N` "
                         "role); 0/1 = one device")
    ap.add_argument("--rank-timeout", type=float, default=3600.0,
                    help="with --devices: seconds after which every rank is killed and "
                         "the run fails (also each collective's timeout)")
    args = ap.parse_args(argv)

    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda (the default) needs a CUDA device, and torch sees "
                           "none; pass --device cpu to run on the CPU")
    if args.devices and args.devices > 1:
        app, config = config_from_spec(load_spec(args.config, _parse_overrides(args.overrides)))
        refuse_unported(app, config, args.devices)
        threads = max(1, torch.get_num_threads() // args.devices)
        spawn_ranks(_rank_main, args.devices, args.device, args=(args,),
                    timeout=args.rank_timeout, threads=threads)
        return 0

    config, sim = build_simulation_from_yaml(args.config, _parse_overrides(args.overrides),
                                             device=args.device)
    return _run(args, config, sim, args.device, lead=True)


def _rank_main(group, args) -> int:
    """One rank of `--devices N`: the rank's sim (driver.sharded.rank_sim)
    through the same loop; rank 0 alone prints and writes."""
    config, sim, plan = rank_sim(load_spec(args.config, _parse_overrides(args.overrides)),
                                 group)
    if group.rank == 0:
        print(plan, flush=True)
    return _run(args, config, sim, group.device.type, lead=group.rank == 0)


def _run(args, config, sim, device: str, lead: bool) -> int:
    """The block loop. `lead` prints and writes results and checkpoints (the
    one device, or rank 0 of a sharded run)."""
    say = print if lead else (lambda *a, **k: None)
    say(f"app config: {config}")

    state = sim.init()
    start_step = 0
    if args.resume and args.checkpoint_dir:
        ck = latest_checkpoint(args.checkpoint_dir)
        if ck is not None:
            state = load_checkpoint(ck, state)
            start_step = int(getattr(state, "step", 0))
            say(f"resumed from {ck} at step {start_step}")

    total = config.num_steps
    broker = None
    if args.output_dir and lead:
        from mundy_tpu_torch.io.broker import ResultsBroker

        broker = ResultsBroker(args.output_dir, 0, args.output_every,
                               dt=float(getattr(config, "dt", 0.0)), append=start_step > 0)
        if start_step == 0:
            broker.write_frame(0, sim, state)  # the initial configuration

    # block size = the finest positive cadence of checkpoints and results
    # (the reference's io_frequency / PeriodicTrigger role)
    cadences = [v for v in (args.checkpoint_every, args.output_every) if v > 0]
    block = min(cadences) if cadences else total
    done = start_step
    regrows = 0
    t0 = time.perf_counter()
    while done < total:
        n = min(block, total - done)
        new_state = sim.run_block(state, n)
        if device == "cuda":
            torch.cuda.synchronize()
        if bool(getattr(new_state, "overflow", False)) and hasattr(sim, "regrow"):
            if regrows >= 8:
                raise SystemExit("capacity overflow persists after regrows")
            regrows += 1
            say(f"capacity overflow: regrow #{regrows}, retrying block")
            state = sim.regrow(state)
            continue
        state = new_state
        done += n
        say(f"step {done}/{total}")
        if broker is not None:
            broker.maybe_write(done, sim, state)
        if lead and args.checkpoint_dir and (
                done >= total or (args.checkpoint_every > 0
                                  and done % args.checkpoint_every == 0)):
            save_checkpoint(args.checkpoint_dir, done, state)
    elapsed = time.perf_counter() - t0
    stepped = done - start_step
    say(f"stepped {stepped} steps in {elapsed:.3f} s"
        + (f" ({1e3 * elapsed / stepped:.3f} ms/step)" if stepped else ""))
    if broker is not None:
        vtk = broker.finalize(done, sim, state)
        say(f"wrote {broker.frames_written} trajectory frames to "
            f"{broker.trajectory_path}; final snapshot {vtk}")
    say("done")
    return 0


if __name__ == "__main__":
    sys.exit(main())
