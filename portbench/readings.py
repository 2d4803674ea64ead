"""The readings that the limits of `correct` are set from: a cell run on
many seeds in one process, each with a short measured window, printing per
seed the numbers compared and, on the first --control-seeds seeds, the
control's (the reference in the next lower precision, in the program's
place, from the same positions).

    python3 portbench/readings.py --workload spheres_1m.steady --seeds 11,12,13 \\
        --control-seeds 3 --seconds 2 [--app spheres_rows]

With the control it also prints the reading of a step that returns its
state unchanged: the gap of the block's starting positions to the
reference's, which every limit has to fail too.

--app drives another of the program's apps on the cell's configuration (a
second path of the program, to witness a fault); --set KEY=VALUE (repeated)
runs the program with a parameter of the configuration changed, such as a
solver tolerance loosened, while the reference and the limits keep the
cell's (a fault planted in the program). Prints one JSON line per seed and
a summary line; exits non-zero without a CUDA device.
"""

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", type=int, default=0)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--app", default=None)
    ap.add_argument("--set", action="append", default=[], metavar="KEY=VALUE")
    args = ap.parse_args()
    os.environ["OMP_NUM_THREADS"] = "1"  # as run.py
    sys.path.insert(0, ROOT)
    import torch

    torch.set_num_threads(1)

    from portbench import harness

    if not torch.cuda.is_available():
        print("readings: needs a CUDA device", file=sys.stderr)
        return 2
    fault = {k: json.loads(v) for k, v in (kv.split("=", 1) for kv in args.set)}
    cell = harness.Cell(args.workload, app=args.app, fault=fault)
    seeds = [int(s) for s in args.seeds.split(",")]
    rows = []
    for k, seed in enumerate(seeds):
        t0 = time.perf_counter()
        out = harness.run(cell, seed, args.seconds, False, "cuda",
                          control=k < args.control_seeds)
        line = {"seed": seed, "correct": out["correct"], "seconds": time.perf_counter() - t0,
                "compared": {n: c["value"] for n, c in out["compared"].items()},
                "control": out.get("control"), "reference_s": out["reference_s"],
                "metrics": {n: m["value"] for n, m in out["metrics"].items()}}
        rows.append(line)
        print(json.dumps(line), flush=True)
    lower = {n: max(r["compared"][n] for r in rows) for n in rows[0]["compared"]}
    ctl = [r["control"] for r in rows if r["control"]]
    upper = {n: min(c[n] for c in ctl) for n in ctl[0]} if ctl else {}  # and the faults
    print(json.dumps({"workload": args.workload, "app": args.app or cell.config["app"],
                      "fault": fault,
                      "seeds": len(rows), "lower": lower, "control_upper": upper,
                      "device": torch.cuda.get_device_name(0)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
