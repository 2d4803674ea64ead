"""Run one cell of the benchmark of mundy_tpu_torch once, on one NVIDIA GPU.

    python3 portbench/run.py --workload spheres_1m.steady --seed 7 --seconds 20 --trace 0

Run from the root of a checkout. Builds (first run) or loads the program's
CUDA kernels under `build/`, sets the cell up from the seed, measures whole
blocks of the app's run loop for --seconds, has the plain reference follow
the checked set-up block and the last blocks, and prints the numbers
compared (with their limits) as the last lines of standard error and one
JSON result as the last line of standard output. With --trace 1 the metrics
are the cell's per-layer ones, from a traced window of whole blocks after
the measured one. Exits non-zero, printing no result, without a CUDA
device, without the program beside it, or if JAX or the JAX package was
loaded.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()
    # every cache of the program and of PyTorch inside the checkout, at
    # fixed paths (the CUDA kernels build under build/kernels by the
    # program's own rule)
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, "build", "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "triton")
    # one host thread of PyTorch's own: its idle workers spin beside the
    # thread that launches the kernels and slow the host-paced cells
    os.environ["OMP_NUM_THREADS"] = "1"
    sys.path.insert(0, ROOT)

    import torch

    torch.set_num_threads(1)

    from portbench import harness

    cell = harness.Cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.workload["chips"]:
        print("portbench: needs a CUDA device (torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0})",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = harness.run(cell, args.seed, args.seconds, bool(args.trace), "cuda", T_PROCESS)
    sys.stdout.flush()
    for name, c in out["compared"].items():
        print(f"compared {name}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
