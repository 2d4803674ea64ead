"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds kernel K1 from mundy_tpu_torch/csrc/ and drives BASELINE config #1
(the row-grid spheres engine) through the port's own entry points:

1. build K1 with nvcc (sm_90a); print the card and its power limit;
2. K1 vs its plain PyTorch version at the 1M-sphere main-path shape
   (float32, max |diff| over valid slots <= 2e-5 max|f|), both timed with
   CUDA events after a synchronize (median of several runs);
3. examples/spheres_10k.yaml for 200 steps through load_yaml /
   config_from_dict -> RowSpheresSim(...).run();
4. a small float64 run (2000 spheres, 60 steps) on the card against the
   same run on the CPU, which takes the plain version;
5. the 1M bench config (phi = 0.05) for 300 steps through run_block, with
   the K1 launch count reset just before: no lost particle, no overflow,
   >= 1 rebuild, one K1 launch per step; prints steps/s and ms/step.

Prints one JSON line of kernel results, then a final JSON line
{"ok": true, "device": {...}}. Exits non-zero, with no result, without a
CUDA device or without the package beside it.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
N_BIG = 1_000_000
BIG_STEPS = 300


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def bench_config(SpheresConfig, n: int):
    """bench.py's headline config: phi = 0.05, box scaled to n."""
    radius, phi = 0.5, 0.05
    box = (n * (4.0 / 3.0) * math.pi * radius ** 3 / phi) ** (1.0 / 3.0)
    return SpheresConfig(num_spheres=n, box_size=box, radius=radius,
                         youngs_modulus=1000.0, diffusion_coeff=0.1, dt=1e-4,
                         skin=0.4, max_neighbors=32, cell_capacity=8,
                         chunk=16384, dtype="float32")


def cuda_ms(fn, torch, reps: int) -> float:
    """Median device time of fn() in ms (CUDA events after a synchronize)."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    sys.path.insert(0, HERE)
    try:
        import mundy_tpu_torch
    except ImportError as e:
        fail(f"the mundy_tpu_torch package is not beside this script ({e})")
    if os.path.dirname(os.path.dirname(os.path.abspath(mundy_tpu_torch.__file__))) != HERE:
        fail(f"mundy_tpu_torch was imported from {mundy_tpu_torch.__file__}, "
             "not from this checkout")
    from mundy_tpu_torch.core.config import config_from_dict, load_yaml
    from mundy_tpu_torch.driver.apps.spheres import SpheresConfig
    from mundy_tpu_torch.driver.apps.spheres_rows import RowSpheresSim
    from mundy_tpu_torch.ops.kernels import _build
    from mundy_tpu_torch.ops.kernels import row_central as k1

    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, check=True, timeout=60)
    except (OSError, subprocess.SubprocessError) as e:
        fail(f"nvidia-smi could not read the card's power limit: {e}")
    print(f"card: {smi.stdout.strip().splitlines()[0]}", flush=True)

    # ---- 1. build ---------------------------------------------------------
    t0 = time.perf_counter()
    lib = _build.build("row_central")
    print(f"[1] built {os.path.relpath(lib, HERE)} in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    for line in lib.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line:
            print(f"    ptxas: {line.strip()}")

    # ---- 2. K1 vs plain at the 1M main-path shape -------------------------
    big = bench_config(SpheresConfig, N_BIG)
    sim = RowSpheresSim(big, device=dev)
    state = sim.init()
    rows = state.rows
    box = sim.box_static[0]
    args = (box, big.radius, big.youngs_modulus, big.poissons_ratio)
    f_k = k1.row_hertzian_forces_sym(rows.pos, *args)
    f_p = k1.row_hertzian_forces_plain(rows.pos, *args)
    torch.cuda.synchronize()
    m = rows.valid
    err = (f_k[m] - f_p[m]).abs().max().item()
    fmax = f_p[m].abs().max().item()
    ny, nz, R = rows.valid.shape
    print(f"[2] K1 at (ny, nz, R) = ({ny}, {nz}, {R}), {int(m.sum())} valid "
          f"slots: max|diff| {err:.3e}, max|f| {fmax:.3e}", flush=True)
    if not (fmax > 0 and math.isfinite(err) and err <= 2e-5 * fmax):
        fail(f"K1 disagrees with its plain version: {err} > 2e-5 * {fmax}")
    ms_k, ms_p = [], []
    for _ in range(3):  # alternate plain and kernel
        ms_p.append(cuda_ms(lambda: k1.row_hertzian_forces_plain(rows.pos, *args), torch, 3))
        ms_k.append(cuda_ms(lambda: k1.row_hertzian_forces_sym(rows.pos, *args), torch, 10))
    kernel_ms, plain_ms = statistics.median(ms_k), statistics.median(ms_p)
    print(f"    K1 {kernel_ms:.4f} ms, plain {plain_ms:.4f} ms (medians, "
          "CUDA events)", flush=True)
    del f_k, f_p, sim, state, rows

    # ---- 3. examples/spheres_10k.yaml, 200 steps ----------------------------
    raw = load_yaml(os.path.join(HERE, "examples", "spheres_10k.yaml"))
    params = dict(raw["params"], num_steps=200, dtype="float32")
    cfg = config_from_dict(SpheresConfig, params)
    sim = RowSpheresSim(cfg, device=dev)
    t0 = time.perf_counter()
    st = sim.run(log=lambda line: print(f"    {line}", flush=True))
    torch.cuda.synchronize()
    pos = sim.positions(st)
    n_valid = int(st.rows.valid.sum())
    print(f"[3] spheres_10k.yaml: {st.step} steps in "
          f"{time.perf_counter() - t0:.2f} s, rebuilds {st.rebuild_count}, "
          f"max overlap {sim.max_overlap(st):.4f}", flush=True)
    if not (st.step == 200 and n_valid == cfg.num_spheres and not bool(st.overflow)
            and bool(torch.isfinite(pos).all())):
        fail("spheres_10k.yaml run lost particles, overflowed or went non-finite")

    # ---- 4. float64 on the card vs the CPU plain path ---------------------
    small = SpheresConfig(num_spheres=2000, box_size=16.0, diffusion_coeff=0.01,
                          dt=1e-4, skin=0.1, dtype="float64")
    runs = {}
    for d in ("cuda", "cpu"):
        sim = RowSpheresSim(small, device=d)
        st = sim.init(pos=torch.rand((2000, 3), dtype=torch.float64,
                                     generator=torch.Generator().manual_seed(5)) * 16.0)
        st = sim.run_block(st, 60)
        runs[d] = (st, sim.positions(st).cpu())
    (sg, pg), (sc, pc) = runs["cuda"], runs["cpu"]
    diff = (pg - pc).abs().max().item()
    print(f"[4] float64 2000 spheres, 60 steps: rebuilds {sg.rebuild_count} "
          f"(cpu {sc.rebuild_count}), max|pos diff| vs cpu {diff:.3e}", flush=True)
    if not (sg.rebuild_count == sc.rebuild_count >= 3 and diff <= 1e-7
            and torch.equal(sg.rows.gid.cpu(), sc.rows.gid)):
        fail("the float64 run on the card disagrees with the CPU run")

    # ---- 5. the 1M bench config through run_block -------------------------
    sim = RowSpheresSim(big, device=dev)
    st = sim.init()
    st = sim.run_block(st, 3)  # warm up allocator and kernel
    torch.cuda.synchronize()
    rb0 = st.rebuild_count
    k1.row_hertzian_forces_sym.launches = 0
    t0 = time.perf_counter()
    st = sim.run_block(st, BIG_STEPS)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = k1.row_hertzian_forces_sym.launches
    pos = sim.positions(st)
    n_valid = int(st.rows.valid.sum())
    rebuilds = st.rebuild_count - rb0
    print(f"[5] 1M bench config: {BIG_STEPS} steps in {elapsed:.3f} s = "
          f"{BIG_STEPS / elapsed:.2f} steps/s, {1e3 * elapsed / BIG_STEPS:.3f} "
          f"ms/step, rebuilds {rebuilds}, R {sim.grid.row_capacity}, "
          f"K1 launches {launches}", flush=True)
    if not bool(torch.isfinite(pos).all()):
        fail("non-finite positions in the 1M run")
    if n_valid != N_BIG or bool(st.overflow):
        fail(f"1M run lost particles or overflowed (valid {n_valid})")
    if rebuilds < 1:
        fail("no rebuild in the 1M window")
    if launches != BIG_STEPS:
        fail(f"K1 launched {launches} times in {BIG_STEPS} steps")

    print(json.dumps({"kernels": [{
        "name": "row_hertzian_forces_sym", "route": "cuda",
        "source": "mundy_tpu_torch/csrc/row_central.cu",
        "replaces": "mundy_tpu/ops/pallas/row_central.py:128",
        "launches": launches, "max_abs_err": err, "ms": kernel_ms,
        "plain_ms": plain_ms}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)


if __name__ == "__main__":
    main()
