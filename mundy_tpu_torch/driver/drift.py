"""f32-vs-f64 drift harness (BASELINE.md protocol: per-step drift bar 1e-10).

    python -m mundy_tpu_torch.driver.drift [spheres|lcp] [N] [--steps S]
        [--device {cuda,cpu}]

Port of benchmarks/drift_f32.py. It runs a milestone config twice from an
IDENTICAL initial state: float64 on the host CPU (the reference leg) and
float32 on `device` (the card unless `--device cpu` is given; with no card
the harness raises, never carrying on on the CPU). Both legs draw matched
gid-keyed noise (dynamics.brownian.brownian_velocity_keyed is a pure
function of (key, step, gid) whose float32 normals are cast to the leg's
dtype), and the harness reports:

  - per-step local drift: max position deviation after ONE step from the
    shared start (the BASELINE.json 1e-10/step bar is about this number)
  - trajectory divergence at checkpoints (contact dynamics is chaotic, so
    the window divergence grows faster than linearly; both are reported)
  - for the LCP config: the constraint residual (max overlap) of each leg

`ref_device="cuda"` moves the float64 leg (default: the CPU, as in the
reference) to the card in float64, for sizes whose float64 leg would take
minutes on the host; the apps' float64 runs on the card agree with the CPU
to a few 1e-9, far below a float32 drift.

On the card the float32 LCP leg runs kernels K2 (row_neighbor_extract, each
rows broad phase) and K3 (strided_onehot_segment_sum, each constraint-force
sum); the float32 spheres leg (the flat cell-list SpheresSim) runs no hand
kernel.
"""

from __future__ import annotations

import argparse
import json
from typing import Optional

import numpy as np
import torch

from mundy_tpu_torch.driver.apps.lcp_spheres import LCPSpheresConfig, LCPSpheresSim
from mundy_tpu_torch.driver.apps.spheres import SpheresConfig, SpheresSim
from mundy_tpu_torch.driver.main import require_device

CHECKPOINTS = (1, 2, 5, 10, 20, 50, 100)
RADIUS, PHI = 0.5, 0.05


def _minimage_dev(a, b, box) -> float:
    """Max minimum-image deviation between two (N, 3) position sets, in
    float64."""
    d = np.abs(_f64(a) - _f64(b))
    d = np.minimum(d, box - d)
    return float(d.max())


def _f64(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().to("cpu", torch.float64).numpy()
    return np.asarray(x, np.float64)


def _box(n: int) -> float:
    """The cubic box edge that holds n spheres of RADIUS at volume fraction PHI."""
    return float((n * (4 / 3) * np.pi * RADIUS**3 / PHI) ** (1 / 3))


def _legs(make, device, ref_device, pos, key_words):
    """((sim64, s64), (sim32, s32)): the float64 leg on `ref_device`, drawn
    by its init() unless a start (`pos`, `key_words`) is given, and the
    float32 leg on `device` from the float64 positions cast down and the
    same key words (init(pos=) builds its search structures and keeps the
    given order)."""
    require_device(device)
    sim64 = make("float64", ref_device)
    s64 = sim64.init() if pos is None else sim64.init(pos=pos, key_words=key_words)
    sim32 = make("float32", device)
    s32 = sim32.init(pos=s64.pos.to(torch.float32), key_words=s64.key)
    return (sim64, s64), (sim32, s32)


def spheres_pair(n: int = 2000, device="cuda", pos: Optional[torch.Tensor] = None,
                 key_words: Optional[tuple] = None, ref_device="cpu"):
    """((sim64, s64), (sim32, s32), box) of the flat cell-list SpheresSim
    with identical starts."""
    box = _box(n)

    def make(dtype, dev):
        cfg = SpheresConfig(num_spheres=n, box_size=box, radius=RADIUS,
                            youngs_modulus=1000.0, diffusion_coeff=0.1,
                            dt=1e-4, skin=0.4, chunk=2048, dtype=dtype)
        return SpheresSim(cfg, device=dev)

    return (*_legs(make, device, ref_device, pos, key_words), box)


def lcp_pair(n: int = 2000, device="cuda", pos: Optional[torch.Tensor] = None,
             key_words: Optional[tuple] = None, ref_device="cpu"):
    """((sim64, s64), (sim32, s32), box) of LCPSpheresSim (hydro "none")
    with identical starts."""
    box = _box(n)

    def make(dtype, dev):
        cfg = LCPSpheresConfig(num_spheres=n, box_size=box, radius=RADIUS,
                               dt=1e-3, diffusion_coeff=0.1, chunk=2048,
                               dtype=dtype)
        return LCPSpheresSim(cfg, device=dev)

    return (*_legs(make, device, ref_device, pos, key_words), box)


def run(config: str = "spheres", n: int = 2000, steps: int = 100, device="cuda",
        ref_device="cpu") -> dict:
    """Advance both legs checkpoint by checkpoint; print one line per
    checkpoint and the result's JSON, and return the result."""
    pair = spheres_pair if config == "spheres" else lcp_pair
    (sim64, s64), (sim32, s32), box = pair(n, device, ref_device=ref_device)
    rows = []
    done = 0
    for k in CHECKPOINTS:
        if k > steps:
            break
        s64 = sim64.run_block(s64, k - done)
        s32 = sim32.run_block(s32, k - done)
        done = k
        dev = _minimage_dev(s64.pos, s32.pos, box)
        rows.append((k, dev))
        print(f"  step {k:4d}: max position deviation {dev:.3e}"
              f"  ({dev / k:.3e}/step)", flush=True)
    out = {
        "config": config,
        "n": n,
        "backend_f32": sim32.device.type,
        "per_step_drift": rows[0][1],
        "divergence": {str(k): d for k, d in rows},
    }
    if config == "lcp":
        out["max_overlap_f64"] = float(sim64.max_overlap(s64))
        out["max_overlap_f32"] = float(sim32.max_overlap(s32))
        print(f"  max overlap: f64 {out['max_overlap_f64']:.3e}  "
              f"f32 {out['max_overlap_f32']:.3e}")
    print(json.dumps(out), flush=True)
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description="f32-vs-f64 drift of a milestone config")
    ap.add_argument("config", nargs="?", choices=("spheres", "lcp"), default="spheres")
    ap.add_argument("n", nargs="?", type=int, default=2000, help="number of spheres")
    ap.add_argument("--steps", type=int, default=100,
                    help="steps to run (checkpoints up to this many)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the float32 leg runs (default: the card)")
    args = ap.parse_args(argv)
    return run(args.config, args.n, args.steps, args.device)


if __name__ == "__main__":
    main()
