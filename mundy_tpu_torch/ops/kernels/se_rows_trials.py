"""Trials of the rows kernels K5s-rows and K5i-rows on the card: where
their time goes, and what their tuning constants do.

    python -m mundy_tpu_torch.ops.kernels.se_rows_trials [--parent DIR] [--out FILE]

Builds, beside the package's own csrc/se_grid.cu, copies of it with a part
cut out or a constant changed (into build/trials/, not the package's build
directory) and times K5s-rows and K5i-rows of each at chip_smoke.py [44]'s
shape: 1,048,576 uniform beads from the host generator at seed 44 in the
chromatin YAML's box, its operator (G 384, P 6, ES), rows of m 8 and R
664. Each time is the device time per launch of 20 launches queued behind
a spin on the card, a median over rounds that take the copies in turn.
--parent names the root of a checkout of an earlier commit (a `git
archive` of the parent, say) whose csrc/se_grid.cu holds the first design
of the two kernels, with the older C interface; it is timed and cut the
same way. A cut copy computes a wrong grid or u; every uncut one is held
to the package's outputs bit for bit. Needs an NVIDIA GPU with nvcc.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import json
import math
import os
import statistics
import subprocess
from pathlib import Path

import torch

from mundy_tpu_torch.ops.kernels import _build
from mundy_tpu_torch.ops.kernels import se_grid as k5

TRIALS_DIR = _build.BUILD_DIR.parent / "trials"

# (name, [(text, replacement), ...]) of this design's source
CUTS = [
    ("design", []),
    ("K5s without its sums", [("if (xb == 0u) continue;",
                               "if (xb == 0u || nst > 0) continue;")]),
    ("K5s without its sums and staging", [
        ("if (xb == 0u) continue;", "if (xb == 0u || nst > 0) continue;"),
        ("for (int e0 = warp; e0 < nst; e0 += SG * nw) {",
         "for (int e0 = warp; e0 < nst && nst < 0; e0 += SG * nw) {")]),
    ("K5i without its sums", [("k < spre[e_hi]; k += blockDim.x) {",
                               "k < spre[e_hi] && nch < 0; k += blockDim.x) {")]),
    ("K5i without its staging", [("      for (int pl = warp; pl < 3 * nx; pl += nw) {\n"
                                  "        const int ch = pl / nx;",
                                  "      for (int pl = warp; pl < 3 * nx && nx < 0; pl += nw) {\n"
                                  "        const int ch = pl / nx;")]),
    ("ROWS_CAP 256", [("constexpr int ROWS_CAP = 128;", "constexpr int ROWS_CAP = 256;")]),
    ("SG 8", [("constexpr int SG = 4;", "constexpr int SG = 8;")]),
    ("ISLAB_BYTES 12 KB", [("constexpr int ISLAB_BYTES = 24 * 1024;",
                            "constexpr int ISLAB_BYTES = 12 * 1024;")]),
    ("ISLAB_BYTES 48 KB", [("constexpr int ISLAB_BYTES = 24 * 1024;",
                            "constexpr int ISLAB_BYTES = 48 * 1024;")]),
    ("ICHUNK 32", [("constexpr int ICHUNK = 64;", "constexpr int ICHUNK = 32;")]),
]
# the same of the first design's source (se_grid.cu before the x-run lists)
FIRST_SUMS = ("        if (own) {\n          for (int j = 0; j < nst; ++j) {\n"
              "            const T* w = sw + static_cast<size_t>(j) * ws;\n"
              "            const T wzv = w[RX + m + lz];")
FIRST_STAGE = ("        for (int e = threadIdx.x; e < nst; e += blockDim.x) {\n"
               "          const int s = s_slot[done + e];")
NO_FIRST_SUMS = (FIRST_SUMS, FIRST_SUMS.replace("(own)", "(own && nst < 0)"))
FIRST_CUTS = [
    ("first design", []),
    ("first design without its sums", [NO_FIRST_SUMS]),
    ("first design without its sums and staging", [
        NO_FIRST_SUMS, (FIRST_STAGE, FIRST_STAGE.replace("e < nst;", "e < nst && nst < 0;"))]),
]


def _cut(src: str, subs) -> str:
    for old, new in subs:
        if src.count(old) != 1:
            raise ValueError(f"the cut {old[:60]!r} does not match the source once")
        src = src.replace(old, new)
    return src


def _build_copy(tag: str, src: str) -> Path:
    TRIALS_DIR.mkdir(parents=True, exist_ok=True)
    cu = TRIALS_DIR / f"{tag}.cu"
    so = TRIALS_DIR / f"{tag}.so"
    cu.write_text(src)
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(cu)],
                          capture_output=True, text=True, check=False)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {tag}:\n{proc.stderr[-3000:]}")
    return so


def _calls(lib, first: bool, geom, pieces, forces, n, grid):
    """(spread, interp): one launch each of lib's rows kernels, the
    wrappers' scratch allocated as they allocate it."""
    perm, _ovf, gx0, gy0, wx, wy, wz = pieces
    dev = forces.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    args = (perm.data_ptr(), gx0.data_ptr(), gy0.data_ptr(), wx.data_ptr(), wy.data_ptr(),
            wz.data_ptr())
    G, m, P, R = geom.G, geom.m, geom.P, geom.R
    h3 = (geom.box / G) ** 3
    sp, it = lib.se_spread_rows_f32, lib.se_interp_rows_f32
    if first:  # ext scratch; interp takes the slot count
        sp.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        it.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [ctypes.c_double]
                       + [ctypes.c_void_p])
    else:
        plan = k5.rows_plan(geom, forces.element_size())
        sp.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        it.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 6 + [ctypes.c_double]
                       + [ctypes.c_void_p])

    def spread():
        g = torch.empty((G, G, G, 3), dtype=forces.dtype, device=dev)
        if first:
            ext = torch.empty(perm.shape[0], dtype=torch.int32, device=dev)
            err = sp(*args, forces.data_ptr(), ext.data_ptr(), g.data_ptr(), n, G, m, P, R,
                     stream)
        else:
            lists = torch.empty(perm.shape[0] * plan.spread_lcap, dtype=torch.int32, device=dev)
            offs = torch.empty(perm.shape[0] * (plan.nxr + 1), dtype=torch.int32, device=dev)
            err = sp(*args, forces.data_ptr(), lists.data_ptr(), offs.data_ptr(), g.data_ptr(),
                     n, G, m, P, R, plan.spread_lcap, stream)
        if err:
            raise RuntimeError(f"spread launch failed: CUDA error {err}")
        return g

    def interp():
        out = torch.zeros((n, 3), dtype=grid.dtype, device=dev)
        if first:
            err = it(*args, grid.data_ptr(), out.data_ptr(), n, perm.numel(), G, m, P, R, h3,
                     stream)
        else:
            lists = torch.empty(perm.shape[0] * plan.interp_lcap, dtype=torch.int32, device=dev)
            offs = torch.empty(perm.shape[0] * (plan.nxr + 1), dtype=torch.int32, device=dev)
            err = it(*args, grid.data_ptr(), out.data_ptr(), lists.data_ptr(), offs.data_ptr(),
                     n, G, m, P, R, plan.interp_lcap, h3, stream)
        if err:
            raise RuntimeError(f"interp launch failed: CUDA error {err}")
        return out

    return spread, interp


def device_ms(fn, reps: int = 20) -> float:
    """Device time per launch: `reps` calls queued behind a spin on the card."""
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def inputs(dev):
    """chip_smoke.py [44]'s geometry, pieces, forces and bead count."""
    from mundy_tpu_torch.core.config import config_from_dict, load_yaml
    from mundy_tpu_torch.driver.apps.chromatin import ChromatinConfig
    from mundy_tpu_torch.mobility import spectral

    root = Path(__file__).resolve().parents[3]
    raw = load_yaml(str(root / "examples" / "chromatin_1m_spectral.yaml"))
    ccfg = config_from_dict(ChromatinConfig, raw["params"])
    r_cut = min(0.25 * ccfg.box_size, 3.5 * 2.0 * ccfg.bead_radius)
    op = spectral.build_spectral_ewald(ccfg.box_size, ccfg.bead_radius, ccfg.viscosity,
                                       tol=1e-4, xi=math.sqrt(max(math.log(1e4), 1.0)) / r_cut,
                                       r_cut=r_cut, dtype=torch.float32, device=dev)
    n = 1 << 20
    geom = spectral.make_se_geometry(op, n)
    gen = torch.Generator().manual_seed(44)
    pos = (torch.rand((n, 3), generator=gen) * ccfg.box_size).to(dev)
    forces = torch.randn((n, 3), generator=gen).to(dev)
    pieces = k5.se_bin_and_windows(geom, pos, torch.float32)
    return geom, pieces, forces, n


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="root of a checkout whose se_grid.cu is the first design")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--out", help="write the medians as JSON here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("se_rows_trials needs a CUDA device")
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=False).stdout.strip()
    src = (_build.CSRC / "se_grid.cu").read_text()
    jobs = [(f"t{i}", name, _cut(src, subs), False) for i, (name, subs) in enumerate(CUTS)]
    if args.parent:
        first = (Path(args.parent) / "mundy_tpu_torch" / "csrc" / "se_grid.cu").read_text()
        jobs += [(f"f{i}", name, _cut(first, subs), True)
                 for i, (name, subs) in enumerate(FIRST_CUTS)]
    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as pool:
        libs = list(pool.map(lambda j: _build_copy(j[0], j[2]), jobs))
    geom, pieces, forces, n = inputs(dev)
    want = (k5.se_spread_rows_pre(geom, pieces, forces),)
    grid = want[0].permute(3, 0, 1, 2).contiguous().permute(1, 2, 3, 0)  # K5i-rows' layout
    want += (k5.se_interp_rows_pre(geom, pieces, n, grid),)
    calls = {}
    for (tag, name, _src, first), so in zip(jobs, libs):
        spread, interp = _calls(ctypes.CDLL(str(so)), first, geom, pieces, forces, n, grid)
        g, u = spread(), interp()
        torch.cuda.synchronize()
        same = (bool(torch.equal(g, want[0])), bool(torch.equal(u, want[1])))
        if name in ("design", "first design") or name.startswith(("ROWS", "SG", "ISLAB", "ICH")):
            if not all(same):
                raise SystemExit(f"{name}: outputs differ from the package's {same}")
        calls[name] = (spread, interp)
    times = {name: ([], []) for name in calls}
    names = list(calls)
    for _ in range(args.rounds):
        for name in names + names[::-1]:
            times[name][0].append(device_ms(calls[name][0]))
            times[name][1].append(device_ms(calls[name][1]))
    med = {name: (statistics.median(s), statistics.median(i)) for name, (s, i) in times.items()}
    print(f"card: {card}; device time per launch, median of {2 * args.rounds}")
    for name, (s, i) in med.items():
        print(f"  {name}: K5s-rows {s:.4f} ms ({min(times[name][0]):.4f}-"
              f"{max(times[name][0]):.4f}), K5i-rows {i:.4f} ms ({min(times[name][1]):.4f}-"
              f"{max(times[name][1]):.4f})")
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"card": card, "ms": med}, f, indent=1)


if __name__ == "__main__":
    main()
