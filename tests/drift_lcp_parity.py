"""One LCP step of the f32-vs-f64 drift harness at a larger N, the port
against the reference, from the reference harness's own start (CPU).

    JAX_PLATFORMS=cpu python tests/drift_lcp_parity.py N

Builds benchmarks/drift_f32.py's lcp_pair(N) and the port's
mundy_tpu_torch.driver.drift.lcp_pair(N, device="cpu") from the same float64
positions and key, runs one step of each of the four legs and prints the
float32-vs-float64 deviation of each package, each leg against its twin,
and the four legs' max overlaps. Not collected by pytest: the JAX LCP
compile and the N used here take minutes (~2 at N = 20000, ~3 at 131072
on 8 threads).
"""

import sys
import time
from pathlib import Path

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import torch  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "benchmarks"), str(ROOT)]

import drift_f32  # noqa: E402

from mundy_tpu_torch.driver import drift  # noqa: E402


def main(n: int) -> None:
    t0 = time.perf_counter()
    (j64, js64), (j32, js32), box = drift_f32.lcp_pair(n)
    (t64, ts64), (t32, ts32), _ = drift.lcp_pair(
        n, device="cpu", pos=torch.from_numpy(np.array(js64.pos)),
        key_words=np.asarray(jax.random.key_data(js64.key)))
    js64, js32 = j64.run_block(js64, 1), j32.run_block(js32, 1)
    ts64, ts32 = t64.run_block(ts64, 1), t32.run_block(ts32, 1)
    dev = drift._minimage_dev
    print(f"N = {n}, box {box:.4f}, one step from the reference's start:")
    print(f"  float32 vs float64: reference {dev(js64.pos, js32.pos, box)!r}, "
          f"port {dev(ts64.pos, ts32.pos, box)!r}")
    print(f"  port vs reference: float64 {dev(ts64.pos, js64.pos, box)!r}, "
          f"float32 {dev(ts32.pos, js32.pos, box)!r}")
    print(f"  max overlap: reference f64 {float(j64.max_overlap(js64))!r} "
          f"f32 {float(j32.max_overlap(js32))!r}, port f64 {t64.max_overlap(ts64)!r} "
          f"f32 {t32.max_overlap(ts32)!r}")
    print(f"  {time.perf_counter() - t0:.1f} s", flush=True)


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 20000)
