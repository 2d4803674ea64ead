"""Build and load the hand-written CUDA kernels of `mundy_tpu_torch/csrc/`.

Each source compiles with nvcc for Hopper (`sm_90a`) into a shared library
with a plain C interface, loaded with ctypes. The library lands in
`build/kernels/` beside the package, named by a hash of its source and
flags, so a later process finds it and skips the build. There is no
fallback: a missing compiler or a failed build raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
# -fmad=false: no kernel contracts a product and a sum into an FMA, so every
# product and sum rounds on its own, as the plain version's separate
# elementwise passes round them (K2's ids and K4's closest-point tie-breaks
# then follow the plain version's)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    for cand in (shutil.which("nvcc"), os.path.join(home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME): cannot build the "
                       "CUDA kernels of mundy_tpu_torch")


def library_path(name: str) -> Path:
    """Where the library built from csrc/<name>.cu lives (hash-keyed)."""
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}_{digest}.so"


def build(name: str) -> Path:
    """Compile csrc/<name>.cu unless its hash-keyed library exists. The
    compiler's report (registers, shared memory, spills) is kept beside the
    library as <lib>.log."""
    lib = library_path(name)
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
    lib.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{proc.stderr}")
    os.replace(tmp, lib)  # atomic: a concurrent process never loads half a file
    return lib


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load the kernel library of csrc/<name>.cu."""
    return ctypes.CDLL(str(build(name)))
