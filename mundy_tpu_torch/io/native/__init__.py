"""Native (C++) IO runtime: compiled on first use, loaded with ctypes.

Port of mundy_tpu/io/native/__init__.py. `fastio.cpp` (a byte-identical
copy of the reference's source) holds buffered binary trajectory frames
with CRC integrity and batch Hilbert keys. It compiles with
`g++ -O3 -shared -fPIC -std=c++17` into `build/native/` beside the package,
named by a hash of the source, so a later process finds it and skips the
build. Where no compiler exists `library()` returns None and the callers
write and read the same format with numpy (host IO, not a device path).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Optional

SOURCE = Path(__file__).resolve().parent / "fastio.cpp"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "native"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_LIB = None
_TRIED = False


def library_path() -> Path:
    """Where the library built from fastio.cpp lives (hash-keyed)."""
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"fastio_{digest}.so"


def build_library() -> Optional[Path]:
    """Compile fastio.cpp unless its hash-keyed library exists; None when
    there is no compiler or the build fails."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", *CXX_FLAGS, str(SOURCE), "-o", str(tmp)]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
    except (subprocess.SubprocessError, FileNotFoundError):
        tmp.unlink(missing_ok=True)
        return None
    os.replace(tmp, out)  # atomic: a concurrent process never loads half a file
    return out


def library() -> Optional[ctypes.CDLL]:
    """The loaded native library, or None if it cannot be built."""
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    _TRIED = True
    path = build_library()
    if path is None:
        return None
    lib = ctypes.CDLL(str(path))
    lib.mundy_traj_open_write.restype = ctypes.c_void_p
    lib.mundy_traj_open_write.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_int]
    lib.mundy_traj_write_frame.restype = ctypes.c_int
    lib.mundy_traj_write_frame.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_double, ctypes.c_void_p]
    lib.mundy_traj_close.argtypes = [ctypes.c_void_p]
    lib.mundy_traj_open_read.restype = ctypes.c_void_p
    lib.mundy_traj_open_read.argtypes = [ctypes.c_char_p]
    lib.mundy_traj_num_particles.restype = ctypes.c_int64
    lib.mundy_traj_num_particles.argtypes = [ctypes.c_void_p]
    lib.mundy_traj_num_frames.restype = ctypes.c_int64
    lib.mundy_traj_num_frames.argtypes = [ctypes.c_void_p]
    lib.mundy_traj_read_frame.restype = ctypes.c_int
    lib.mundy_traj_read_frame.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p]
    lib.mundy_traj_close_read.argtypes = [ctypes.c_void_p]
    lib.mundy_hilbert_keys.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_void_p]
    _LIB = lib
    return _LIB
