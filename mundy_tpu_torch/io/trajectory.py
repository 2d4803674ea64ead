"""Trajectory writer/reader over the native fastio engine.

Port of mundy_tpu/io/trajectory.py: frames of float32 positions in the
`MTRJ1` format (header: magic, n_particles i64, n_fields i64; frame: step
i64, time f64, crc32 u32, pad u32, payload n x 3 float32), streamed through
the compiled C++ writer, with numpy writing and reading the same bytes
where no compiler exists. Positions may be numpy arrays or tensors on any
device (copied to the host per frame).
"""

from __future__ import annotations

import ctypes
import struct
import zlib
from typing import Optional

import numpy as np
import torch

from mundy_tpu_torch.io.native import library

MAGIC = b"MTRJ1\x00\x00\x00"


def host_array(a, dtype=None) -> np.ndarray:
    """A C-contiguous numpy copy of an array or a tensor on any device."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.ascontiguousarray(np.asarray(a), dtype=dtype)


class TrajectoryWriter:
    def __init__(self, path: str, n_particles: int, append: bool = False):
        self.path = path
        self.n = int(n_particles)
        self._lib = library()
        if self._lib is not None:
            self._h = self._lib.mundy_traj_open_write(path.encode(), self.n,
                                                      1 if append else 0)
            if not self._h:
                raise IOError(f"cannot open {path}")
            self._f = None
        else:  # numpy: the same format
            self._h = None
            self._f = open(path, "ab" if append else "wb")
            if not append:
                self._f.write(MAGIC)
                self._f.write(struct.pack("<qq", self.n, 1))

    def write(self, step: int, time: float, positions) -> None:
        pos = host_array(positions, np.float32)
        if pos.shape != (self.n, 3):
            raise ValueError(f"expected ({self.n}, 3), got {pos.shape}")
        if self._h is not None:
            rc = self._lib.mundy_traj_write_frame(self._h, int(step), float(time),
                                                  pos.ctypes.data_as(ctypes.c_void_p))
            if rc != 0:
                raise IOError(f"write_frame failed rc={rc}")
        else:
            payload = pos.tobytes()
            self._f.write(struct.pack("<qdII", int(step), float(time),
                                      zlib.crc32(payload) & 0xFFFFFFFF, 0))
            self._f.write(payload)

    def close(self) -> None:
        if self._h is not None:
            self._lib.mundy_traj_close(self._h)
            self._h = None
        elif self._f is not None:
            self._f.close()
            self._f = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class TrajectoryReader:
    def __init__(self, path: str):
        self.path = path
        self._lib = library()
        if self._lib is not None:
            self._h = self._lib.mundy_traj_open_read(path.encode())
            if not self._h:
                raise IOError(f"cannot open/parse {path}")
            self.n = int(self._lib.mundy_traj_num_particles(self._h))
            self.num_frames = int(self._lib.mundy_traj_num_frames(self._h))
        else:
            self._h = None
            with open(path, "rb") as f:
                if f.read(8) != MAGIC:
                    raise IOError("bad magic")
                self.n, _nf = struct.unpack("<qq", f.read(16))
                f.seek(0, 2)
                end = f.tell()
            self._frame_bytes = 24 + self.n * 12
            self.num_frames = (end - 24) // self._frame_bytes

    def read(self, idx: int):
        """-> (step, time, positions (n, 3) float32); CRC-verified."""
        if self._h is not None:
            step = ctypes.c_int64()
            time = ctypes.c_double()
            pos = np.empty((self.n, 3), np.float32)
            rc = self._lib.mundy_traj_read_frame(self._h, int(idx), ctypes.byref(step),
                                                 ctypes.byref(time),
                                                 pos.ctypes.data_as(ctypes.c_void_p))
            if rc == -3:
                raise IOError(f"frame {idx}: CRC mismatch (corrupt trajectory)")
            if rc != 0:
                raise IOError(f"read_frame failed rc={rc}")
            return int(step.value), float(time.value), pos
        with open(self.path, "rb") as f:
            f.seek(24 + idx * self._frame_bytes)
            step, time, crc, _pad = struct.unpack("<qdII", f.read(24))
            payload = f.read(self.n * 12)
        if (zlib.crc32(payload) & 0xFFFFFFFF) != crc:
            raise IOError(f"frame {idx}: CRC mismatch (corrupt trajectory)")
        return step, time, np.frombuffer(payload, np.float32).reshape(self.n, 3)

    def close(self) -> None:
        if self._h is not None:
            self._lib.mundy_traj_close_read(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def hilbert_keys_native(pos, domain_low, domain_high, bits: int = 10) -> Optional[np.ndarray]:
    """(N,) uint32 Hilbert keys of positions through the C++ path (None
    without the native library); math/spacefill.hilbert_key_3d computes the
    same keys from cell coordinates."""
    lib = library()
    if lib is None:
        return None
    p = host_array(pos, np.float64)
    lo = host_array(domain_low, np.float64)
    hi = host_array(domain_high, np.float64)
    keys = np.empty(len(p), np.uint32)
    lib.mundy_hilbert_keys(p.ctypes.data_as(ctypes.c_void_p), len(p),
                           lo.ctypes.data_as(ctypes.c_void_p),
                           hi.ctypes.data_as(ctypes.c_void_p), bits,
                           keys.ctypes.data_as(ctypes.c_void_p))
    return keys
