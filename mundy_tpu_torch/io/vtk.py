"""Snapshot writers: legacy VTK polydata and XYZ.

Port of mundy_tpu/io/vtk.py (the visualization role of the reference
IOBroker's Exodus results; ParaView reads both). The text is the
reference's byte for byte; positions and point data may be tensors.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from mundy_tpu_torch.io.trajectory import host_array


def write_vtk_points(path: str, positions, point_data: Optional[dict] = None) -> None:
    """Legacy-ASCII VTK polydata of points with optional scalar/vector data."""
    pos = host_array(positions, np.float32)
    n = pos.shape[0]
    with open(path, "w") as f:
        f.write("# vtk DataFile Version 3.0\nmundy_tpu\nASCII\nDATASET POLYDATA\n")
        f.write(f"POINTS {n} float\n")
        np.savetxt(f, pos, fmt="%.7g")
        f.write(f"VERTICES {n} {2 * n}\n")
        np.savetxt(f, np.stack([np.ones(n, int), np.arange(n)], 1), fmt="%d")
        if point_data:
            f.write(f"POINT_DATA {n}\n")
            for name, arr in point_data.items():
                arr = host_array(arr)
                if arr.ndim == 1:
                    f.write(f"SCALARS {name} float 1\nLOOKUP_TABLE default\n")
                    np.savetxt(f, arr, fmt="%.7g")
                elif arr.ndim == 2 and arr.shape[1] == 3:
                    f.write(f"VECTORS {name} float\n")
                    np.savetxt(f, arr, fmt="%.7g")
                else:
                    raise ValueError(f"point_data '{name}': unsupported shape {arr.shape}")


def write_xyz(path: str, positions, append: bool = False, comment: str = "") -> None:
    """Extended-XYZ frame (append mode builds a trajectory file)."""
    pos = host_array(positions)
    with open(path, "a" if append else "w") as f:
        f.write(f"{pos.shape[0]}\n{comment}\n")
        for p in pos:
            f.write(f"X {p[0]:.8g} {p[1]:.8g} {p[2]:.8g}\n")
