"""IO: checkpoint/restart, trajectory output, step telemetry.

Port of mundy_tpu/io (the role of the reference's IOBroker,
`IOBroker.hpp:64-252`): app-state checkpoints (npz of the state's leaves),
VTK/XYZ snapshots and CRC-checked trajectories through the native fastio
library, and StepLogger for the rank-gated tps logging
(`HP1...neigh_linker.cpp:1496-1546`).
"""

from mundy_tpu_torch.io.checkpoint import latest_checkpoint, load_checkpoint, save_checkpoint
from mundy_tpu_torch.io.telemetry import StepLogger
from mundy_tpu_torch.io.vtk import write_vtk_points, write_xyz

__all__ = [
    "save_checkpoint",
    "load_checkpoint",
    "latest_checkpoint",
    "write_vtk_points",
    "write_xyz",
    "StepLogger",
]
