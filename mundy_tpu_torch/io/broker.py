"""Results IO broker: periodic trajectory frames and a final VTK snapshot.

Port of mundy_tpu/io/broker.py (the role of the reference's `IOBroker`,
`IOBroker.hpp:64`, written every `io_frequency` steps from the HP1 time
loop, `HP1...neigh_linker.cpp:1518`): CRC-checked trajectory frames
(io/trajectory.py) plus a final VTK point cloud.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from mundy_tpu_torch.io.trajectory import TrajectoryWriter, host_array
from mundy_tpu_torch.io.vtk import write_vtk_points


def positions_of(sim, state) -> np.ndarray:
    """Flat (N, 3) host positions of an app state: the sim's
    `positions(state)` accessor where it has one (the row engines), else
    `state.pos` reshaped to (N, 3) (filament states carry (F, M, 3))."""
    fn = getattr(sim, "positions", None)
    pos = fn(state) if fn is not None else state.pos
    return host_array(pos).reshape(-1, 3)


class ResultsBroker:
    """Writes `trajectory.mtrj` frames every `every` steps into `directory`,
    and `final.vtk` at finalize. `every <= 0` disables periodic frames (the
    final snapshot is still written)."""

    def __init__(self, directory: str, n_particles: int, every: int,
                 dt: float = 0.0, append: bool = False):
        os.makedirs(directory, exist_ok=True)
        self.directory = directory
        self.every = int(every)
        self.dt = float(dt)
        self.n = int(n_particles)
        self._writer: Optional[TrajectoryWriter] = None
        self._append = append
        self.frames_written = 0

    @property
    def trajectory_path(self) -> str:
        return os.path.join(self.directory, "trajectory.mtrj")

    def write_frame(self, step: int, sim, state) -> None:
        pos = positions_of(sim, state)
        if self._writer is None:
            self._writer = TrajectoryWriter(self.trajectory_path, pos.shape[0],
                                            append=self._append)
        self._writer.write(int(step), self.dt * int(step), pos)
        self.frames_written += 1

    def maybe_write(self, step: int, sim, state) -> None:
        if self.every > 0 and int(step) % self.every == 0:
            self.write_frame(step, sim, state)

    def finalize(self, step: int, sim, state) -> str:
        """Final VTK snapshot; closes the trajectory. Returns the VTK path."""
        path = os.path.join(self.directory, "final.vtk")
        write_vtk_points(path, positions_of(sim, state))
        self.close()
        return path

    def close(self) -> None:
        if self._writer is not None:
            self._writer.close()
            self._writer = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
