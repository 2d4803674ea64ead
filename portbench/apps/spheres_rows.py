"""Drives the program's row-engine spheres app (`RowSpheresSim`) through the
shared run loop. No cell runs it: it is the second path of the program with
which `readings.py --app spheres_rows` witnesses the row engine's missed
contacts across a periodic face (PERF.md, Open questions)."""

from __future__ import annotations

import torch

from mundy_tpu_torch.driver.apps.spheres import SpheresConfig
from mundy_tpu_torch.driver.apps.spheres_rows import RowSpheresSim
from portbench.apps.base import RunLoop


class Driver(RunLoop):
    def make_sim(self, params: dict, dtype: str, device):
        return RowSpheresSim(SpheresConfig(**params, dtype=dtype), device=device)

    def positions(self, state) -> torch.Tensor:
        """(n, 3) positions, body g at row g (a new tensor)."""
        rows = state.rows
        out = torch.full((self.n, 3), float("nan"), dtype=rows.pos.dtype, device=rows.pos.device)
        out[rows.gid[rows.valid].long()] = rows.pos[rows.valid]
        return out

    def checks(self, state) -> dict:
        rows = state.rows
        seen = torch.bincount(rows.gid[rows.valid].long(), minlength=self.n)
        return {"bodies_lost": (int((seen != 1).sum()), 0),
                "overflow": (int(bool(state.overflow)), 0),
                "nonfinite": (int((~torch.isfinite(rows.pos[rows.valid])).sum()), 0)}

    def counters(self, state) -> dict:
        return {"rebuilds": state.rebuild_count}
