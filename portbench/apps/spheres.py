"""Drives the program's flat-engine spheres app (`SpheresSim`, the engine
the CLI runs for `app: spheres`) through the shared run loop, and reads its
counters out for the harness."""

from __future__ import annotations

from mundy_tpu_torch.driver.apps.spheres import SpheresConfig, SpheresSim
from mundy_tpu_torch.dynamics.brownian import brownian_velocity_keyed
from portbench.apps.base import RunLoop


class Driver(RunLoop):
    def make_sim(self, params: dict, dtype: str, device):
        return SpheresSim(SpheresConfig(**params, dtype=dtype), device=device)

    def counters(self, state) -> dict:
        return {"rebuilds": state.rebuild_count}

    def noise_call(self, state):
        sim = self.sim
        return lambda: brownian_velocity_keyed(state.key, state.step, sim.gids, sim.diffusion,
                                               sim.config.dt, dtype=self.dtype)
