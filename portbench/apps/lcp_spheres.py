"""Drives the program's dry LCP spheres app (`LCPSpheresSim`, hydro none)
through the shared run loop with the between-block refits on, and reads its
counters and solver guarantee out for the harness."""

from __future__ import annotations

import torch

from mundy_tpu_torch.driver.apps.lcp_spheres import LCPSpheresConfig, LCPSpheresSim
from mundy_tpu_torch.dynamics.brownian import brownian_velocity_keyed
from mundy_tpu_torch.ops.kernels import row_extract, seg_onehot
from portbench.apps.base import RunLoop


class Driver(RunLoop):
    def make_sim(self, params: dict, dtype: str, device):
        return LCPSpheresSim(LCPSpheresConfig(**params, dtype=dtype), device=device)

    def setup_block(self, state, block: dict):
        if block.get("resize", True):
            return super().setup_block(state, block)
        # a block at fixed capacities, as the timed blocks begin
        return self.sim.run_block(state, block["steps"], resize=False)

    def checks(self, state) -> dict:
        """The exact guarantees, and every solve of the run stopped by its
        tolerance before the stated iteration cap."""
        cap = int(self.params["max_col_iterations"])
        return dict(super().checks(state), lcp_iters_max=(state.lcp_iters_max, cap - 1))

    def counters(self, state) -> dict:
        return {"rebuilds": state.rebuild_count, "lcp_iters": state.lcp_iters,
                "k2_launches": row_extract.row_neighbor_extract.launches,
                "k3_launches": seg_onehot.strided_onehot_segment_sum.launches}

    def k2_layout(self, state):
        """(pos, cutoff, K, capacity slack, box): what K2's row layout is
        built from at this state."""
        sim = self.sim
        return (state.pos, 2.0 * sim.search_radius, min(sim.config.max_neighbors, sim.rows_k),
                sim.rows_slack, float(self.params["box_size"]))

    def k3_shape(self, state) -> tuple:
        """(nb, W, B, active pairs) of K3's strided layout at this state."""
        sim = self.sim
        return sim.nb_blocks, sim.act_window, sim.seg_block, int(state.act_count)

    def noise_call(self, state):
        c = self.sim.config
        gid = torch.arange(self.n, dtype=torch.int32, device=state.pos.device)
        return lambda: brownian_velocity_keyed(state.key, state.step, gid, c.diffusion_coeff,
                                               c.dt, dtype=self.dtype)
