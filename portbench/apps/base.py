"""The run loop every app driver shares: set-up blocks and measured blocks
through the program's `run_blocks`, with its regrows counted from the log
lines, and the positions and exact guarantees read off a state that keeps
body g at row g (`state.pos`). An app's driver subclasses `RunLoop` and
builds its program's app as `self.sim`."""

from __future__ import annotations

import torch

from mundy_tpu_torch.driver.regrow import run_blocks


class RunLoop:
    def __init__(self, params: dict, traffic: dict, device):
        self.params = params
        self.dtype = getattr(torch, traffic["dtype"])
        self.block_steps = int(traffic["block_steps"])
        self.n = int(params["num_spheres"])
        self.regrows = 0
        self.sim = self.make_sim(params, traffic["dtype"], device)

    def make_sim(self, params: dict, dtype: str, device):
        raise NotImplementedError

    def _log(self, line: str) -> None:
        if "capacity overflow" in line:
            self.regrows += 1

    def start(self, pos, key_words):
        return self.sim.init(pos=pos, key_words=key_words)

    def setup_block(self, state, block: dict):
        return run_blocks(self.sim, state, block["steps"], block["steps"], log=self._log)

    def block(self, state):
        return run_blocks(self.sim, state, self.block_steps, self.block_steps, log=self._log)

    def positions(self, state) -> torch.Tensor:
        return state.pos.clone()

    def checks(self, state) -> dict:
        """Exact guarantees: (reading, limit) each."""
        return {"overflow": (int(bool(state.overflow)), 0),
                "nonfinite": (int((~torch.isfinite(state.pos)).sum()), 0)}
