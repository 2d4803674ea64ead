"""Host-side capacity regrow for capacity-bounded state.

Port of mundy_tpu/driver/regrow.py. Every structure is capacity-bounded with
a sticky overflow flag; when a block of steps trips the flag, the host grows
the violated capacities, rebuilds the search structures, and RETRIES the
block from the last good state (an overflowed block may have silently
dropped interactions, so its physics is discarded).

Each sim exposes `regrow(state) -> state` and `run_block(state, n)`.
Growing is geometric, so any finite required capacity is reached in O(log)
retries; `max_regrows` bounds pathological configs.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Optional

import torch

from mundy_tpu_torch.io.telemetry import host_read, trace

GROW = 1.6  # geometric capacity growth per regrow


def _overflowed(state: Any) -> bool:
    return bool(host_read("overflow", state.overflow))


def _sync(state: Any) -> None:
    if state.overflow.device.type == "cuda":
        torch.cuda.synchronize(state.overflow.device)


def grow_int(v: int, align: int = 8) -> int:
    """v * GROW rounded up to `align` (always strictly larger)."""
    g = int(v * GROW) + 1
    return ((g + align - 1) // align) * align


def run_blocks(sim, state, num_steps: int, block: int,
               log: Callable[[str], None] = print,
               status: Optional[Callable[[Any, int, float], str]] = None,
               max_regrows: int = 8):
    """Shared app run loop: block stepping + overflow-triggered regrow.

    `status(state, done, tps) -> str` formats the per-block log line.
    Returns the final state. Raises only if regrowing `max_regrows` times
    still overflows.
    """
    regrows = 0
    while _overflowed(state):  # init-time overflow: regrow before stepping
        if regrows >= max_regrows:
            raise RuntimeError("capacity overflow persists after "
                               f"{regrows} regrows")
        log(f"capacity overflow at init: regrow #{regrows + 1}")
        with trace("regrow"):
            state = sim.regrow(state)
        regrows += 1
    _sync(state)
    t0 = time.perf_counter()
    done = 0
    while done < num_steps:
        n = min(block, num_steps - done)
        with trace("block"):
            new_state = sim.run_block(state, n)
        if _overflowed(new_state):
            if regrows >= max_regrows:
                raise RuntimeError("capacity overflow persists after "
                                   f"{regrows} regrows")
            log(f"capacity overflow in block at step {done}: "
                f"regrow #{regrows + 1}, retrying block")
            with trace("regrow"):
                state = sim.regrow(state)  # retry from the last GOOD state
            regrows += 1
            continue
        state = new_state
        done += n
        tps = done / max(time.perf_counter() - t0, 1e-9)
        log(status(state, done, tps) if status is not None
            else f"step {done}/{num_steps}  tps={tps:.2f}")
    return state
