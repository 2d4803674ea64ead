"""Device time of the step's keyed noise (`brownian_velocity_keyed`, once a
step), called alone at the cell's gid shape at the final state, after 3
warm-up calls: the device's busy time in a profiler trace of 20 calls,
per call. The program has no span around its noise yet, so the layer is
traced from outside the step."""

import torch

from portbench import devtrace

CALLS = 20


def read(ctx):
    if torch.device(ctx.device).type != "cuda":
        return None
    call = ctx.driver.noise_call(ctx.state)
    for _ in range(3):
        call()

    def calls():
        for _ in range(CALLS):
            call()

    return 1e3 * devtrace.traced(calls, CALLS).busy_s / CALLS
