"""Kinetic Monte Carlo crosslinker binding and unbinding.

Port of mundy_tpu/kmc (ref: `actions_crosslinkers.hpp`).
"""

from mundy_tpu_torch.kmc.crosslinkers import (
    BINDING_STATE,
    binding_rate_gaussian,
    kmc_bind_events,
    kmc_unbind_events,
    crosslinker_kmc_step,
)

__all__ = [
    "BINDING_STATE",
    "binding_rate_gaussian",
    "kmc_bind_events",
    "kmc_unbind_events",
    "crosslinker_kmc_step",
]
