"""Assertions.

Port of mundy_tpu/core/errors.py (ref: `MUNDY_THROW_REQUIRE` /
`MUNDY_THROW_ASSERT`, `throw_assert.hpp:119-178`). `require` is the
always-on host check; `debug_assert` is the development check of values
that live on the device, off unless MUNDY_TPU_DEBUG is set, as the
reference's NDEBUG-gated device assert is compiled out. It never waits for
the card: a condition on the card is reduced there and copied to pinned
host memory behind an event, and the message is printed once that event
has completed, at a later debug_assert or at `debug_report` (and at exit).
"""

from __future__ import annotations

import atexit
import os
import sys
from typing import Any

import torch

# the reference's switch: debug asserts are off unless enabled
DEBUG_ASSERTS = os.environ.get("MUNDY_TPU_DEBUG", "0") not in ("0", "", "false")

_PENDING: list = []  # (event, pinned host flag, message) of conditions on the card


class MundyError(RuntimeError):
    """Framework error with context."""


def require(condition: Any, message: str = "requirement failed") -> None:
    """Host-side requirement (always on). Raises MundyError.

    A tensor condition must hold everywhere; reading it waits for the device.
    """
    ok = bool(condition.all()) if isinstance(condition, torch.Tensor) else bool(condition)
    if not ok:
        raise MundyError(message)


def _failed(message: str) -> None:
    print(f"MUNDY_TPU ASSERT FAILED: {message}", file=sys.stderr, flush=True)


def debug_report(wait: bool = False) -> None:
    """Print the messages of the pending device conditions that failed and
    whose copies have landed; with `wait`, wait for all of them first."""
    still = []
    for event, flag, message in _PENDING:
        if wait:
            event.synchronize()
        if event.query():
            if not bool(flag):
                _failed(message)
        else:
            still.append((event, flag, message))
    _PENDING[:] = still


def debug_assert(condition: Any, message: str = "assertion failed") -> None:
    """Value assertion, enabled by MUNDY_TPU_DEBUG=1; non-fatal (prints the
    message), free when disabled. A condition on the CPU is checked at
    once; one on the card is checked when its copy has landed, with no host
    sync (see the module note)."""
    if not DEBUG_ASSERTS:
        return
    if isinstance(condition, torch.Tensor) and condition.is_cuda:
        ok = condition.all().reshape(1)
        flag = torch.empty(1, dtype=torch.bool, pin_memory=True)
        flag.copy_(ok, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        _PENDING.append((event, flag, message))
        debug_report()
        return
    ok = bool(condition.all()) if isinstance(condition, torch.Tensor) else bool(condition)
    if not ok:
        _failed(message)


atexit.register(lambda: _PENDING and debug_report(wait=True))
