"""Vectorized KMC crosslinker state machine.

Port of mundy_tpu/kmc/crosslinkers.py (ref: the HP1 driver,
`HP1_mock_rework_agents_text_mesh_neigh_linker.cpp:177-346`):

- binding rate of a left-bound crosslinker to a candidate site
  z_i = A exp(-(1/2) (k/kT) (|dr| - r0)^2);
- per crosslinker Z = dt sum_i z_i, P(any bind) = 1 - exp(-Z), the event
  chosen by one uniform draw against the running cumsum of
  z_i / Z (1 - exp(-Z)) dt;
- a doubly-bound crosslinker unbinds with P = 1 - exp(-dt koff).

The draws are the reference's keyed streams bit for bit: threefry-2x32 of
the (gid, salt) counter planes under fold_in(key, step)
(dynamics/brownian.py holds the generator).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from mundy_tpu_torch.dynamics.brownian import fold_in, threefry_2x32


class BINDING_STATE:
    """ref: BINDING_STATE_CHANGE enum in the HP1 driver."""

    UNBOUND = 0
    LEFT_BOUND = 1
    DOUBLY_BOUND = 2


def binding_rate_gaussian(dr_mag: torch.Tensor, k_spring, rest_length, kt,
                          rate_prefactor) -> torch.Tensor:
    """z = A exp(-k (|dr| - r0)^2 / (2 kT)) (HP1 `:209-216`)."""
    x = dr_mag - rest_length
    return rate_prefactor * torch.exp(-0.5 * (k_spring / kt) * x * x)


def uniform_keyed(key, step: int, gid: torch.Tensor, salt: int,
                  dtype=torch.float32) -> torch.Tensor:
    """Per-entity uniforms in (0, 1), a pure function of (key, step, gid):
    the first output word of threefry-2x32 over the counters (gid, salt)
    under fold_in(key, step), mapped by its top 23 bits with a half-ulp
    offset in float32, then cast to `dtype`. `key` is the two uint32 words
    as python ints."""
    kd = fold_in(key, step)
    g = gid.reshape(-1).to(torch.int64)
    y0, _y1 = threefry_2x32(kd, g, int(salt) & 0xFFFFFFFF)
    u = (y0 >> 9).to(torch.float32) * 2.0 ** -23 + 2.0 ** -24
    return u.reshape(gid.shape).to(dtype)


def kmc_bind_events(key, step: int, rates: torch.Tensor, mask: torch.Tensor, dt,
                    gid: torch.Tensor):
    """At most one binding event per crosslinker: (do_bind (X,) bool,
    chosen (X,) int64 column of the K axis). Bind iff u < 1 - exp(-Z); the
    event is the first j with u < cumsum_j[(1 - exp(-Z)) / Z dt z_j]."""
    z = torch.where(mask, rates, 0.0) * dt
    z_tot = z.sum(dim=1)
    u = uniform_keyed(key, step, gid, 0x0B1D, dtype=rates.dtype)
    p_any = -torch.expm1(-z_tot)  # 1 - exp(-Z), accurate for small Z
    do_bind = (u < p_any) & (z_tot > 0)
    scale = torch.where(z_tot > 0, p_any / torch.clamp(z_tot, min=1e-30), 0.0)
    cum = torch.cumsum(z * scale[:, None], dim=1)
    hit = u[:, None] < cum
    chosen = torch.argmax(hit.to(torch.int8), dim=1)  # first hit, 0 if none
    return do_bind, chosen


def kmc_unbind_events(key, step: int, koff: torch.Tensor, dt,
                      gid: torch.Tensor) -> torch.Tensor:
    """(X,) bool: unbind with P = 1 - exp(-dt koff) (HP1 `:310-340`)."""
    u = uniform_keyed(key, step, gid, 0xB1ED, dtype=koff.dtype)
    return u < -torch.expm1(-dt * koff)


class CrosslinkerKMCResult(NamedTuple):
    state: torch.Tensor  # (X,) int32 binding state
    bound_to: torch.Tensor  # (X,) int32 target of the right head (-1 if none)


def crosslinker_kmc_step(key, step: int, state: torch.Tensor, bound_to: torch.Tensor,
                         candidate_idx: torch.Tensor, candidate_rates: torch.Tensor,
                         candidate_mask: torch.Tensor, koff, dt,
                         gid: torch.Tensor) -> CrosslinkerKMCResult:
    """One KMC sweep: left-bound crosslinkers may bind, doubly-bound ones may
    unbind (exclusive per entity per step, as the reference's selector-split
    kernels)."""
    x = state.shape[0]
    koff = torch.as_tensor(koff, dtype=candidate_rates.dtype,
                           device=candidate_rates.device).expand(x)
    left = state == BINDING_STATE.LEFT_BOUND
    doubly = state == BINDING_STATE.DOUBLY_BOUND
    do_bind, chosen = kmc_bind_events(key, step, candidate_rates, candidate_mask, dt, gid)
    do_bind = do_bind & left
    new_target = torch.gather(candidate_idx, 1, chosen[:, None])[:, 0]
    do_unbind = kmc_unbind_events(key, step, koff, dt, gid) & doubly
    new_state = torch.where(do_bind, BINDING_STATE.DOUBLY_BOUND, state)
    new_state = torch.where(do_unbind, BINDING_STATE.LEFT_BOUND, new_state)
    new_bound = torch.where(do_bind, new_target, bound_to)
    new_bound = torch.where(do_unbind, -1, new_bound)
    return CrosslinkerKMCResult(state=new_state.to(torch.int32),
                                bound_to=new_bound.to(torch.int32))
