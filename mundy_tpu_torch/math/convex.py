"""Convex QP / LCP solver: projected gradient descent with Barzilai-Borwein
steps (BBPGD), matrix-free.

Port of mundy_tpu/math/convex.py. The reference runs the iteration in a
`lax.while_loop` on the device; here it is a Python loop that reads the
loop condition on the host once per iteration, so the iteration count is
exactly the reference's.

A sharded solve (each rank holding its block of x, q and the mask) passes
its parallel.comm.Group as `PGDConfig.group`, the role of the reference's
`axis_names`: the residual is a pmax over ranks and the four inner products
of an iteration (dx.dx, dx.dg, dg.dg, x_new.x_new) one psum of a 4-vector,
each element summed on its own as the reference's four psums are. Every
value the host reads to steer the loop (keep going, stalls, iterations since
the best residual, take the best) comes from those reduced values, so every
rank leaves the loop at the same iteration.

A replicated solve (every rank holding the whole x, as LCPSpheresSim's
`rpy_ring` mode over ranks does) passes its Group as `PGDConfig.replicas`
instead: nothing is summed over the ranks (that would count each entry d
times), and the one host read per iteration, the exit test, is a pmax of
the ranks' stop flags, so every rank leaves at the same iteration even
where their arithmetic differs in its last bits.

ref: `mundy/math/src/mundy_math/convex.hpp` (`solve_cqpp:790`,
`solve_lcp:840`, `BBStepStrategy:498`, residual policies `:434-495`) and the
BBPGD loop of `scrap/lcp_spheres/StkNgpLCP.cpp:705-875`.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import torch

from mundy_tpu_torch.io.telemetry import host_read, trace


@dataclasses.dataclass(frozen=True)
class Space:
    """Separable box space [lo, hi]^n; +-inf encodes one-sided bounds."""

    lo: torch.Tensor
    hi: torch.Tensor

    def project(self, x: torch.Tensor) -> torch.Tensor:
        return torch.minimum(torch.maximum(x, self.lo), self.hi)


def unconstrained(dtype=torch.float32, device=None) -> Space:
    return Space(torch.tensor(-torch.inf, dtype=dtype, device=device),
                 torch.tensor(torch.inf, dtype=dtype, device=device))


def lower_bound(lo, dtype=None, device=None) -> Space:
    lo = torch.as_tensor(lo, dtype=dtype, device=device)
    return Space(lo, torch.full_like(lo, torch.inf))


def upper_bound(hi, dtype=None, device=None) -> Space:
    hi = torch.as_tensor(hi, dtype=dtype, device=device)
    return Space(torch.full_like(hi, -torch.inf), hi)


def bounded(lo, hi, dtype=None, device=None) -> Space:
    return Space(torch.as_tensor(lo, dtype=dtype, device=device),
                 torch.as_tensor(hi, dtype=dtype, device=device))


@dataclasses.dataclass(frozen=True)
class PGDConfig:
    """Solver controls (mirrors `PGDConfig`, `convex.hpp:520`)."""

    max_iters: int = 1000
    tol: float = 1e-8
    # "bb1" | "bb2" | "alternating" (the reference driver alternates)
    bb_rule: str = "alternating"
    # "projected_gradient" (Dai & Fletcher 2005 eq 2.2) | "projected_diff"
    residual: str = "projected_gradient"
    # progress exit: stop after `patience` iterations without improving the
    # best residual by `min_improve` (relative); the best iterate is returned
    patience: int = 60
    min_improve: float = 1e-2
    # the ranks of a sharded solve (parallel.comm.Group: psum/pmax over
    # them), the reference's axis_names; None = one device
    group: Optional[object] = None
    # the ranks of a replicated solve, which take the exit test together
    # (a pmax of their stop flags); None = no other rank
    replicas: Optional[object] = None


class SolveResult(NamedTuple):
    """Mirrors `SolveResult` (`convex.hpp:528-541`). `alpha` is the final
    trustworthy BB step, which the next solve of a slowly varying problem
    takes as its `alpha0`. num_iters is a python int."""

    x: torch.Tensor
    num_iters: int
    residual: torch.Tensor
    converged: torch.Tensor
    alpha: torch.Tensor


def _residual(x, g, space: Space, cfg: PGDConfig, mask) -> torch.Tensor:
    dtype = x.dtype
    if cfg.residual == "projected_gradient":
        # at the active lower bound only a negative gradient violates
        # stationarity, at the upper bound only a positive one
        tol = 10 * torch.finfo(dtype).eps
        r = torch.abs(g)
        r = torch.where(x < space.lo + tol, torch.clamp(-g, min=0.0), r)
        r = torch.where(x > space.hi - tol, torch.clamp(g, min=0.0), r)
    elif cfg.residual == "projected_diff":
        h = 1e-6
        r = torch.abs(x - space.project(x - h * g)) / h
    else:
        raise ValueError(f"unknown residual policy {cfg.residual!r}")
    if mask is not None:
        r = torch.where(mask, r, 0.0)
    zero = torch.zeros((), dtype=dtype, device=x.device)
    res = torch.maximum(r.max(), zero) if r.numel() else zero
    if cfg.group is not None:
        res = cfg.group.pmax(res.reshape(1))[0]
    return res


def _dots(cfg: PGDConfig, dx, dg, x_new) -> tuple:
    """(dx.dx, dx.dg, dg.dg, x_new.x_new), summed over the ranks of a
    sharded solve in one all_reduce of the stacked 4-vector."""
    sums = ((dx * dx).sum(), (dx * dg).sum(), (dg * dg).sum(), (x_new * x_new).sum())
    if cfg.group is None:
        return sums
    v = cfg.group.psum(torch.stack(sums))
    return v[0], v[1], v[2], v[3]


def solve_cqpp(apply_A: Callable[[torch.Tensor], torch.Tensor], q: torch.Tensor,
               space: Space, x0: Optional[torch.Tensor] = None,
               config: PGDConfig = PGDConfig(), mask: Optional[torch.Tensor] = None,
               alpha0: Optional[torch.Tensor] = None) -> SolveResult:
    """Minimize 1/2 x^T A x + q^T x over the separable box `space`.

    `apply_A` computes A x (A symmetric positive semidefinite). `mask`
    restricts the solve to active entries: padded slots stay at the
    projected zero. First step size 1/res0 unless a previous solve's
    `alpha0` (finite, > 0) is smaller. Mirrors `solve_cqpp`
    (`convex.hpp:790-838`)."""
    dtype, dev = q.dtype, q.device
    one = torch.ones((), dtype=dtype, device=dev)
    tol_t = torch.tensor(config.tol, dtype=dtype, device=dev)
    if x0 is None:
        x0 = torch.zeros_like(q)
    x0 = space.project(x0)
    if mask is not None:
        x0 = torch.where(mask, x0, space.project(torch.zeros_like(x0)))

    def masked(v):
        return torch.where(mask, v, 0.0) if mask is not None else v

    g0 = masked(apply_A(x0) + q)
    res0 = _residual(x0, g0, space, config, mask)
    alpha_init = one / torch.maximum(res0, tol_t)
    if alpha0 is not None:
        a0 = torch.as_tensor(alpha0, dtype=dtype, device=dev)
        good = torch.isfinite(a0) & (a0 > 0.0)
        alpha_init = torch.where(good, torch.minimum(a0, alpha_init), alpha_init)

    eps = torch.finfo(dtype).eps
    keep = one - torch.tensor(config.min_improve, dtype=dtype, device=dev)
    x, g, alpha, alpha_good = x0, g0, alpha_init, alpha_init
    it, res = 0, res0
    stalls = torch.zeros((), dtype=torch.int32, device=dev)
    since_best = torch.zeros((), dtype=torch.int32, device=dev)
    x_best, res_best = x0, res0
    while it < config.max_iters:
        keep_going = (res >= tol_t) & (stalls < 2) & (since_best < config.patience)
        if config.replicas is not None:
            keep_going = config.replicas.pmax((~keep_going).to(torch.int32).reshape(1))[0] == 0
        if not host_read("bbpgd.exit", keep_going):  # the one host read per iteration
            break
        with trace("bbpgd.iter"):
            x_new = space.project(x - alpha * g)
            if mask is not None:
                x_new = torch.where(mask, x_new, x)
            g_new = masked(apply_A(x_new) + q)
            dx = x_new - x
            dg = g_new - g
            dx_dx, dx_dg, dg_dg, x_dx = _dots(config, dx, dg, x_new)
            if config.bb_rule == "bb1":
                a, b = dx_dx, dx_dg
            elif config.bb_rule == "bb2":
                a, b = dx_dg, dg_dg
            elif config.bb_rule == "alternating":  # StkNgpLCP.cpp:849-860
                a, b = (dx_dx, dx_dg) if it % 2 == 1 else (dx_dg, dg_dg)
            else:
                raise ValueError(f"unknown bb_rule {config.bb_rule!r}")
            # b == 0 gives inf, and the `bad` guard keeps the previous step
            b_safe = torch.where(b == 0, one, b)
            alpha_new = torch.where(b == 0, torch.inf, a / b_safe)
            bad = ~(torch.isfinite(alpha_new) & (alpha_new > 0.0))
            alpha_new = torch.where(bad, alpha, alpha_new)
            alpha_new = torch.clamp(alpha_new, 1e-12, 1e12)
            res = _residual(x_new, g_new, space, config, mask)
            # a stall resets the step to the cold-start rule; two in a row exit
            moved = dx_dx > (16.0 * eps * eps) * x_dx
            stalls = torch.where(moved, 0, stalls + 1)
            alpha_new = torch.where(moved, alpha_new, one / torch.maximum(res, tol_t))
            alpha_good = torch.where(moved & ~bad, alpha_new, alpha_good)
            improved = res < res_best * keep
            x_best = torch.where(improved, x_new, x_best)
            res_best = torch.where(improved, res, res_best)
            since_best = torch.where(improved, 0, since_best + 1)
            x, g, alpha, it = x_new, g_new, alpha_new, it + 1
    # on a non-converged exit hand back the best-residual iterate
    take_best = res_best < res
    x = torch.where(take_best, x_best, x)
    res = torch.where(take_best, res_best, res)
    return SolveResult(x=x, num_iters=it, residual=res, converged=res < tol_t,
                       alpha=alpha_good)


def solve_lcp(apply_A: Callable[[torch.Tensor], torch.Tensor], q: torch.Tensor,
              x0: Optional[torch.Tensor] = None, config: PGDConfig = PGDConfig(),
              mask: Optional[torch.Tensor] = None,
              alpha0: Optional[torch.Tensor] = None) -> SolveResult:
    """Solve the LCP 0 <= x  perp  A x + q >= 0 as a CQPP over R+^n
    (`convex.hpp:425,840`)."""
    return solve_cqpp(apply_A, q, lower_bound(torch.zeros_like(q)), x0=x0,
                      config=config, mask=mask, alpha0=alpha0)
