"""Fixed-memory L-BFGS, batched over a leading axis of independent problems.

Port of mundy_tpu/math/lbfgs.py (ref: the dlib-style
`find_min_using_approximate_derivatives`, `mundy/math/src/mundy_math/
minimize.hpp:43-49`, `impl/minimize_impl.hpp:132-409`, which the reference
runs inside device kernels such as the ellipsoid-ellipsoid minimization).

The reference's callers run `jax.vmap(minimize_lbfgs)` over millions of
lanes. Under vmap its `while_loop` applies the body to every lane until no
lane's condition holds and keeps a finished lane's carry. Here the batch is
explicit: `max_iters` iterations run on every lane, and a lane whose `done`
is set keeps its state, so each lane's `x`, `f` and `num_iters` are the
reference's with no host read per iteration. The Armijo line search
evaluates its `max_linesearch` halvings of the step as one batch (the
objective is elementwise over lanes) and takes the first that passes, as
the reference's sequential search does.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch


class MinimizeResult(NamedTuple):
    x: torch.Tensor  # (B, n)
    f: torch.Tensor  # (B,)
    num_iters: torch.Tensor  # (B,) int32
    converged: torch.Tensor  # (B,) bool


def _central_differences(f: Callable, eps: float) -> Callable:
    def grad_fn(x):
        eye = torch.eye(x.shape[-1], dtype=x.dtype, device=x.device) * eps
        return torch.stack([(f(x + eye[i]) - f(x - eye[i])) / (2 * eps)
                            for i in range(x.shape[-1])], dim=-1)

    return grad_fn


def grad_of_sum(f: Callable, x: torch.Tensor) -> torch.Tensor:
    """d sum(f(x)) / dx by autograd from a leaf copy of x (jax.grad of the
    summed objective; with independent lanes, each lane's gradient). Runs
    under enable_grad, so it works inside a caller's no_grad; the result is
    detached."""
    with torch.enable_grad():
        leaf = x.detach().requires_grad_(True)
        (g,) = torch.autograd.grad(f(leaf).sum(), leaf)
    return g


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.sum(a * b, dim=-1)


def minimize_lbfgs(f: Callable[[torch.Tensor], torch.Tensor], x0: torch.Tensor,
                   max_iters: int = 100, memory: int = 8, f_delta_tol: float = 1e-7,
                   grad_tol: float = 1e-10, use_autodiff: bool = True,
                   fd_eps: float = 1e-7, max_linesearch: int = 20) -> MinimizeResult:
    """Minimize B independent problems: `f` maps x (..., B, n) to (..., B),
    elementwise over its leading axes; x0 is (B, n).

    A lane stops when |f_k - f_{k-1}| < f_delta_tol, on a gradient norm
    below grad_tol, when its line search finds no step, or at max_iters
    (ref: `objective_delta_stop_strategy`, `minimize_impl.hpp:194`). The
    line search is backtracking Armijo (c1 = 1e-4) over t = 1, 1/2, ...,
    2^-(max_linesearch - 1). Gradients come from torch.autograd of the summed
    objective, or from central differences with use_autodiff=False."""
    B, n = x0.shape
    dtype, dev = x0.dtype, x0.device
    m = memory
    if use_autodiff:
        def grad_fn(x):
            return grad_of_sum(f, x)
    else:
        grad_fn = _central_differences(f, fd_eps)
    c1 = torch.tensor(1e-4, dtype=dtype, device=dev)
    ts = 0.5 ** torch.arange(max_linesearch, dtype=dtype, device=dev)  # exact halvings

    x = x0
    fx = f(x0).detach()
    g = grad_fn(x0)
    S = torch.zeros((B, m, n), dtype=dtype, device=dev)
    Y = torch.zeros((B, m, n), dtype=dtype, device=dev)
    rho = torch.zeros((B, m), dtype=dtype, device=dev)
    k = torch.zeros((B,), dtype=torch.int32, device=dev)
    done = torch.zeros((B,), dtype=torch.bool, device=dev)

    for it in range(max_iters):
        # every lane still running has taken `it` iterations, so its ring
        # slots are this iteration's; the finished lanes' results are dropped
        q = g
        alphas = [None] * m
        for i in range(m):
            idx = (it - 1 - i) % m
            a = torch.where(rho[:, idx] != 0.0, rho[:, idx] * _dot(S[:, idx], q), 0.0)
            q = q - a[:, None] * Y[:, idx]
            alphas[idx] = a
        newest = (it - 1) % m
        yy = _dot(Y[:, newest], Y[:, newest])
        sy = _dot(S[:, newest], Y[:, newest])
        gamma = torch.where(yy > 0.0, sy / torch.clamp(yy, min=1e-30), 1.0)
        r = gamma[:, None] * q
        for i in range(m):
            idx = (it - m + i) % m
            b = torch.where(rho[:, idx] != 0.0, rho[:, idx] * _dot(Y[:, idx], r), 0.0)
            r = r + (alphas[idx] - b)[:, None] * S[:, idx]
        d = -r
        # steepest descent where d is not a descent direction
        d = torch.where((_dot(g, d) < 0.0)[:, None], d, -g)

        gd = _dot(g, d)
        f_try = f(x[None] + ts[:, None, None] * d[None]).detach()  # (T, B)
        ok = f_try <= fx[None] + (c1 * ts)[:, None] * gd[None]
        first = torch.argmax(ok.to(torch.int8), dim=0)  # the first step that passes
        t = torch.where(ok.any(dim=0), ts[first], 0.0)

        x_new = x + t[:, None] * d
        f_new = f(x_new).detach()
        g_new = grad_fn(x_new)
        s = x_new - x
        y = g_new - g
        sy = _dot(s, y)
        run = ~done
        # the history takes the pair where the curvature condition holds
        upd = run & (sy > 1e-30)
        slot = it % m
        S[:, slot] = torch.where(upd[:, None], s, S[:, slot])
        Y[:, slot] = torch.where(upd[:, None], y, Y[:, slot])
        rho[:, slot] = torch.where(upd, 1.0 / torch.where(upd, sy, 1.0), rho[:, slot])
        conv = ((torch.abs(f_new - fx) < f_delta_tol)
                | (torch.linalg.vector_norm(g_new, dim=-1) < grad_tol) | (t == 0.0))
        x = torch.where(run[:, None], x_new, x)
        fx = torch.where(run, f_new, fx)
        g = torch.where(run[:, None], g_new, g)
        k = k + run.to(torch.int32)
        done = done | conv
    return MinimizeResult(x=x, f=fx, num_iters=k, converged=done)
