"""Plain reference of the dry LCP spheres (BASELINE config #2, hydro none).

Each step, from positions x: the Brownian velocities u of the gid-keyed
stream; for every pair (i, j) its normal n = (x_j - x_i) / d and signed
separation s = d - 2r; then the linear complementarity problem over the
contact forces g >= 0 of the pairs,

    0 <= g  perp  s + dt n . (v_j - v_i) >= 0,
    v = u + M F(g),  F_i = sum over its pairs of -g n (+g n on j),

with the local drag M = 1 / (6 pi mu r), solved by projected gradient with
Barzilai-Borwein steps to TOL (far below the stated overlap tolerance);
then x <- wrap(x + dt v). The solution's velocities are unique, so any
solver that meets the conditions gives them. The pairs constrained are the
configuration's candidates: those within 2r + constraint_buffer when the
list was built, rebuilt when a sphere has moved half the buffer since. The
problem is solved over the near candidates first; any other candidate that
the velocities would push past the stated tolerance joins it and the solve
repeats, so the answer meets the conditions over every candidate. A pair
outside the list is not constrained that step, as the configuration
states: from a start with deep overlaps, the first step's large pushes can
leave such pairs overlapping.

`guarantees` reads the stated non-penetration off a set of positions: the
deepest overlap 2r - d over every pair, minimum image, in float64.
"""

from __future__ import annotations

import math

import torch

from portbench.reference.common import brownian, min_image, pairs_within, wrap

NEAR = 0.2  # first guess of the pairs that can touch within the step
TOL = {torch.float64: 1e-10, torch.float32: 1e-5}
MAX_ITERS = 5000
PATIENCE = 300


def _residual(x, g) -> torch.Tensor:
    r = torch.where(x > 0, g.abs(), torch.clamp(-g, min=0.0))
    return r.max() if r.numel() else torch.zeros((), dtype=g.dtype, device=g.device)


def bbpgd(apply, q, x0, tol: float, max_iters: int = MAX_ITERS,
          patience: int = PATIENCE):
    """Minimize 1/2 x.Ax + q.x over x >= 0: projected gradient with
    alternating Barzilai-Borwein steps; returns (x of the least residual,
    that residual, iterations)."""
    x = torch.clamp(x0, min=0.0)
    g = apply(x) + q
    res = float(_residual(x, g))
    alpha = 1.0 / max(res, tol)
    best_x, best_res, since = x, res, 0
    it = 0
    while it < max_iters and res >= tol and since < patience:
        xn = torch.clamp(x - alpha * g, min=0.0)
        gn = apply(xn) + q
        s, y = xn - x, gn - g
        sy = float((s * y).sum())
        den = sy if it % 2 else float((y * y).sum())
        num = float((s * s).sum()) if it % 2 else sy
        a = num / den if den != 0.0 else math.nan
        x, g = xn, gn
        res = float(_residual(x, g))
        alpha = a if (math.isfinite(a) and a > 0) else 1.0 / max(res, tol)
        if res < 0.99 * best_res:
            best_x, best_res, since = x, res, 0
        else:
            since += 1
        it += 1
    if res < best_res:
        best_x, best_res = x, res
    return best_x, best_res, it


class _Step:
    """The contact geometry and the LCP pieces of one step over a pair set."""

    def __init__(self, pos, i, j, box, radius, dt):
        sep = min_image(pos[j] - pos[i], box)
        d = torch.linalg.vector_norm(sep, dim=-1)
        self.n = sep / torch.clamp(d, min=1e-12)[:, None]
        self.s0 = d - 2.0 * radius
        self.i, self.j, self.dt = i, j, dt

    def forces(self, g, sel, nbodies):
        f = torch.zeros((nbodies, 3), dtype=self.n.dtype, device=self.n.device)
        push = g[:, None] * self.n[sel]
        f.index_add_(0, self.j[sel], push)
        f.index_add_(0, self.i[sel], -push)
        return f

    def rate(self, v, sel):
        """dt n . (v_j - v_i) over the pairs `sel`."""
        return self.dt * (self.n[sel] * (v[self.j[sel]] - v[self.i[sel]])).sum(-1)


def follow(params: dict, pos: torch.Tensor, key_words, step0: int, n_steps: int,
           dtype=torch.float64) -> torch.Tensor:
    """Positions after n_steps steps from `pos` (n, 3), body g at row g, the
    first step numbered step0, computed in `dtype`."""
    box = float(params["box_size"])
    r = float(params["radius"])
    dt = float(params["dt"])
    buffer = float(params["constraint_buffer"])
    tol_stated = float(params["max_allowable_overlap"])
    tol = TOL.get(dtype, tol_stated)
    mob = 1.0 / (6.0 * math.pi * float(params["viscosity"]) * r)
    n = pos.shape[0]
    p = pos.to(dtype)
    built, gam, keys = None, None, None
    for step in range(step0, step0 + n_steps):
        if built is None or float(
                torch.linalg.vector_norm(min_image(p - built, box), dim=-1).max()) > buffer / 2:
            i, j = pairs_within(p, box, 2.0 * r + buffer)
            new_keys = i * n + j
            new_gam = torch.zeros(i.shape, dtype=dtype, device=p.device)
            if keys is not None and keys.numel():  # warm start by pair identity
                order = torch.argsort(keys)
                at = torch.clamp(torch.searchsorted(keys[order], new_keys), max=keys.numel() - 1)
                hit = keys[order][at] == new_keys
                new_gam = torch.where(hit, gam[order][at], new_gam)
            built, gam, keys = p, new_gam, new_keys
        u = brownian(key_words, step, n, float(params["diffusion_coeff"]), dt, dtype, p.device)
        st = _Step(p, i, j, box, r, dt)
        sel = torch.nonzero(st.s0 < NEAR).squeeze(1)
        warm = gam.clone()
        for rnd in range(8):
            q = st.s0[sel] + st.rate(u, sel)

            def apply(x, sel=sel):
                return st.rate(mob * st.forces(x, sel, n), sel)

            x = bbpgd(apply, q, warm[sel], tol)[0]
            warm[sel] = x
            v = u + mob * st.forces(x, sel, n)
            gap = st.s0 + st.rate(v, slice(None))
            out = torch.ones_like(gap, dtype=torch.bool)
            out[sel] = False
            late = torch.nonzero(out & (gap < -tol_stated)).squeeze(1)
            if late.numel() == 0 or rnd == 7:
                break
            sel = torch.cat([sel, late])
        gam = torch.zeros_like(gam)
        gam[sel] = x
        p = wrap(p + dt * v, box)
    return p


def guarantees(params: dict, pos: torch.Tensor) -> dict:
    """{"overlap": the largest 2r - d over all pairs of `pos` (n, 3) closer
    than 2r, minimum image, in float64; 0 where none overlaps}."""
    box = float(params["box_size"])
    r = float(params["radius"])
    p = pos.to(torch.float64)
    i, j = pairs_within(p, box, 2.0 * r)
    if i.numel() == 0:
        return {"overlap": 0.0}
    d = torch.linalg.vector_norm(min_image(p[j] - p[i], box), dim=-1)
    return {"overlap": float((2.0 * r - d).max())}
