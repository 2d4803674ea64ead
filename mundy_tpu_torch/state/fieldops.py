"""Field BLAS: masked per-entity tensor ops.

Port of mundy_tpu/state/fieldops.py (ref: `NgpFieldBLAS.hpp:40-523`): fill,
copy, scale, axpy/axpby, product, and the dot/nrm2/asum/amax/amin
reductions, each with an optional selector mask (padded or unselected
entities must not pollute a reduction). The reference's reductions take
`axis_names` to span a device mesh (the `stk::all_reduce_*` role); the
port's take the ranks' parallel.comm.Group in that slot: dot, nrm2 and asum
sum over the ranks (psum), amax takes their maximum (pmax), amin their
minimum (a pmax of the negated value). None reduces on this rank alone.
"""

from __future__ import annotations

from typing import Optional

import torch


def _bmask(mask: Optional[torch.Tensor], x: torch.Tensor) -> Optional[torch.Tensor]:
    if mask is None:
        return None
    return mask.reshape(mask.shape + (1,) * (x.ndim - mask.ndim))


def _psum(v: torch.Tensor, group) -> torch.Tensor:
    return v if group is None else group.psum(v.reshape(1))[0]


def _pmax(v: torch.Tensor, group) -> torch.Tensor:
    return v if group is None else group.pmax(v.reshape(1))[0]


def field_fill(x: torch.Tensor, value, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    if mask is None:
        return torch.full_like(x, value)
    return torch.where(_bmask(mask, x), value, x)


def field_copy(dst: torch.Tensor, src: torch.Tensor,
               mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    if mask is None:
        return src
    return torch.where(_bmask(mask, dst), src, dst)


def field_scale(x: torch.Tensor, alpha, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    out = alpha * x
    return out if mask is None else torch.where(_bmask(mask, x), out, x)


def field_axpy(alpha, x: torch.Tensor, y: torch.Tensor,
               mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    out = alpha * x + y
    return out if mask is None else torch.where(_bmask(mask, y), out, y)


def field_axpby(alpha, x: torch.Tensor, beta, y: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    out = alpha * x + beta * y
    return out if mask is None else torch.where(_bmask(mask, y), out, y)


def field_product(x: torch.Tensor, y: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    out = x * y
    return out if mask is None else torch.where(_bmask(mask, x), out, x)


def field_dot(x: torch.Tensor, y: torch.Tensor, mask: Optional[torch.Tensor] = None,
              axis_names=None) -> torch.Tensor:
    prod = x * y
    if mask is not None:
        prod = torch.where(_bmask(mask, prod), prod, 0.0)
    return _psum(torch.sum(prod), axis_names)


def field_nrm2(x: torch.Tensor, mask: Optional[torch.Tensor] = None,
               axis_names=None) -> torch.Tensor:
    return torch.sqrt(field_dot(x, x, mask, axis_names))


def field_asum(x: torch.Tensor, mask: Optional[torch.Tensor] = None,
               axis_names=None) -> torch.Tensor:
    v = torch.abs(x)
    if mask is not None:
        v = torch.where(_bmask(mask, v), v, 0.0)
    return _psum(torch.sum(v), axis_names)


def field_amax(x: torch.Tensor, mask: Optional[torch.Tensor] = None,
               axis_names=None) -> torch.Tensor:
    v = torch.abs(x)
    if mask is not None:
        v = torch.where(_bmask(mask, v), v, -torch.inf)
    return _pmax(torch.amax(v), axis_names)


def field_amin(x: torch.Tensor, mask: Optional[torch.Tensor] = None,
               axis_names=None) -> torch.Tensor:
    v = torch.abs(x)
    if mask is not None:
        v = torch.where(_bmask(mask, v), v, torch.inf)
    return -_pmax(-torch.amin(v), axis_names)


def field_randomize(gen: torch.Generator, x: torch.Tensor, low=0.0, high=1.0,
                    mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """A uniform refill on [low, high) from `gen` (ref: field_randomize,
    NgpFieldBLAS.hpp:101-175; the reference draws from a jax.random key)."""
    r = low + torch.rand(x.shape, generator=gen, dtype=x.dtype, device=x.device) * (high - low)
    return r if mask is None else torch.where(_bmask(mask, x), r, x)
