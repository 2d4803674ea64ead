"""Ring-rotated dense RPY mobility over the ranks of a Group.

Port of mundy_tpu/parallel/ring_rpy.py. The O(N^2) RPY product U = M F is
sharded by rotating (source position, source force) blocks around the ring
of ranks with `ppermute` while each rank accumulates its own targets'
partial sums: O(N^2 / d) pair work per rank. On a group of one rank the
apply is rpy_apply_dense with free (not minimum-image) separations, the
self pair excluded, the overlap branch as asked and the self term added.

The reference permutes the blocks once more after the last hop, sending
every block home unused; here the ring stops after d - 1 hops. Position and
force travel in one (n, 6) message per hop.

`make_replicated_ring_apply` is the form LCPSpheresSim's `rpy_ring` mode
calls over ranks (the reference's shard_map of the ring over global
arrays): every rank holds the whole (N, 3) positions and forces, takes its
contiguous block through the ring and all_gathers the velocities, one
all_gather an apply, so every rank ends with the same (N, 3) result.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from mundy_tpu_torch.math.spacefill import hilbert_key_3d
from mundy_tpu_torch.mobility.rpy import _rpy_pair_velocity, rpy_self_mobility
from mundy_tpu_torch.parallel.comm import Group, ring_perms


def _rpy_block(tgt_pos: torch.Tensor, src_pos: torch.Tensor, src_f: torch.Tensor,
               radius, viscosity, exclude_diagonal: bool, overlap_correction: bool,
               chunk: int = 512) -> torch.Tensor:
    """Partial U (n_t, 3) of all targets against one source block, in
    chunks of `chunk` targets; `exclude_diagonal` drops the pairs i == i of
    a block against itself."""
    n_t, n_s = tgt_pos.shape[0], src_pos.shape[0]
    src_idx = torch.arange(n_s, device=tgt_pos.device)
    parts = []
    for start in range(0, n_t, chunk):
        tgt = tgt_pos[start:start + chunk]
        rvec = tgt[:, None, :] - src_pos[None, :, :]
        u = _rpy_pair_velocity(rvec, src_f[None, :, :], radius, viscosity,
                               overlap_correction)
        if exclude_diagonal:
            me = start + torch.arange(tgt.shape[0], device=tgt_pos.device)
            u = torch.where((me[:, None] == src_idx[None, :])[..., None], 0.0, u)
        parts.append(u.sum(1))
    return torch.cat(parts) if parts else torch.zeros_like(tgt_pos)


def make_ring_rpy_apply(group: Group, radius: float, viscosity: float,
                        include_self: bool = True, overlap_correction: bool = False,
                        chunk: int = 512) -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
    """apply(pos_local, f_local) -> this rank's velocities (n_local, 3),
    where each rank holds its contiguous block of the (N, 3) positions and
    forces (rank r the r-th of d equal blocks): the distributed dense RPY
    product."""
    d = group.size
    up, _ = ring_perms(d)

    def apply(pos_local: torch.Tensor, f_local: torch.Tensor) -> torch.Tensor:
        u = torch.zeros_like(pos_local)
        src = torch.cat([pos_local, f_local], dim=1)
        for hop in range(d):
            # hop 0: the sources are this rank's own block, i == i excluded
            u = u + _rpy_block(pos_local, src[:, :3], src[:, 3:], radius, viscosity,
                               hop == 0, overlap_correction, chunk)
            if hop < d - 1:
                src = group.ppermute(src, up)
        if include_self:
            u = u + rpy_self_mobility(f_local, radius, viscosity)
        return u

    return apply


def ring_split_rule(n_total: int, d: int) -> None:
    """Raise ValueError unless the N bodies split into d equal blocks."""
    if n_total % d != 0:
        raise ValueError(f"hydro='rpy_ring' over {d} ranks needs num_spheres % ranks == 0, "
                         f"got {n_total} spheres")


def make_replicated_ring_apply(group: Group, n_total: int, radius: float, viscosity: float,
                               include_self: bool = True, overlap_correction: bool = False,
                               chunk: int = 512
                               ) -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
    """apply(pos, f) -> the (N, 3) velocities, where every rank holds the
    whole (N, 3) positions and forces: rank r's block [r N/d, (r+1) N/d)
    through the ring apply, then one all_gather of the velocity blocks."""
    ring_split_rule(n_total, group.size)
    block = make_ring_rpy_apply(group, radius, viscosity, include_self, overlap_correction,
                                chunk)
    n_loc = n_total // group.size
    mine = slice(group.rank * n_loc, (group.rank + 1) * n_loc)

    def apply(pos: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
        u = block(pos[mine], f[mine])
        return torch.cat(group.all_gather(u)) if group.size > 1 else u

    return apply


def hilbert_shard_permutation(pos, domain_low, domain_high, bits: int = 10) -> np.ndarray:
    """Load-balance permutation: the particles sorted along the Hilbert
    curve (stable), so equal contiguous chunks map to ranks with spatial
    locality. The stk::balance RCB analog; cells from float64 fractions of
    the domain, `bits` per axis."""
    if isinstance(pos, torch.Tensor):
        pos = pos.detach().cpu().numpy()
    lo = np.asarray(domain_low, np.float64)
    hi = np.asarray(domain_high, np.float64)
    frac = (np.asarray(pos, np.float64) - lo) / (hi - lo)
    cells = np.clip((frac * (1 << bits)).astype(np.int64), 0, (1 << bits) - 1)
    keys = hilbert_key_3d(cells[:, 0], cells[:, 1], cells[:, 2], bits=bits)
    return np.argsort(keys, kind="stable")
