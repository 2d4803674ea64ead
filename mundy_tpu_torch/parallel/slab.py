"""Slab domain decomposition with ring halo exchange and migration.

Port of mundy_tpu/parallel/slab.py over the ranks of a Group (one process
per rank): the reference's `axis_index` and `axis_size` are `group.rank`
and `group.size`, its `lax.ppermute` is `Group.ppermute`.

Each rank owns the particles of one x-slab of the periodic box, in up to
`capacity` slots with an active mask:
- halo: the particles within `halo_width` of a slab face are copied to the
  neighbouring rank (periodic ring), untranslated (min-image metrics
  handle the wrap);
- migration: after the position update, particles whose x left the slab
  are handed to the ring neighbour on that side (one neighbour per step,
  valid while a step moves a particle less than a slab width).
Buffers have fixed capacities and overflow flags, the neighbor lists'
contract. A mask travels in the same message as its payload (one more
column), so no boolean crosses the wire.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from mundy_tpu_torch.parallel.comm import Group, ring_perms


class ShardState(NamedTuple):
    pos: torch.Tensor  # (C, 3) this rank's particle slots
    active: torch.Tensor  # (C,) bool
    gid: torch.Tensor  # (C,) int32 global ids (for the noise and diagnostics)
    overflow: torch.Tensor  # () bool, sticky


def _compact(values: torch.Tensor, keep: torch.Tensor, capacity: int, fill=0.0):
    """The rows of `values` where `keep`, packed in order into the first
    slots of a (capacity, ...) buffer (the rest `fill`). Returns (buffer,
    mask, count), count the rows that wanted in (it may pass capacity)."""
    slot = torch.cumsum(keep.to(torch.int64), 0) - 1
    dest = torch.where(keep & (slot < capacity), slot, capacity)  # capacity: the dump slot
    buf = values.new_full((capacity + 1,) + tuple(values.shape[1:]), fill)
    buf[dest] = values
    mask = torch.zeros((capacity + 1,), dtype=torch.bool, device=values.device)
    mask[dest] = keep
    return buf[:capacity], mask[:capacity], keep.sum()


def slab_bounds(group: Group, box_x: float, dtype, device=None):
    """(lo, hi) of this rank's slab along x, as 0-d tensors of `dtype`
    (the width and the rank's index cast to dtype first, as the reference
    computes them)."""
    width = torch.tensor(box_x / group.size, dtype=dtype, device=device)
    lo = torch.tensor(float(group.rank), dtype=dtype, device=device) * width
    return lo, lo + width


def _send_both_ways(group: Group, to_left: torch.Tensor, to_right: torch.Tensor):
    """(from_left, from_right): what the ring neighbours below and above
    sent this way."""
    up, dn = ring_perms(group.size)
    from_right = group.ppermute(to_left, dn)  # rank i sends to i - 1
    from_left = group.ppermute(to_right, up)
    return from_left, from_right


def halo_exchange(pos: torch.Tensor, active: torch.Tensor, group: Group, box_x: float,
                  halo_width: float, halo_capacity: int):
    """The neighbour ranks' particles near this slab's faces.

    Returns (halo_pos (2H, 3), halo_mask (2H,), overflow): the left
    neighbour's first, then the right one's. Periodic ring: rank 0's left
    face borders rank d - 1's right face."""
    lo, hi = slab_bounds(group, box_x, pos.dtype, pos.device)
    near_lo = active & (pos[:, 0] < lo + halo_width)
    near_hi = active & (pos[:, 0] >= hi - halo_width)
    send_l, mask_l, n_l = _compact(pos, near_lo, halo_capacity)
    send_r, mask_r, n_r = _compact(pos, near_hi, halo_capacity)
    overflow = (n_l > halo_capacity) | (n_r > halo_capacity)
    from_left, from_right = _send_both_ways(
        group, torch.cat([send_l, mask_l[:, None].to(pos.dtype)], dim=1),
        torch.cat([send_r, mask_r[:, None].to(pos.dtype)], dim=1))
    halo = torch.cat([from_left, from_right])
    return halo[:, :3].contiguous(), halo[:, 3] > 0.5, overflow


def migrate(state: ShardState, group: Group, box_x: float) -> ShardState:
    """Hand the particles that left this slab to the adjacent rank, after
    wrapping x into the periodic box. Leavers are classified by the
    minimum-image offset from the slab centre, which is symmetric and
    wrap-safe (a one-sided test can tag a wrapped particle as going both
    ways and duplicate it). Each way takes up to capacity // 4 leavers;
    arrivals fill the free slots in order."""
    dtype, dev = state.pos.dtype, state.pos.device
    capacity = state.pos.shape[0]
    lo, hi = slab_bounds(group, box_x, dtype, dev)

    pos = state.pos.clone()
    pos[:, 0] = torch.remainder(state.pos[:, 0], box_x)
    width = hi - lo
    center = 0.5 * (lo + hi)
    delta = pos[:, 0] - center
    delta = delta - box_x * torch.round(delta / box_x)
    going_left = state.active & (delta < -0.5 * width)
    going_right = state.active & (delta >= 0.5 * width) & ~going_left
    staying = state.active & ~going_left & ~going_right

    mig_cap = capacity // 4
    # one message a way: position, gid (exact in the float as the
    # reference sends it) and the mask
    packed = torch.cat([pos, state.gid[:, None].to(dtype)], dim=1)
    send_l, mask_l, n_l = _compact(packed, going_left, mig_cap)
    send_r, mask_r, n_r = _compact(packed, going_right, mig_cap)
    overflow = state.overflow | (n_l > mig_cap) | (n_r > mig_cap)
    from_left, from_right = _send_both_ways(
        group, torch.cat([send_l, mask_l[:, None].to(dtype)], dim=1),
        torch.cat([send_r, mask_r[:, None].to(dtype)], dim=1))
    incoming = torch.cat([from_left, from_right])
    incoming_m = incoming[:, 4] > 0.5

    # the k-th arrival takes the k-th free slot
    free = ~staying
    overflow = overflow | (incoming_m.sum() > free.sum())
    free_rank = torch.cumsum(free.to(torch.int64), 0) - 1
    inc_rank = torch.cumsum(incoming_m.to(torch.int64), 0) - 1
    slot_of_rank = torch.full((capacity + 1,), capacity, dtype=torch.int64, device=dev)
    slot_of_rank[torch.where(free, free_rank, capacity)] = torch.arange(capacity, device=dev)
    dest = torch.where(incoming_m,
                       slot_of_rank[torch.clamp(inc_rank, 0, capacity - 1)], capacity)

    new_pos = torch.cat([torch.where(staying[:, None], pos, 0.0), pos.new_zeros((1, 3))])
    new_gid = torch.cat([torch.where(staying, state.gid, 0), state.gid.new_zeros(1)])
    new_active = torch.cat([staying, staying.new_zeros(1)])
    new_pos[dest] = incoming[:, :3]
    new_gid[dest] = incoming[:, 3].to(state.gid.dtype)
    new_active[dest] = incoming_m
    return ShardState(pos=new_pos[:capacity], active=new_active[:capacity],
                      gid=new_gid[:capacity], overflow=overflow)
