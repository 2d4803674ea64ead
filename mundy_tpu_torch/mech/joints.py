"""Joint elements.

Port of mundy_tpu/mech/joints.py (ref: `mundy/mech/src/mundy_mech/
primitives/BallJoint.hpp`): a ball joint pins a point of one body to a
point of another, here a stiff zero-rest-length spring between the two
body-frame attachment points (the penalty form).
"""

from __future__ import annotations

from typing import Optional

import torch

from mundy_tpu_torch.math.linalg import cross
from mundy_tpu_torch.math.quaternion import quat_rotate


def ball_joint_forces(pos: torch.Tensor, quat: torch.Tensor, body_a: torch.Tensor,
                      body_b: torch.Tensor, offset_a: torch.Tensor, offset_b: torch.Tensor,
                      stiffness, mask: Optional[torch.Tensor] = None):
    """(forces (N, 3), torques (N, 3)) of J penalty ball joints: body_a,
    body_b (J,) ints, offset_a, offset_b (J, 3) body-frame attachments,
    stiffness a scalar or (J,), mask (J,) bool. Each body's terms are summed
    in joint order, A's sides before B's, as the reference's scatter-adds."""
    a, b = body_a.long(), body_b.long()
    ra = quat_rotate(quat[a], offset_a)
    rb = quat_rotate(quat[b], offset_b)
    pa = pos[a] + ra
    pb = pos[b] + rb
    k = torch.broadcast_to(torch.as_tensor(stiffness, dtype=pos.dtype, device=pos.device),
                           a.shape)
    if mask is not None:
        k = torch.where(mask, k, 0.0)
    f_on_a = k[..., None] * (pb - pa)  # pulls A toward B
    forces = torch.zeros_like(pos)
    forces.index_put_((a,), f_on_a, accumulate=True)
    forces.index_put_((b,), -f_on_a, accumulate=True)
    torques = torch.zeros_like(pos)
    torques.index_put_((a,), cross(ra, f_on_a), accumulate=True)
    torques.index_put_((b,), cross(rb, -f_on_a), accumulate=True)
    return forces, torques
