"""Batched quaternion algebra, convention w-x-y-z (scalar first).

Port of mundy_tpu/math/quaternion.py: Hamilton products, scalar-first storage, and
`quat_rotate(q, v) = q v q*` as the active rotation of `v` by `q`. All
functions broadcast over leading batch axes; quaternions are (..., 4). The
arithmetic order is the reference's, so float64 results agree to rounding.
The rod energy (mech/rod.py) is differentiated through quat_normalize, so
its guard is `torch.maximum`, whose gradient at a tie splits as
`jnp.maximum`'s does.
"""

from __future__ import annotations

import torch

from mundy_tpu_torch.math.linalg import cross, dot, norm


def maximum(x: torch.Tensor, floor: float) -> torch.Tensor:
    """jnp.maximum(x, floor) for a python floor, gradient included (a 0-d
    CPU tensor rides along with a CUDA x as a scalar: no device copy)."""
    return torch.maximum(x, torch.tensor(floor, dtype=x.dtype))


def quat_identity(shape=(), dtype=torch.float32, device=None) -> torch.Tensor:
    """Identity quaternion(s) of shape (*shape, 4)."""
    q = torch.zeros(tuple(shape) + (4,), dtype=dtype, device=device)
    q[..., 0] = 1.0
    return q


def quat_multiply(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """Hamilton product q1 * q2."""
    w1, x1, y1, z1 = q1[..., 0], q1[..., 1], q1[..., 2], q1[..., 3]
    w2, x2, y2, z2 = q2[..., 0], q2[..., 1], q2[..., 2], q2[..., 3]
    return torch.stack(
        [
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ],
        dim=-1,
    )


def quat_conjugate(q: torch.Tensor) -> torch.Tensor:
    # q * (1, -1, -1, -1), exactly, without a constant on the device
    return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


def quat_normalize(q: torch.Tensor, eps: float = 1e-30) -> torch.Tensor:
    n = maximum(norm(q), eps)
    return q / n[..., None]


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vector(s) v by quaternion(s) q (active rotation, q v q*), in
    the expanded 15-multiply form."""
    w = q[..., 0]
    u = q[..., 1:4]
    uv = cross(u, v)
    uuv = cross(u, uv)
    return v + 2.0 * (w[..., None] * uv + uuv)


def quat_inverse_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate v by the inverse of unit quaternion q."""
    return quat_rotate(quat_conjugate(q), v)


def quat_from_axis_angle(axis: torch.Tensor, angle) -> torch.Tensor:
    """Unit quaternion for a rotation of `angle` radians about unit `axis`."""
    half = 0.5 * torch.as_tensor(angle, dtype=axis.dtype, device=axis.device)
    return torch.cat([torch.cos(half)[..., None], torch.sin(half)[..., None] * axis], dim=-1)


def quat_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion -> rotation matrix (..., 3, 3)."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = torch.stack([
        1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
        2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
        2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
    ], dim=-1)
    return m.reshape(m.shape[:-1] + (3, 3))


def quat_slerp(q0: torch.Tensor, q1: torch.Tensor, t) -> torch.Tensor:
    """Spherical linear interpolation between unit quaternions (a lerp
    below sin(theta) = 1e-6)."""
    d = dot(q0, q1)
    q1 = torch.where(d[..., None] < 0.0, -q1, q1)
    d = torch.clamp(torch.abs(d), -1.0, 1.0)
    theta = torch.arccos(d)
    sin_theta = torch.sin(theta)
    t = torch.as_tensor(t, dtype=q0.dtype, device=q0.device)
    use_lerp = sin_theta < 1e-6
    safe = torch.where(use_lerp, 1.0, sin_theta)
    w0 = torch.where(use_lerp, 1.0 - t, torch.sin((1.0 - t) * theta) / safe)
    w1 = torch.where(use_lerp, t, torch.sin(t * theta) / safe)
    return quat_normalize(w0[..., None] * q0 + w1[..., None] * q1)


def quat_from_omega_dt(omega: torch.Tensor, dt) -> torch.Tensor:
    """Rotation quaternion exp(omega dt / 2) for angular velocity `omega`
    over the step `dt`, branch-free: below |omega dt / 2| = 1e-8 the sinc
    takes its series 1 - a^2 / 6."""
    rot_vec = 0.5 * torch.as_tensor(dt, dtype=omega.dtype, device=omega.device) * omega
    angle = norm(rot_vec)
    small = angle < 1e-8
    safe = torch.where(small, 1.0, angle)
    sinc = torch.where(small, 1.0 - angle * angle / 6.0, torch.sin(safe) / safe)
    return torch.cat([torch.cos(angle)[..., None], sinc[..., None] * rot_vec], dim=-1)


def quat_integrate(q: torch.Tensor, omega: torch.Tensor, dt) -> torch.Tensor:
    """One explicit step of dq/dt = 1/2 omega * q by the exponential map
    (norm-preserving), renormalised."""
    return quat_normalize(quat_multiply(quat_from_omega_dt(omega, dt), q))


def quat_from_matrix(m: torch.Tensor) -> torch.Tensor:
    """Rotation matrix (..., 3, 3) -> unit quaternion, branch-free
    (Shepperd's method: the largest of the four pivots, first on a tie, as
    jnp.argmax picks)."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22
    qw = torch.stack([1.0 + tr, 1.0 + m00 - m11 - m22,
                      1.0 + m11 - m00 - m22, 1.0 + m22 - m00 - m11], dim=-1)
    pivot = torch.argmax(qw, dim=-1, keepdim=True)
    s = torch.sqrt(maximum(torch.gather(qw, -1, pivot)[..., 0], 1e-30)) * 2.0
    cases = torch.stack([
        torch.stack([0.25 * s, (m21 - m12) / s, (m02 - m20) / s, (m10 - m01) / s], dim=-1),
        torch.stack([(m21 - m12) / s, 0.25 * s, (m01 + m10) / s, (m02 + m20) / s], dim=-1),
        torch.stack([(m02 - m20) / s, (m01 + m10) / s, 0.25 * s, (m12 + m21) / s], dim=-1),
        torch.stack([(m10 - m01) / s, (m02 + m20) / s, (m12 + m21) / s, 0.25 * s], dim=-1),
    ], dim=-2)
    idx = pivot[..., None].expand(pivot.shape[:-1] + (1, 4))
    return quat_normalize(torch.gather(cases, -2, idx)[..., 0, :])
