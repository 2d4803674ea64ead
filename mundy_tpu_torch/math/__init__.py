"""Math: small-vector algebra, quaternions, space-filling-curve keys,
the BBPGD QP/LCP solver and L-BFGS.

Port of mundy_tpu/math (ref: `mundy/math/`).
"""

from mundy_tpu_torch.math import linalg, quaternion, spacefill, convex, lbfgs
from mundy_tpu_torch.math.tolerance import get_relative_tolerance, get_zero_tolerance
from mundy_tpu_torch.math.linalg import dot, cross, norm, norm_sq, normalize, outer
from mundy_tpu_torch.math.quaternion import (
    quat_identity,
    quat_multiply,
    quat_conjugate,
    quat_normalize,
    quat_rotate,
    quat_inverse_rotate,
    quat_from_axis_angle,
    quat_to_matrix,
    quat_from_matrix,
    quat_slerp,
    quat_from_omega_dt,
    quat_integrate,
)
from mundy_tpu_torch.math.spacefill import (
    morton_key_3d,
    cell_linear_index,
    hilbert_key_3d,
    hilbert_positions_and_directors,
)
from mundy_tpu_torch.math.convex import (
    Space,
    unconstrained,
    lower_bound,
    upper_bound,
    bounded,
    PGDConfig,
    SolveResult,
    solve_cqpp,
    solve_lcp,
)
from mundy_tpu_torch.math.lbfgs import minimize_lbfgs

__all__ = [
    "linalg",
    "quaternion",
    "spacefill",
    "convex",
    "lbfgs",
    "get_relative_tolerance",
    "get_zero_tolerance",
    "dot",
    "cross",
    "norm",
    "norm_sq",
    "normalize",
    "outer",
    "quat_identity",
    "quat_multiply",
    "quat_conjugate",
    "quat_normalize",
    "quat_rotate",
    "quat_inverse_rotate",
    "quat_from_axis_angle",
    "quat_to_matrix",
    "quat_from_matrix",
    "quat_slerp",
    "quat_from_omega_dt",
    "quat_integrate",
    "morton_key_3d",
    "cell_linear_index",
    "hilbert_key_3d",
    "hilbert_positions_and_directors",
    "Space",
    "unconstrained",
    "lower_bound",
    "upper_bound",
    "bounded",
    "PGDConfig",
    "SolveResult",
    "solve_cqpp",
    "solve_lcp",
    "minimize_lbfgs",
]
