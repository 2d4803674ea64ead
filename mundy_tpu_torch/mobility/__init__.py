"""Mobility operators: force -> velocity maps for Stokes suspensions.

Port of mundy_tpu/mobility (ref: `compute_mobility/` with the local-drag and
RPY techniques, and the RPY kernel of `StkNgpLCP.cpp:296-390`): matrix-free
applies for the collision solver and the drift.
"""

from mundy_tpu_torch.mobility.local_drag import (
    local_drag_mobility,
    local_drag_angular_mobility,
)
from mundy_tpu_torch.mobility.rpy import (
    rpy_apply_dense,
    rpy_apply_neighbors,
    rpy_flow_at,
    rpy_self_mobility,
)
from mundy_tpu_torch.mobility.ewald import EwaldRPY, build_ewald_rpy, ewald_rpy_apply
from mundy_tpu_torch.mobility.spectral import (
    SpectralEwaldRPY,
    build_spectral_ewald,
    se_rpy_apply,
    se_wave_apply,
)
from mundy_tpu_torch.mobility.periphery import (
    Periphery,
    build_sphere_periphery,
    double_layer_flow,
    no_slip_correction,
    surface_densities,
)

__all__ = [
    "local_drag_mobility",
    "local_drag_angular_mobility",
    "rpy_apply_dense",
    "rpy_apply_neighbors",
    "rpy_flow_at",
    "rpy_self_mobility",
    "EwaldRPY",
    "build_ewald_rpy",
    "ewald_rpy_apply",
    "SpectralEwaldRPY",
    "build_spectral_ewald",
    "se_rpy_apply",
    "se_wave_apply",
    "Periphery",
    "build_sphere_periphery",
    "double_layer_flow",
    "no_slip_correction",
    "surface_densities",
]
