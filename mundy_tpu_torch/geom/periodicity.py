"""Periodic-box metrics: free-space, orthorhombic, per-axis, triclinic.

Port of mundy_tpu/geom/periodicity.py: one dataclass holds a cell matrix
(box vectors in columns), its inverse and a per-axis periodic mask. The
fractional round-trip keeps the reference's arithmetic order so wrapped
positions agree bit for bit; `torch.round` rounds half to even, as
`jnp.round` does. Matrix products run in full float32 (the port never
enables TF32).
"""

from __future__ import annotations

import torch

from mundy_tpu_torch.core.containers import frozen_dataclass, static_field


@frozen_dataclass
class Metric:
    """cell: (..., 3, 3) column-vector lattice matrix; inv_cell: its inverse;
    periodic: (..., 3) bool per-axis flags. `diagonal` marks orthorhombic
    cells, whose fractional maps are elementwise multiplies."""

    cell: torch.Tensor
    inv_cell: torch.Tensor
    periodic: torch.Tensor
    diagonal: bool = static_field(default=False)

    def to_fractional(self, p: torch.Tensor) -> torch.Tensor:
        if self.diagonal:
            return p * torch.diagonal(self.inv_cell, dim1=-2, dim2=-1)
        return torch.einsum("...ij,...j->...i", self.inv_cell, p)

    def from_fractional(self, f: torch.Tensor) -> torch.Tensor:
        if self.diagonal:
            return f * torch.diagonal(self.cell, dim1=-2, dim2=-1)
        return torch.einsum("...ij,...j->...i", self.cell, f)

    def frac_minimum_image(self, f: torch.Tensor) -> torch.Tensor:
        """Map fractional components to [-1/2, 1/2) on periodic axes."""
        return torch.where(self.periodic, f - torch.round(f), f)

    def frac_wrap_to_unit_cell(self, f: torch.Tensor) -> torch.Tensor:
        return torch.where(self.periodic, f - torch.floor(f), f)

    def sep(self, p1: torch.Tensor, p2: torch.Tensor) -> torch.Tensor:
        """Minimum-image separation vector p2 - p1."""
        return self.from_fractional(self.frac_minimum_image(self.to_fractional(p2 - p1)))

    def wrap(self, p: torch.Tensor) -> torch.Tensor:
        """Wrap points into the primary cell."""
        return self.from_fractional(self.frac_wrap_to_unit_cell(self.to_fractional(p)))

    def shift_image(self, p: torch.Tensor, image: torch.Tensor) -> torch.Tensor:
        """Shift a point by integer image counts (..., 3)."""
        return p + self.from_fractional(image.to(p.dtype))

    def distance(self, p1: torch.Tensor, p2: torch.Tensor) -> torch.Tensor:
        return torch.linalg.vector_norm(self.sep(p1, p2), dim=-1)


def free_space(dtype=torch.float32, device=None) -> Metric:
    eye = torch.eye(3, dtype=dtype, device=device)
    return Metric(cell=eye, inv_cell=eye,
                  periodic=torch.zeros(3, dtype=torch.bool, device=device),
                  diagonal=True)


def periodic(box_lengths, periodic_axes=(True, True, True), dtype=None,
             device=None) -> Metric:
    """Orthorhombic (or per-axis partial) periodic box."""
    box = torch.as_tensor(box_lengths, dtype=dtype, device=device)
    cell = torch.diag_embed(box)
    inv = torch.diag_embed(1.0 / box)
    return Metric(cell=cell, inv_cell=inv,
                  periodic=torch.as_tensor(periodic_axes, dtype=torch.bool,
                                           device=device),
                  diagonal=True)


def triclinic(cell, periodic_axes=(True, True, True), device=None) -> Metric:
    """General triclinic cell (box vectors as columns of `cell`)."""
    cell = torch.as_tensor(cell, device=device)
    return Metric(cell=cell, inv_cell=torch.linalg.inv(cell),
                  periodic=torch.as_tensor(periodic_axes, dtype=torch.bool,
                                           device=device),
                  diagonal=False)
