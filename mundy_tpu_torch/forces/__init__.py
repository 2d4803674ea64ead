"""Force evaluation: pairwise contact potentials and spring networks.

Port of mundy_tpu/forces: pair forces as one-sided per-particle sums over
the neighbor matrix, springs as scatter-adds in index order.
"""

from mundy_tpu_torch.forces.contact import (
    hertzian_pair_force,
    wca_pair_force,
    contact_forces,
    hertzian_contact_forces,
    wca_contact_forces,
)
from mundy_tpu_torch.forces.springs import (
    hookean_spring_forces,
    fene_spring_forces,
    fenewca_chain_forces,
    fenewca_spring_forces,
    angular_spring_forces,
)

__all__ = [
    "hertzian_pair_force",
    "wca_pair_force",
    "contact_forces",
    "hertzian_contact_forces",
    "wca_contact_forces",
    "hookean_spring_forces",
    "fene_spring_forces",
    "fenewca_chain_forces",
    "fenewca_spring_forces",
    "angular_spring_forces",
]
