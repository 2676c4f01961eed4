from .geometry import Obstacles, gamma, modulation_bases, obstacle_weights
from .directional import directional_weighted_sum, orthogonal_basis
from .modulation import (
    modulation_matrix_spherical,
    modulation_matrix_elliptic,
    modulate_multiple,
    avoid,
    rollout,
)

__all__ = [
    "Obstacles",
    "gamma",
    "modulation_bases",
    "obstacle_weights",
    "directional_weighted_sum",
    "orthogonal_basis",
    "modulation_matrix_spherical",
    "modulation_matrix_elliptic",
    "modulate_multiple",
    "avoid",
    "rollout",
]
