from .synthetic import (
    anisotropic,
    cassini,
    dataset_by_name,
    gaussians,
    shapes,
    shuffle_points,
    smiley,
    three_circles,
    two_moons,
)
from .tokens import SyntheticTokenStream

__all__ = [
    "SyntheticTokenStream",
    "two_moons",
    "three_circles",
    "anisotropic",
    "cassini",
    "gaussians",
    "shapes",
    "smiley",
    "dataset_by_name",
    "shuffle_points",
]
