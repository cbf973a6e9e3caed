from .unconstrained import (
    beale,
    booth,
    extended_rosenbrock,
    himmelblau,
    matyas,
    pairwise_rosenbrock,
    powell_badly_scaled,
    powell_singular,
    quickstart_quadratic,
    rosenbrock,
    sphere,
    trigonometric,
)

__all__ = [
    "beale",
    "booth",
    "extended_rosenbrock",
    "himmelblau",
    "matyas",
    "pairwise_rosenbrock",
    "powell_badly_scaled",
    "powell_singular",
    "quickstart_quadratic",
    "rosenbrock",
    "sphere",
    "trigonometric",
]
