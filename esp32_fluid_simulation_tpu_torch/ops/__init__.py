from .advect import advect, sample_linear
from .fd import divergence, subtract_gradient
from .poisson import poisson_solve, sor_solve, poisson_residual, neighbor_count
from .blur import triangular_blur_inplace

__all__ = [
    "advect",
    "sample_linear",
    "divergence",
    "subtract_gradient",
    "poisson_solve",
    "sor_solve",
    "poisson_residual",
    "neighbor_count",
    "triangular_blur_inplace",
]
