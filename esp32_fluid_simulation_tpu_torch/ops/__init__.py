from .advect import advect, sample_linear, advect_maccormack
from .fd import (
    divergence,
    subtract_gradient,
    curl2d,
    vorticity_confinement,
)
from .poisson import (
    poisson_solve,
    sor_solve,
    jacobi_solve,
    poisson_residual,
    neighbor_count,
)
from .blur import triangular_blur_inplace

__all__ = [
    "advect",
    "advect_maccormack",
    "sample_linear",
    "divergence",
    "subtract_gradient",
    "curl2d",
    "vorticity_confinement",
    "poisson_solve",
    "sor_solve",
    "jacobi_solve",
    "poisson_residual",
    "neighbor_count",
    "triangular_blur_inplace",
]
