"""Separable in-place triangular blur used by the initial condition
(counterpart of ``esp32_fluid_simulation_tpu/ops/blur.py``).

The reference softens the RGB sector edges with two sequential in-place
[1/4, 1/2, 1/4] passes (``.ino:220-241``).  Each cell's "previous" neighbour
is the already-blurred value — a first-order linear recurrence:

    out[0]   = 0.25*c[0]   + 0.5*c[0]   + 0.25*c[1]      (left ghost = center)
    out[j]   = 0.25*out[j-1] + 0.5*c[j] + 0.25*c[j+1]
    out[n-1] = 0.25*out[n-2] + 0.5*c[n-1] + 0.25*c[n-1]  (right ghost = center)

A Python loop along the blur axis runs the recurrence: it is init-only.
Arithmetic stays in the tensor's dtype, like the JAX scan.
"""

from __future__ import annotations

import torch


def triangular_blur_inplace(x: torch.Tensor, axis: int) -> torch.Tensor:
    """Apply the reference's sequential in-place [1/4,1/2,1/4] blur along
    ``axis`` (``.ino:220-241``); returns a new tensor."""
    c = torch.movedim(x, axis, 0)
    right = torch.cat([c[1:], c[-1:]], dim=0)  # c[j+1]; ghost = center
    g = 0.5 * c + 0.25 * right
    out = torch.empty_like(c)
    prev = c[0]  # the j=0 "left" ghost is the (old) center value
    for j in range(c.shape[0]):
        prev = 0.25 * prev + g[j]
        out[j] = prev
    return torch.movedim(out, 0, axis)
