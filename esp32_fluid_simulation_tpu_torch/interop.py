"""Carry state between the JAX package and this one through numpy.

The JAX package's arrays, once converted with ``numpy.asarray``, become this
package's tensors and back.  bfloat16 crosses as its raw 16-bit pattern:
a numpy ``bfloat16`` array (the ``ml_dtypes`` type JAX hands out) is viewed
as ``uint16`` and reinterpreted as ``torch.bfloat16``, so nothing is rounded
at the boundary and this module needs no ``ml_dtypes``.  On the way back a
bfloat16 tensor comes out as its ``uint16`` bits; ``bits.view(jnp.bfloat16)``
restores the JAX dtype.
"""

from __future__ import annotations

import numpy as np
import torch

from .models.smoke3d import SmokeState
from .state import Impulses, SimState


def tensor_from_numpy(arr, device="cuda") -> torch.Tensor:
    """numpy array (bfloat16 included) -> tensor on ``device``, bit for bit."""
    arr = np.array(arr, copy=True, order="C")  # writable, owned by torch
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


def tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    """tensor -> numpy array; bfloat16 comes back as its ``uint16`` bits."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.uint16).numpy().copy()
    return t.numpy().copy()


def state_from_numpy(velocity, color, step=0, device="cuda") -> SimState:
    """The JAX package's ``SimState`` fields (as numpy) -> ``SimState``."""
    return SimState(velocity=tensor_from_numpy(velocity, device),
                    color=tensor_from_numpy(color, device),
                    step=int(np.asarray(step)))


def impulses_from_numpy(pos, velocity, active, device="cuda") -> Impulses:
    """The JAX package's ``Impulses`` fields (as numpy) -> ``Impulses``; a
    batched ensemble's ``[n, K, nd]`` fields (``stack_impulses``) cross the
    same way."""
    return Impulses(pos=tensor_from_numpy(pos, device),
                    velocity=tensor_from_numpy(velocity, device),
                    active=tensor_from_numpy(active, device))


def state_to_numpy(state: SimState):
    """``SimState`` -> ``(velocity, color, step)`` numpy arrays."""
    return (tensor_to_numpy(state.velocity), tensor_to_numpy(state.color),
            np.int32(state.step))


def ensemble_state_from_numpy(velocity, color, step=0,
                              device="cuda") -> SimState:
    """The JAX package's ensemble state (``[n, ...]`` fields and an ``[n]``
    step array) -> a member-stack ``SimState``.  The port steps all members
    together, so ``step`` is one Python int; members at different steps
    raise."""
    steps = np.unique(np.asarray(step))
    if steps.size != 1:
        raise ValueError(f"ensemble members at different steps: {steps}")
    return SimState(velocity=tensor_from_numpy(velocity, device),
                    color=tensor_from_numpy(color, device),
                    step=int(steps[0]))


def ensemble_state_to_numpy(state: SimState):
    """Member-stack ``SimState`` -> ``(velocity, color, step)`` numpy
    arrays, ``step`` as the JAX package's ``[n]`` int32 array."""
    n = state.velocity.shape[0]
    return (tensor_to_numpy(state.velocity), tensor_to_numpy(state.color),
            np.full((n,), state.step, np.int32))


def smoke_state_from_numpy(velocity, density, temperature, step=0,
                           device="cuda") -> SmokeState:
    """The JAX package's ``SmokeState`` fields (as numpy) -> ``SmokeState``;
    the plume has no learned parameters, so this is all it carries."""
    return SmokeState(velocity=tensor_from_numpy(velocity, device),
                      density=tensor_from_numpy(density, device),
                      temperature=tensor_from_numpy(temperature, device),
                      step=int(np.asarray(step)))


def smoke_state_to_numpy(state: SmokeState):
    """``SmokeState`` -> ``(velocity, density, temperature, step)`` numpy
    arrays, bfloat16 as its ``uint16`` bits."""
    return (tensor_to_numpy(state.velocity), tensor_to_numpy(state.density),
            tensor_to_numpy(state.temperature), np.int32(state.step))
