"""Simulation state and impulse containers (counterpart of
``esp32_fluid_simulation_tpu/state.py``).

Layout is channels-first (``[C, H, W]``), as in the JAX package, so the
tests compare like with like.  Every constructor takes the ``device`` the
tensors live on, the card (``"cuda"``) unless the caller names another;
nothing here reads a global default device.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .config import SimConfig


class SimState(NamedTuple):
    """Persistent per-frame state.

    velocity: ``[ndim, *shape]`` — channel 0 along axis 0, channel 1 along
              axis 1.
    color:    ``[3, *shape]`` dye RGB in [0, 1].
    step:     frame counter (a Python int: it lives on the host).
    """

    velocity: torch.Tensor
    color: torch.Tensor
    step: int


class Impulses(NamedTuple):
    """A fixed-length batch of velocity impulses (the drag queue).

    ``pos`` indices are in sim frame (axis-0 index, axis-1 index); inactive
    slots are masked by ``active``.
    """

    pos: torch.Tensor       # int32 [K, ndim] cell indices
    velocity: torch.Tensor  # [K, ndim] velocity to write (cells/s)
    active: torch.Tensor    # bool  [K]

    @classmethod
    def none(cls, cfg: SimConfig, device="cuda") -> "Impulses":
        k, nd = cfg.max_impulses, cfg.ndim
        return cls(
            pos=torch.zeros((k, nd), dtype=torch.int32, device=device),
            velocity=torch.zeros((k, nd), dtype=cfg.torch_dtype,
                                 device=device),
            active=torch.zeros((k,), dtype=torch.bool, device=device),
        )

    @classmethod
    def from_lists(cls, cfg: SimConfig, pos, vel, device="cuda") -> "Impulses":
        """Build a padded batch from Python lists of (pos, velocity) tuples.

        Padding happens host-side in numpy; the batch then crosses to
        ``device`` as three small copies."""
        k, nd = cfg.max_impulses, cfg.ndim
        n = min(len(pos), k)
        p = np.zeros((k, nd), np.int32)
        v = np.zeros((k, nd), np.float32)   # cast to cfg.torch_dtype below
        a = np.zeros((k,), np.bool_)
        if n:
            p[:n] = np.asarray(pos[:n], np.int32)
            v[:n] = np.asarray(vel[:n])
            a[:n] = True
        return cls(pos=torch.from_numpy(p).to(device),
                   velocity=torch.from_numpy(v).to(device=device,
                                                    dtype=cfg.torch_dtype),
                   active=torch.from_numpy(a).to(device))
