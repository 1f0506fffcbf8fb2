"""Device-mesh topology (counterpart of
``esp32_fluid_simulation_tpu/parallel/topology.py``).

JAX's ``shard_map`` is single-controller: one process owns every device of
its mesh.  The port keeps those semantics with a single-process mesh: a
``(batch, x, y)`` array of ``torch.device``s, in which the same device may
repeat.  Axis convention as in the JAX package: ``batch`` for ensembles
(data parallel), ``x``/``y`` partition the trailing two spatial axes of
every field (spatial parallel).  Any axis may have size 1.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch

BATCH_AXIS = "batch"
X_AXIS = "x"
Y_AXIS = "y"


def grid_axes():
    return (X_AXIS, Y_AXIS)


class Mesh:
    """A ``[batch, x, y]`` array of ``torch.device``s; ``shape`` maps each
    axis name to its size, as ``jax.sharding.Mesh.shape`` does."""

    axis_names = (BATCH_AXIS, X_AXIS, Y_AXIS)

    def __init__(self, devices: np.ndarray):
        if devices.ndim != 3:
            raise ValueError("a mesh is a [batch, x, y] array of devices")
        self.devices = devices

    @property
    def shape(self):
        return dict(zip(self.axis_names, self.devices.shape))

    def __repr__(self):
        return f"Mesh({self.shape}, {sorted(set(map(str, self.devices.flat)))})"


def make_mesh(devices: Optional[Sequence] = None, batch: int = 1,
              grid_shape: Optional[tuple] = None) -> Mesh:
    """Build a ``(batch, x, y)`` mesh over ``devices`` (``torch.device``s or
    their names; one may repeat).  ``None`` means every visible CUDA device
    and raises where there is none.

    If ``grid_shape`` is None, the non-batch devices are factored as close
    to square as possible (halo surface scales with perimeter).
    """
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device; pass devices= "
                               "(e.g. ['cpu'] * 8) to build a mesh without "
                               "one")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    n = len(devices)
    if n % batch:
        raise ValueError(f"{n} devices not divisible by batch={batch}")
    spatial = n // batch
    if grid_shape is None:
        gx = int(math.sqrt(spatial))
        while spatial % gx:
            gx -= 1
        grid_shape = (gx, spatial // gx)
    gx, gy = grid_shape
    if batch * gx * gy != n:
        raise ValueError(f"batch*gx*gy={batch*gx*gy} != n_devices={n}")
    arr = np.empty(n, dtype=object)
    arr[:] = devices
    return Mesh(arr.reshape(batch, gx, gy))
