"""Device-mesh topology (counterpart of
``esp32_fluid_simulation_tpu/parallel/topology.py``).

A mesh is a ``(batch, x, y)`` array of ``torch.device``s, in which the
same device may repeat, with the rank of the process that owns each
position.  ``make_mesh`` builds a single-process mesh (every position this
process's, as JAX's ``shard_map`` is single-controller);
``make_process_mesh`` one that spans the processes of a
``torch.distributed`` group, each contributing its local devices in rank
order, as JAX's multi-controller ``jax.devices()`` lists them
(``parallel/dcn.py``).  Axis convention as in the JAX package: ``batch``
for ensembles (data parallel), ``x``/``y`` partition the trailing two
spatial axes of every field (spatial parallel).  Any axis may have size 1.
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
    axis name to its size, as ``jax.sharding.Mesh.shape`` does.

    ``ranks`` (same shape) holds the rank of the process that owns each
    position and ``rank`` this process's; the default, all 0 and 0, is a
    single-process mesh whatever this process's rank in a group."""

    axis_names = (BATCH_AXIS, X_AXIS, Y_AXIS)

    def __init__(self, devices: np.ndarray, ranks=None, rank: int = 0):
        if devices.ndim != 3:
            raise ValueError("a mesh is a [batch, x, y] array of devices")
        self.devices = devices
        self.ranks = (np.zeros(devices.shape, dtype=np.int64) if ranks is None
                      else np.asarray(ranks, dtype=np.int64))
        if self.ranks.shape != devices.shape:
            raise ValueError(f"ranks {self.ranks.shape} do not match the "
                             f"devices {devices.shape}")
        self.rank = rank

    @property
    def shape(self):
        return dict(zip(self.axis_names, self.devices.shape))

    def __repr__(self):
        owners = (f", ranks {self.ranks.ravel().tolist()}"
                  if (self.ranks != self.rank).any() else "")
        return (f"Mesh({self.shape}, "
                f"{sorted(set(map(str, self.devices.flat)))}{owners})")


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


def make_process_mesh(devices: Sequence, grid_shape: Optional[tuple] = None
                      ) -> Mesh:
    """A ``(1, x, y)`` mesh over the local ``devices`` of every process of
    the default ``torch.distributed`` group, gathered in rank order (the
    counterpart of the global mesh over JAX's process-ordered
    ``jax.devices()``, ``dcn.py:60-63``).  Every process calls it, each
    with its own devices; position ``p`` of the flattened mesh belongs to
    the process whose devices it lists.  ``grid_shape`` as in
    ``make_mesh``."""
    import torch.distributed as dist

    if not dist.is_initialized():
        raise RuntimeError("make_process_mesh: torch.distributed is not "
                           "initialized (init_process_group first)")
    local = [str(torch.device(d)) for d in devices]
    if not local:
        raise ValueError("make_process_mesh: this process lists no device")
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, local)
    flat = [d for per in every for d in per]
    owners = [r for r, per in enumerate(every) for _ in per]
    mesh = make_mesh(flat, batch=1, grid_shape=grid_shape)
    return Mesh(mesh.devices,
                ranks=np.asarray(owners).reshape(mesh.devices.shape),
                rank=dist.get_rank())
