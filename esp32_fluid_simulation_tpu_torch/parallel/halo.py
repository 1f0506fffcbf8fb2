"""Halo exchange over a single-process device mesh with
boundary-condition-aware edges (counterpart of
``esp32_fluid_simulation_tpu/parallel/halo.py``).

A sharded field is a grid of per-shard blocks, ``blocks[x][y]``, each on
its mesh device.  ``exchange_halo`` extends every block by ``width`` ghost
cells on both sides of one array axis with the neighbour blocks' edge
strips along one mesh axis — the counterpart of ``jax.lax.ppermute`` under
``shard_map`` — and fills the two *global* edges according to the
physical boundary condition:

* ``zero``        — zero ghosts (SOR neighbour sums, advect windows);
* ``edge``        — clamp to the edge value (Neumann pressure gradient,
                    ``finitediff.cpp:51-54``);
* ``reflect_neg`` — negated mirror (no-penetration ghost velocity,
                    ``finitediff.cpp:17-20``).

A strip that crosses devices is copied with ``.to(device)``; each block's
ghosts are assembled with its device current, so on a CUDA mesh the copies
order themselves on that device's current stream.  With a device repeated
in the mesh the exchange is a device-local copy.
"""

from __future__ import annotations

import contextlib

import torch

from .topology import X_AXIS, Y_AXIS

BCS = ("zero", "edge", "reflect_neg")


def on_device(device):
    """A context that makes a CUDA ``device`` current; nothing for the
    CPU."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def _take(x, dim, start, size):
    return x.narrow(dim, start if start >= 0 else x.shape[dim] + start, size)


def _fill(x, width, dim, side, bc):
    """The ghost strip beyond the global edge on ``side`` ("lo"/"hi")."""
    if bc == "zero":
        return torch.zeros_like(_take(x, dim, 0, width))
    if bc == "edge":
        edge = _take(x, dim, 0 if side == "lo" else -1, 1)
        return torch.cat([edge] * width, dim=dim)
    strip = _take(x, dim, 0 if side == "lo" else -width, width)
    return -torch.flip(strip, dims=(dim,))


def exchange_halo(blocks, width: int, dim: int, axis: str, bc: str = "zero"):
    """Return the grid ``blocks`` (``[x][y]`` lists of tensors) with each
    block extended by ``width`` ghost cells on both sides of array axis
    ``dim``, exchanged along mesh axis ``axis`` (``"x"``: the grid's first
    index, ``"y"``: its second).  On a 1-shard axis the ghosts are the pure
    boundary-condition fill."""
    if axis not in (X_AXIS, Y_AXIS):
        raise ValueError(f"unknown mesh axis {axis!r}")
    if bc not in BCS:
        raise ValueError(f"unknown bc {bc!r}")
    if width == 0:
        return blocks
    nx, ny = len(blocks), len(blocks[0])
    for row in blocks:
        for x in row:
            d = dim % x.dim()
            if width > x.shape[d]:
                raise ValueError(
                    f"halo width {width} exceeds the shard extent "
                    f"{x.shape[d]} along dim {d} — use a smaller "
                    f"max_disp/sor_halo or fewer shards on this axis "
                    f"(strips would silently truncate)")
    step = (1, 0) if axis == X_AXIS else (0, 1)
    out = [[None] * ny for _ in range(nx)]
    for a in range(nx):
        for b in range(ny):
            x = blocks[a][b]
            d = dim % x.dim()
            k, n = (a, nx) if axis == X_AXIS else (b, ny)
            with on_device(x.device):
                if k > 0:
                    prev = blocks[a - step[0]][b - step[1]]
                    lo = _take(prev, d, -width, width).to(x.device)
                else:
                    lo = _fill(x, width, d, "lo", bc)
                if k < n - 1:
                    nxt = blocks[a + step[0]][b + step[1]]
                    hi = _take(nxt, d, 0, width).to(x.device)
                else:
                    hi = _fill(x, width, d, "hi", bc)
                out[a][b] = torch.cat([lo, x, hi], dim=d)
    return out
