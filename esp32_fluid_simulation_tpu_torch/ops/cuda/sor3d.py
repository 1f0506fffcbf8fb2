"""K9: the 3D red-black SOR pressure solve on the GPU (``csrc/sor3d.cu``).

Replaces ``esp32_fluid_simulation_tpu/ops/pallas/sor3d.py:
sor3d_packed_pallas`` (single device) and its block mode ``_sor3d_chunk``
(K11).  ``sor3d_solve`` and ``sor3d_chunk`` launch the CUDA kernels for
CUDA tensors and run their plain PyTorch versions, ``sor3d_reference``
(``ops.poisson.sor_solve``: zero init, even parity first, the same
neighbour order and ``-1/a_ii`` LUT) and ``sor3d_chunk_reference``, for
CPU tensors — only because they lie on the CPU.  Any other device raises.

``chunk`` (sweeps per TPU launch) does not change the result there, and
the CUDA kernel has no counterpart of it: it runs one launch per
half-sweep.  It is validated as the JAX contract validates it.

``sor3d_chunk`` is one chunk of the sharded steps' solve
(``parallel/sharded3d.py``): ``sweeps`` sweeps on a whole haloed block
from the ``p`` it is given, with the walls, ``a_ii``, the parity ``(gz +
gi + gj) & 1`` and the domain of ``global_shape``; ``global_offset`` is
the **haloed** array's global origin ``(oz, oi, oj)``.  Cells outside the
domain hold 0 and neighbours there or beyond the array read 0.  The
outer ``2*sweeps`` rings of the result are not the whole grid's (in the
TPU kernel they also depend on its padding); the cells inside them are.
The TPU kernel's ``chunk <= 64`` lane limit and its tile sizes have no
counterpart here.  ``sor3d_chunk.launches`` counts its calls.
"""

from __future__ import annotations

import numpy as np
import torch

from ..poisson import _shift_zero, neg_inv_of, sor_solve
from .build import load, stream_of
from .modes import chunk_geometry

_LANE = 128  # the TPU kernel's fixed column halo, which bounds ``chunk``


def sor3d_reference(d, dx=1.0, iters=10, omega=1.5):
    """Plain PyTorch version: ``ops.poisson.sor_solve`` in 3D."""
    return sor_solve(d, dx, iters, omega)


def walls3(g, shape):
    """``((z_lo, z_hi), (i_lo, i_hi), (j_lo, j_hi))`` masks of the cells at
    global indices ``g`` (three broadcasting index tensors) on each wall of
    the domain ``shape``."""
    return [(x == 0, x == n - 1) for x, n in zip(g, shape)]


def aii3(g, shape):
    """The Neumann diagonal (in-domain neighbour count, int64) at ``g``."""
    return 6 - sum(lo.long() + hi.long() for lo, hi in walls3(g, shape))


def sor3d_chunk_reference(d, p, dx, sweeps, omega, origin, domain):
    """Plain PyTorch version of ``sor3d_chunk`` (``ops.poisson.sor_sweep``'s
    arithmetic with the domain's walls, parity and mask)."""
    dev = d.device
    g = [torch.arange(n, device=dev).view([-1 if a == k else 1
                                           for a in range(3)]) + o
         for k, (n, o) in enumerate(zip(d.shape, origin))]
    in_dom = ((g[0] >= 0) & (g[0] < domain[0]) & (g[1] >= 0)
              & (g[1] < domain[1]) & (g[2] >= 0) & (g[2] < domain[2]))
    walls = walls3(g, domain)
    neg_inv = neg_inv_of(aii3(g, domain), d.dtype)
    parity = (g[0] + g[1] + g[2]) & 1
    p = torch.where(in_dom, p, 0.0)
    for _ in range(sweeps):
        for color in (0, 1):
            nb = None
            for axis, (lo, hi) in enumerate(walls):
                for wall, direction in ((lo, -1), (hi, 1)):
                    x = torch.where(wall, 0.0, _shift_zero(p, axis,
                                                           direction))
                    nb = x if nb is None else nb + x
            p_new = (1.0 - omega) * p + omega * (neg_inv * (dx * d - nb))
            p = torch.where((parity == color) & in_dom, p_new, p)
    return p


def sor3d_chunk(d: torch.Tensor, p: torch.Tensor, dx: float, sweeps: int,
                omega: float, global_offset=None,
                global_shape=None) -> torch.Tensor:
    """``sweeps`` red-black SOR sweeps of ``lap(p) = d`` on a ``[D, H, W]``
    float32 block from ``p``, as a fresh tensor (module docstring)."""
    if d.dim() != 3 or tuple(p.shape) != tuple(d.shape):
        raise ValueError("sor3d_chunk: d and p must be [D, H, W] of one "
                         "shape")
    origin, domain = chunk_geometry("sor3d_chunk", global_offset,
                                    global_shape, d.shape)
    if sweeps < 0:
        raise ValueError(f"sor3d_chunk: sweeps={sweeps} must be >= 0")
    if d.device.type == "cpu":
        return sor3d_chunk_reference(d, p, dx, sweeps, omega, origin, domain)
    if not d.is_cuda:
        raise ValueError(f"sor3d_chunk: unsupported device {d.device}")
    if d.dtype != torch.float32 or p.dtype != torch.float32:
        raise ValueError("sor3d_chunk: d and p must be float32")
    if p.device != d.device:
        raise ValueError("sor3d_chunk: d and p on different devices")
    if not (d.is_contiguous() and p.is_contiguous()):
        raise ValueError("sor3d_chunk: inputs must be contiguous")
    dd, h, w = d.shape
    # the launch puts planes on grid.z and rows on grid.y, 8 a block
    if min(dd, h, w) < 2 or dd > 65535 or h > 8 * 65535:
        raise ValueError(f"sor3d_chunk: shape {tuple(d.shape)} not "
                         "supported (2 <= D <= 65535, 2 <= H <= 524280, "
                         "W >= 2)")
    out = torch.empty_like(d)
    lib = load()
    with torch.cuda.device(d.device):
        lib.call("fluid_sor3d_chunk", d.data_ptr(), p.data_ptr(),
                 out.data_ptr(), dd, h, w, *origin, *domain, float(dx),
                 int(sweeps), float(omega), float(np.float32(1.0 - omega)),
                 stream_of(d))
    sor3d_chunk.launches += 1
    return out


sor3d_chunk.launches = 0


def sor3d_solve(d: torch.Tensor, dx: float = 1.0, iters: int = 10,
                omega: float = 1.5, chunk: int = 3) -> torch.Tensor:
    """Pressure ``p`` with ``lap(p) = d`` after ``iters`` red-black SOR
    sweeps from zero, for a ``[D, H, W]`` float32 ``d``."""
    if chunk < 1:
        raise ValueError(f"chunk={chunk} must be >= 1")
    need = 2 * min(chunk, iters)
    if need > _LANE:
        raise ValueError(
            f"chunk={chunk} needs a {need}-lane column halo > the fixed "
            f"{_LANE}-lane panel; use chunk <= {_LANE // 2}")
    if d.device.type == "cpu":
        return sor3d_reference(d, dx, iters, omega)
    if not d.is_cuda:
        raise ValueError(f"sor3d_solve: unsupported device {d.device}")
    if d.dim() != 3 or d.dtype != torch.float32:
        raise ValueError("sor3d_solve: d must be float32 [D, H, W]")
    if not d.is_contiguous():
        raise ValueError("sor3d_solve: d must be contiguous")
    dd, h, w = d.shape
    # the launch puts planes on grid.z and rows on grid.y, 8 a block
    if min(dd, h, w) < 2 or dd > 65535 or h > 8 * 65535 or iters < 0:
        raise ValueError(f"sor3d_solve: shape {tuple(d.shape)} / iters "
                         f"{iters} not supported (2 <= D <= 65535, "
                         "2 <= H <= 524280, W >= 2, iters >= 0)")
    p = torch.empty_like(d)
    lib = load()
    with torch.cuda.device(d.device):
        lib.call("fluid_sor3d", d.data_ptr(), p.data_ptr(), dd, h, w,
                 float(dx), int(iters), float(omega),
                 float(np.float32(1.0 - omega)), stream_of(d))
    sor3d_solve.launches += 1
    return p


sor3d_solve.launches = 0
