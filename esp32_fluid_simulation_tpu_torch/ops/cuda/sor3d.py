"""K9: the 3D red-black SOR pressure solve on the GPU (``csrc/sor3d.cu``).

Replaces ``esp32_fluid_simulation_tpu/ops/pallas/sor3d.py:
sor3d_packed_pallas`` (single device; its block mode, ``_sor3d_chunk``,
is K11).  ``sor3d_solve`` launches the CUDA kernels for CUDA tensors and
runs ``sor3d_reference``, its plain PyTorch version (``ops.poisson.
sor_solve``: zero init, even parity first, the same neighbour order and
``-1/a_ii`` LUT), for CPU tensors — only because they lie on the CPU.  Any
other device raises.

``chunk`` (sweeps per TPU launch) does not change the result there, and
the CUDA kernel has no counterpart of it: it runs one launch per
half-sweep.  It is validated as the JAX contract validates it.
"""

from __future__ import annotations

import numpy as np
import torch

from ..poisson import sor_solve
from .build import load, stream_of

_LANE = 128  # the TPU kernel's fixed column halo, which bounds ``chunk``


def sor3d_reference(d, dx=1.0, iters=10, omega=1.5):
    """Plain PyTorch version: ``ops.poisson.sor_solve`` in 3D."""
    return sor_solve(d, dx, iters, omega)


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
