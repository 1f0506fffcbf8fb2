"""K8: 3D divergence and gradient subtract on the GPU (``csrc/fd3d.cu``).

Replaces ``esp32_fluid_simulation_tpu/ops/pallas/fd3d.py``
(``divergence3d_pallas``, ``subtract_gradient3d_pallas``).  Each wrapper
launches its CUDA kernel for CUDA tensors and runs its plain PyTorch
version (``*_reference``: the port's rank-polymorphic ``ops.fd`` ops, the
same arithmetic in the same order) for CPU tensors — only because they lie
on the CPU.  Any other device raises.
"""

from __future__ import annotations

import numpy as np
import torch

from ..fd import divergence, subtract_gradient
from ...spans import span
from .build import launch
from .modes import F32, check_launch


def divergence3d_reference(vel, dx=1.0):
    """Plain PyTorch version: ``ops.fd.divergence`` in 3D."""
    return divergence(vel, dx)


def subtract_gradient3d_reference(vel, p, dx=1.0):
    """Plain PyTorch version: ``ops.fd.subtract_gradient`` in 3D."""
    return subtract_gradient(vel, p, dx)


def _checked(name, vel, p=None):
    """Validate a CUDA launch's inputs; ``(D, H, W)``."""
    if vel.dim() != 4 or vel.shape[0] != 3:
        raise ValueError(f"{name}: vel must be float32 [3, D, H, W]")
    _, d, h, w = vel.shape
    # the launch puts planes on grid.z and rows on grid.y, 8 a block
    if min(d, h, w) < 2 or d > 65535 or h > 8 * 65535:
        raise ValueError(f"{name}: shape {tuple(vel.shape)} not supported "
                         "(2 <= D <= 65535, 2 <= H <= 524280, W >= 2)")
    if p is not None and p.shape != (d, h, w):
        raise ValueError(f"{name}: p must be float32 [D, H, W]")
    check_launch(name, vel=(vel, F32), p=(p, F32))
    return d, h, w


def _inv2dx(dx) -> float:
    return float(np.float32(1.0 / (2.0 * dx)))


def divergence3d(vel: torch.Tensor, dx: float = 1.0) -> torch.Tensor:
    """Reflected-ghost divergence of a ``[3, D, H, W]`` float32 velocity:
    ``[D, H, W]``."""
    with span("fluid.k8.fd3d"):
        if vel.device.type == "cpu":
            return divergence3d_reference(vel, dx)
        d, h, w = _checked("divergence3d", vel)
        out = torch.empty((d, h, w), dtype=torch.float32, device=vel.device)
        launch("fluid_divergence3d", vel, vel, out, d, h, w, _inv2dx(dx))
        divergence3d.launches += 1
        return out


def subtract_gradient3d(vel: torch.Tensor, p: torch.Tensor,
                        dx: float = 1.0) -> torch.Tensor:
    """``vel - grad(p)`` with Neumann walls, into a fresh tensor."""
    with span("fluid.k8.fd3d"):
        if vel.device.type == "cpu":
            return subtract_gradient3d_reference(vel, p, dx)
        d, h, w = _checked("subtract_gradient3d", vel, p)
        out = torch.empty_like(vel)
        launch("fluid_subtract_gradient3d", vel, vel, p, out, d, h, w,
               _inv2dx(dx))
        subtract_gradient3d.launches += 1
        return out


divergence3d.launches = 0
subtract_gradient3d.launches = 0
