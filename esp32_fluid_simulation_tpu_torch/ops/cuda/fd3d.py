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
from .build import load, stream_of


def divergence3d_reference(vel, dx=1.0):
    """Plain PyTorch version: ``ops.fd.divergence`` in 3D."""
    return divergence(vel, dx)


def subtract_gradient3d_reference(vel, p, dx=1.0):
    """Plain PyTorch version: ``ops.fd.subtract_gradient`` in 3D."""
    return subtract_gradient(vel, p, dx)


def _check_vel(name, vel):
    if vel.dim() != 4 or vel.shape[0] != 3 or vel.dtype != torch.float32:
        raise ValueError(f"{name}: vel must be float32 [3, D, H, W]")
    if not vel.is_contiguous():
        raise ValueError(f"{name}: vel must be contiguous")
    _, d, h, w = vel.shape
    # the launch puts planes on grid.z and rows on grid.y, 8 a block
    if min(d, h, w) < 2 or d > 65535 or h > 8 * 65535:
        raise ValueError(f"{name}: shape {tuple(vel.shape)} not supported "
                         "(2 <= D <= 65535, 2 <= H <= 524280, W >= 2)")
    return d, h, w


def _inv2dx(dx) -> float:
    return float(np.float32(1.0 / (2.0 * dx)))


def divergence3d(vel: torch.Tensor, dx: float = 1.0) -> torch.Tensor:
    """Reflected-ghost divergence of a ``[3, D, H, W]`` float32 velocity:
    ``[D, H, W]``."""
    with span("fluid.k8.fd3d"):
        if vel.device.type == "cpu":
            return divergence3d_reference(vel, dx)
        if not vel.is_cuda:
            raise ValueError(f"divergence3d: unsupported device {vel.device}")
        d, h, w = _check_vel("divergence3d", vel)
        out = torch.empty((d, h, w), dtype=torch.float32, device=vel.device)
        lib = load()
        with torch.cuda.device(vel.device):
            lib.call("fluid_divergence3d", vel.data_ptr(), out.data_ptr(), d,
                     h, w, _inv2dx(dx), stream_of(vel))
        divergence3d.launches += 1
        return out


def subtract_gradient3d(vel: torch.Tensor, p: torch.Tensor,
                        dx: float = 1.0) -> torch.Tensor:
    """``vel - grad(p)`` with Neumann walls, into a fresh tensor."""
    with span("fluid.k8.fd3d"):
        if vel.device.type == "cpu":
            return subtract_gradient3d_reference(vel, p, dx)
        if not vel.is_cuda:
            raise ValueError(f"subtract_gradient3d: unsupported device "
                             f"{vel.device}")
        d, h, w = _check_vel("subtract_gradient3d", vel)
        if p.shape != (d, h, w) or p.dtype != torch.float32:
            raise ValueError("subtract_gradient3d: p must be float32 "
                             "[D, H, W]")
        if p.device != vel.device or not p.is_contiguous():
            raise ValueError("subtract_gradient3d: p must be contiguous, on "
                             "vel's device")
        out = torch.empty_like(vel)
        lib = load()
        with torch.cuda.device(vel.device):
            lib.call("fluid_subtract_gradient3d", vel.data_ptr(), p.data_ptr(),
                     out.data_ptr(), d, h, w, _inv2dx(dx), stream_of(vel))
        subtract_gradient3d.launches += 1
        return out


divergence3d.launches = 0
subtract_gradient3d.launches = 0
