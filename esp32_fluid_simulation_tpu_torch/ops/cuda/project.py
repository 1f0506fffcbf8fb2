"""K1: pressure projection with the drag-queue drain on the GPU
(``csrc/project.cu``).

Replaces ``esp32_fluid_simulation_tpu/ops/pallas/project.py:
project_fused_pallas``.  ``project_fused`` launches the CUDA kernels for
CUDA tensors and runs ``project_fused_reference``, its plain PyTorch version
(``apply_impulses -> divergence -> sor_solve -> subtract_gradient``), for
CPU tensors — only because they lie on the CPU.  Any other device raises.
"""

from __future__ import annotations

import numpy as np
import torch

from ..fd import divergence, subtract_gradient
from ..poisson import sor_solve
from .build import load, stream_of

_MAX_IMPULSES = 64  # kMaxImpulses in csrc/project.cu


def project_fused_reference(vel, dx=1.0, iters=10, omega=1.96,
                            impulses=None):
    """Plain PyTorch version: the composed ops of the port."""
    if impulses is not None:
        from ...models.stable_fluids import apply_impulses
        vel = apply_impulses(vel, impulses)
    p = sor_solve(divergence(vel, dx), dx, iters, omega)
    return subtract_gradient(vel, p, dx), p


def project_fused(vel: torch.Tensor, dx: float = 1.0, iters: int = 10,
                  omega: float = 1.96, impulses=None):
    """(projected velocity, pressure) for a 2D ``[2, H, W]`` float32
    velocity: optional impulse drain (clamped positions, the last active
    slot wins, values rounded through ``vel.dtype``), divergence,
    ``iters`` RB-SOR sweeps from zero, gradient subtract."""
    if vel.device.type == "cpu":
        return project_fused_reference(vel, dx, iters, omega, impulses)
    if not vel.is_cuda:
        raise ValueError(f"project_fused: unsupported device {vel.device}")
    if vel.dim() != 3 or vel.shape[0] != 2 or vel.dtype != torch.float32:
        raise ValueError("project_fused: vel must be float32 [2, H, W]")
    if not vel.is_contiguous():
        raise ValueError("project_fused: vel must be contiguous")
    _, h, w = vel.shape
    # the launches put rows on grid.y, 8 a block, at most 65535 blocks
    if h < 2 or w < 2 or h > 8 * 65535 or iters < 0:
        raise ValueError("project_fused: needs 2 <= H <= 524280, W >= 2 and "
                         "iters >= 0")

    if impulses is None:
        n_imp, ipos, ivel, iact = 0, None, None, None
    else:
        n_imp = impulses.pos.shape[0]
        if n_imp > _MAX_IMPULSES or impulses.pos.shape != (n_imp, 2):
            raise ValueError(f"project_fused: impulses must be [K, 2] with "
                             f"K <= {_MAX_IMPULSES}")
        for t in impulses:
            if t.device != vel.device:
                raise ValueError("project_fused: impulses and vel on "
                                 "different devices")
        ipos = impulses.pos.to(torch.int32).contiguous()
        # round the written values through vel.dtype, as the scatter does
        ivel = impulses.velocity.to(vel.dtype).to(torch.float32).contiguous()
        iact = impulses.active.to(torch.bool).contiguous()

    out = torch.empty_like(vel)
    p = torch.empty((h, w), dtype=torch.float32, device=vel.device)
    dxd = torch.empty_like(p)
    lib = load()
    with torch.cuda.device(vel.device):
        lib.call("fluid_project", vel.data_ptr(), out.data_ptr(),
                 p.data_ptr(), dxd.data_ptr(),
                 None if ipos is None else ipos.data_ptr(),
                 None if ivel is None else ivel.data_ptr(),
                 None if iact is None else iact.data_ptr(),
                 n_imp, h, w, float(dx), float(np.float32(1.0 / (2.0 * dx))),
                 int(iters), float(omega), float(np.float32(1.0 - omega)),
                 stream_of(vel))
    project_fused.launches += 1
    return out, p


project_fused.launches = 0
