"""K1: pressure projection with the drag-queue drain on the GPU
(``csrc/project.cu``).

Replaces ``esp32_fluid_simulation_tpu/ops/pallas/project.py:
project_fused_pallas``.  ``project_fused`` launches the CUDA kernels for
CUDA tensors and runs ``project_fused_reference``, its plain PyTorch version
(``apply_impulses -> divergence -> sor_solve -> subtract_gradient``), for
CPU tensors — only because they lie on the CPU.  Any other device raises.

``member=(mh, mw)`` (K6, ``project.py:121-134``): every member tile of the
grid is projected on its own — reflected ghosts, zero ghosts and ``a_ii``,
and the gradient's Neumann clamp at every member wall — with the whole
grid's red-black parity, as in the TPU kernel.  The plain version is the
same masked ops over the whole grid (not the composed ops per member, whose
parity would start at each member's origin).  It combines with
``impulses``; ``project_fused.member_launches`` counts its launches.
"""

from __future__ import annotations

import numpy as np
import torch

from ..fd import divergence, subtract_gradient
from ..poisson import _shift_zero, sor_solve
from .build import load, stream_of
from .modes import check_member, refuse_unported
from .sor import member_sor_solve, member_walls

_MAX_IMPULSES = 64  # kMaxImpulses in csrc/project.cu


def _member_divergence(vel, dx, walls):
    """``ops.fd.divergence`` with the reflected ghost (``-center``) at every
    member wall."""
    i_lo, i_hi, j_lo, j_hi = walls
    vx, vy = vel[0], vel[1]
    t_up = torch.where(i_lo, -vx, _shift_zero(vx, 0, -1))
    t_dn = torch.where(i_hi, -vx, _shift_zero(vx, 0, 1))
    t_lf = torch.where(j_lo, -vy, _shift_zero(vy, 1, -1))
    t_rt = torch.where(j_hi, -vy, _shift_zero(vy, 1, 1))
    return ((t_dn - t_up) + (t_rt - t_lf)) * (1.0 / (2.0 * dx))


def _member_subtract_gradient(vel, p, dx, walls):
    """``ops.fd.subtract_gradient`` with the Neumann clamp at every member
    wall."""
    i_lo, i_hi, j_lo, j_hi = walls
    inv = 1.0 / (2.0 * dx)
    g0 = (torch.where(i_hi, p, _shift_zero(p, 0, 1))
          - torch.where(i_lo, p, _shift_zero(p, 0, -1))) * inv
    g1 = (torch.where(j_hi, p, _shift_zero(p, 1, 1))
          - torch.where(j_lo, p, _shift_zero(p, 1, -1))) * inv
    return vel - torch.stack([g0, g1], dim=0)


def project_fused_reference(vel, dx=1.0, iters=10, omega=1.96,
                            impulses=None, member=None):
    """Plain PyTorch version: the composed ops of the port, or their
    member-masked forms over the whole grid."""
    if impulses is not None:
        from ...models.stable_fluids import apply_impulses
        vel = apply_impulses(vel, impulses)
    if member is None:
        p = sor_solve(divergence(vel, dx), dx, iters, omega)
        return subtract_gradient(vel, p, dx), p
    walls = member_walls(vel.shape[1:], member, vel.device)
    p = member_sor_solve(_member_divergence(vel, dx, walls), dx, iters,
                         omega, walls)
    return _member_subtract_gradient(vel, p, dx, walls), p


def project_fused(vel: torch.Tensor, dx: float = 1.0, iters: int = 10,
                  omega: float = 1.96, impulses=None, member=None,
                  **unported):
    """(projected velocity, pressure) for a 2D ``[2, H, W]`` float32
    velocity: optional impulse drain (clamped positions, the last active
    slot wins, values rounded through ``vel.dtype``), divergence,
    ``iters`` RB-SOR sweeps from zero, gradient subtract; per member tile
    with ``member``.  Block mode (K11) raises."""
    refuse_unported("project_fused", unported)
    if vel.dim() != 3 or vel.shape[0] != 2:
        raise ValueError("project_fused: vel must be [2, H, W]")
    member = check_member("project_fused", member, *vel.shape[1:])
    if vel.device.type == "cpu":
        return project_fused_reference(vel, dx, iters, omega, impulses,
                                       member)
    if not vel.is_cuda:
        raise ValueError(f"project_fused: unsupported device {vel.device}")
    if vel.dtype != torch.float32:
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

    mh, mw = member or (0, 0)
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
                 n_imp, h, w, mh, mw, float(dx),
                 float(np.float32(1.0 / (2.0 * dx))), int(iters),
                 float(omega), float(np.float32(1.0 - omega)),
                 stream_of(vel))
    project_fused.launches += 1
    project_fused.member_launches += member is not None
    return out, p


project_fused.launches = 0
project_fused.member_launches = 0
