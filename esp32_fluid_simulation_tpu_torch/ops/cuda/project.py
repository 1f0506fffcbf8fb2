"""K1: pressure projection with the drag-queue drain on the GPU
(``csrc/project.cu``).

Replaces ``esp32_fluid_simulation_tpu/ops/pallas/project.py:
project_fused_pallas``.  ``project_fused`` launches the CUDA kernels for
CUDA tensors and runs ``project_fused_reference``, its plain PyTorch version
(``apply_impulses -> divergence -> sor_solve -> subtract_gradient``), for
CPU tensors — only because they lie on the CPU.  Any other device raises.

Two routes, chosen by ``iters`` alone: up to ``WINDOW_MAX_ITERS`` one
launch (``fluid_project_window``: each block projects a tile of the
output inside its window, the tile +- ``2*iters + 1`` cells, in shared
memory, the TPU kernel's design; ``sor.window_tile``), above
it the sequence of ``2*iters + 2`` launches (``fluid_project``) whose
half-sweeps stream the field through device memory.  Every config's
``sor_iters`` (10) takes the window route.  ``project_fused.launches``
counts calls; ``window_launches`` and ``sequence_launches`` count each
route's.

``member=(mh, mw)`` (K6, ``project.py:121-134``): every member tile of the
grid is projected on its own — reflected ghosts, zero ghosts and ``a_ii``,
and the gradient's Neumann clamp at every member wall — with the whole
grid's red-black parity, as in the TPU kernel.  The plain version is the
same masked ops over the whole grid (not the composed ops per member, whose
parity would start at each member's origin).  It combines with
``impulses``; ``project_fused.member_launches`` counts its launches.

Block mode (K11, ``global_offset=``/``global_shape=``/``halo=``,
``project.py:212-229``, the sharded step's ``solver="fused_pallas"``):
``vel`` is one shard's block with ``halo >= 2*iters + 2`` exchanged cells
per side, ``global_offset`` the owned block's global origin ``(ox, oy)``
(two ints or a 2-element integer tensor, read once on the host) and
``global_shape`` the domain.  The drain compares global positions (clamped
to the domain), the walls of the divergence, the solve and the gradient are
the domain's, the colour is the global parity, a neighbour beyond the block
reads 0, cells outside the domain hold 0, and the owned ``[2, bh, bw]``
velocity and ``[bh, bw]`` pressure are returned.  It combines with
``impulses`` and ``member``.  The plain version is the same masked ops over
the haloed block, then the owned crop; ``project_fused.block_launches``
counts its launches.
"""

from __future__ import annotations

import numpy as np
import torch

from ...spans import span
from ..fd import divergence, subtract_gradient
from ..poisson import _shift_zero, sor_solve
from .build import load, stream_of
from .modes import block_coords, check_block, check_member, refuse_unported
from .sor import (WINDOW_MAX_ITERS, member_sor_solve, member_walls, owned,
                  walls_at, window_tile)

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


def block_project(vel, dx, iters, omega, impulses, member, blk):
    """The plain block-mode projection: the drain at global positions, the
    member-masked ops over the haloed block with the domain's walls (or its
    members'), the global parity and the domain mask, then the owned
    crop."""
    gi, gj, in_dom = block_coords(blk, vel.shape[1:], vel.device)
    if impulses is not None:
        from ...models.stable_fluids import apply_impulses, impulses_in_window
        vel = apply_impulses(vel, impulses_in_window(
            impulses, (blk.gh, blk.gw), blk.origin, vel.shape[1:]))
    walls = walls_at(gi, gj, blk.gh, blk.gw, member)
    div = torch.where(in_dom, _member_divergence(vel, dx, walls), 0.0)
    p = member_sor_solve(div, dx, iters, omega, walls, (gi + gj) & 1, in_dom)
    return (owned(_member_subtract_gradient(vel, p, dx, walls), blk),
            owned(p, blk))


def project_fused_reference(vel, dx=1.0, iters=10, omega=1.96,
                            impulses=None, member=None, block=None):
    """Plain PyTorch version: the composed ops of the port, their
    member-masked forms over the whole grid, or (``block``, a
    ``modes.Block``) their block-mode forms."""
    if block is not None:
        return block_project(vel, dx, iters, omega, impulses, member, block)
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
                  global_offset=None, global_shape=None, halo: int = 0,
                  **unported):
    """(projected velocity, pressure) for a 2D ``[2, H, W]`` float32
    velocity: optional impulse drain (clamped positions, the last active
    slot wins, values rounded through ``vel.dtype``), divergence,
    ``iters`` RB-SOR sweeps from zero, gradient subtract; per member tile
    with ``member``; of the owned block of a haloed shard block in block
    mode."""
    with span("fluid.k1.project"):
        refuse_unported("project_fused", unported)
        if vel.dim() != 3 or vel.shape[0] != 2:
            raise ValueError("project_fused: vel must be [2, H, W]")
        blk = check_block("project_fused", global_offset, global_shape, halo,
                          vel.shape[1:], 2 * iters + 2, "2*iters+2")
        member = check_member("project_fused", member,
                              *(vel.shape[1:] if blk is None
                                else (blk.gh, blk.gw)))
        if vel.device.type == "cpu":
            return project_fused_reference(vel, dx, iters, omega, impulses,
                                           member, blk)
        if not vel.is_cuda:
            raise ValueError(f"project_fused: unsupported device {vel.device}")
        if vel.dtype != torch.float32:
            raise ValueError("project_fused: vel must be float32 [2, H, W]")
        if not vel.is_contiguous():
            raise ValueError("project_fused: vel must be contiguous")
        _, h, w = vel.shape
        # the launches put rows on grid.y, 8 a block, at most 65535 blocks
        if h < 2 or w < 2 or h > 8 * 65535 or iters < 0:
            raise ValueError("project_fused: needs 2 <= H <= 524280, W >= 2 "
                             "and iters >= 0")

        if impulses is None:
            n_imp, ipos, ivel, iact = 0, None, None, None
        else:
            n_imp = impulses.pos.shape[0]
            if n_imp > _MAX_IMPULSES or impulses.pos.shape != (n_imp, 2):
                raise ValueError(f"project_fused: impulses must be [K, 2] "
                                 f"with K <= {_MAX_IMPULSES}")
            for t in impulses:
                if t.device != vel.device:
                    raise ValueError("project_fused: impulses and vel on "
                                     "different devices")
            ipos = impulses.pos.to(torch.int32).contiguous()
            # round the written values through vel.dtype, as the scatter does
            ivel = (impulses.velocity.to(vel.dtype).to(torch.float32)
                    .contiguous())
            iact = impulses.active.to(torch.bool).contiguous()

        mh, mw = member or (0, 0)
        if blk is None:
            g, (oi, oj), (gh, gw), (bh, bw) = 0, (0, 0), (h, w), (h, w)
        else:
            g, (oi, oj), (gh, gw) = blk.halo, blk.origin, (blk.gh, blk.gw)
            bh, bw = blk.bh, blk.bw
        out = torch.empty((2, bh, bw), dtype=vel.dtype, device=vel.device)
        p_out = torch.empty((bh, bw), dtype=vel.dtype, device=vel.device)
        imp_ptrs = [None if t is None else t.data_ptr()
                    for t in (ipos, ivel, iact)]
        geometry = (n_imp, h, w, mh, mw, oi, oj, gh, gw, g)
        numbers = (float(dx), float(np.float32(1.0 / (2.0 * dx))), int(iters),
                   float(omega), float(np.float32(1.0 - omega)))
        lib = load()
        with torch.cuda.device(vel.device):
            if iters <= WINDOW_MAX_ITERS:
                lib.call("fluid_project_window", vel.data_ptr(),
                         out.data_ptr(), p_out.data_ptr(), *imp_ptrs,
                         *geometry, *numbers, *window_tile(2 * iters + 1),
                         stream_of(vel))
                project_fused.window_launches += 1
            else:
                # scratch: the haloed block's pressure in block mode, dx * div
                p = p_out if blk is None else torch.empty_like(vel[0])
                dxd = torch.empty_like(vel[0])
                lib.call("fluid_project", vel.data_ptr(), out.data_ptr(),
                         p.data_ptr(), dxd.data_ptr(), *imp_ptrs, *geometry,
                         p_out.data_ptr(), *numbers, stream_of(vel))
                project_fused.sequence_launches += 1
        project_fused.launches += 1
        project_fused.member_launches += member is not None
        project_fused.block_launches += blk is not None
        return out, p_out


project_fused.launches = 0
project_fused.member_launches = 0
project_fused.block_launches = 0
project_fused.window_launches = 0
project_fused.sequence_launches = 0
