"""K1: pressure projection with the drag-queue drain on the GPU
(``csrc/project.cu``).

Replaces ``esp32_fluid_simulation_tpu/ops/pallas/project.py:
project_fused_pallas``.  ``project_fused`` launches the CUDA kernels for
CUDA tensors and runs ``project_fused_reference``, its plain PyTorch version
(``apply_impulses -> divergence -> sor_solve -> subtract_gradient``), for
CPU tensors — only because they lie on the CPU.  Any other device raises.

Two routes, chosen by ``iters`` alone: up to ``WINDOW_MAX_ITERS`` one
launch (``fluid_project_window``: each block walks a row segment of a
column strip of the output, its window the strip +- ``2*iters + 1``
columns, and runs the drain, every half-sweep and the gradient as a
wavefront down its rows; ``strip_plan`` cuts the strips and segments),
above it the sequence of ``2*iters + 2`` launches (``fluid_project``) whose
half-sweeps stream the field through device memory.  Every config's
``sor_iters`` (10) takes the window route.  With ``member=`` the window
route is one launch of the trapezoid (``fluid_project_trapezoid``: each
block projects a tile of the output inside its window, the tile +-
``2*iters + 1`` cells, in shared memory; ``sor.window_tile``), which the
member walls make faster there than the strip.  ``project_fused.launches``
counts calls; ``window_launches`` and ``sequence_launches`` count each
route's, ``trapezoid_launches`` the window route's member calls.

``member=(mh, mw)`` (K6, ``project.py:121-134``): every member tile of the
grid is projected on its own — reflected ghosts, zero ghosts and ``a_ii``,
and the gradient's Neumann clamp at every member wall — with the whole
grid's red-black parity, as in the TPU kernel.  The plain version is the
same masked ops over the whole grid (not the composed ops per member, whose
parity would start at each member's origin).  It combines with
``impulses``; ``project_fused.member_launches`` counts its launches.

On a member stack (``vel`` ``[n, 2, mh, mw]`` with ``member=(mh, mw)``,
its own: the ensemble's state as it lies, the members row-major over the
``modes.member_grid(n)`` tiling of a ``[2, gh*mh, gw*mw]`` supergrid) the
trapezoid computes on that supergrid's coordinates and reads and writes the
stack in place (``csrc/stack.cuh``): it returns the ``[n, 2, mh, mw]``
velocity and the ``[n, mh, mw]`` pressure, the supergrid member mode's laid
out as stacks, bit for bit.  Only the trapezoid takes a stack
(``project_fused_takes_stack``), so ``iters`` above ``WINDOW_MAX_ITERS``
raise ``ValueError``, as does block mode; ``impulses`` keep supergrid
positions.  Its plain version is the supergrid's between
``modes._from_members`` and ``_to_members``; ``project_fused.stack_launches``
counts its launches, which count as member and trapezoid launches too.

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
from ..impulses import apply_impulses, impulses_in_window
from ..poisson import _shift_zero, sor_solve
from .build import launch, query
from .modes import (F32, _from_members, _to_members, block_coords,
                    check_block, check_launch, check_member, check_stack,
                    refuse_unported)
from .sor import (WINDOW_MAX_ITERS, member_sor_solve, member_walls, owned,
                  walls_at, window_tile)

_MAX_IMPULSES = 64  # kMaxImpulses in csrc/project.cu
_I32, _BOOL = (torch.int32,), (torch.bool,)


# The window route's widest window: 4 warps a block, a lane one plane
# column of each colour (kStripWarps in csrc/project.cu)
STRIP_COLUMNS = 256


def strip_plan(bh, bw, iters, blocks):
    """``(n_strips, n_segments)`` of the window route over ``bh x bw`` owned
    cells: the fewest column strips whose windows, a strip +- ``2*iters +
    1`` columns, fit ``STRIP_COLUMNS`` (``csrc/project.cu`` cuts them as
    evenly as they go, so none is a sliver), and enough row segments for
    ``blocks`` blocks, at most one a row."""
    width = STRIP_COLUMNS - 2 * (2 * iters + 1)
    n_strips = -(-bw // width)
    return n_strips, max(1, min(bh, -(-blocks // n_strips)))


def strip_blocks(device, iters):
    """The window route's blocks for a call on ``device``: two waves of the
    blocks the card holds at once (its SMs times the blocks per SM it
    reports for ``iters``'s instance), so that blocks start and end at
    different times."""
    key = (device.index, iters <= 10)
    if key not in strip_blocks.cache:
        per_sm = query("fluid_project_window_blocks", device, int(iters))
        if per_sm < 1:
            raise RuntimeError("project_fused: the window route's kernel "
                               "cannot run on this card")
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        strip_blocks.cache[key] = 2 * sms * per_sm
    return strip_blocks.cache[key]


strip_blocks.cache = {}


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
        vel = apply_impulses(vel, impulses)
    if member is None:
        p = sor_solve(divergence(vel, dx), dx, iters, omega)
        return subtract_gradient(vel, p, dx), p
    walls = member_walls(vel.shape[1:], member, vel.device)
    p = member_sor_solve(_member_divergence(vel, dx, walls), dx, iters,
                         omega, walls)
    return _member_subtract_gradient(vel, p, dx, walls), p


def project_fused_takes_stack(iters: int) -> bool:
    """Whether ``project_fused`` takes a member stack at ``iters``: only
    its trapezoid does (module docstring)."""
    return iters <= WINDOW_MAX_ITERS


def _stack_reference(vel, dx, iters, omega, impulses, grid):
    """The plain version on a member stack: the supergrid's, with the
    stack laid out as the supergrid and back."""
    gh, gw = grid
    _, _, mh, mw = vel.shape
    v, p = project_fused_reference(_from_members(vel, gh * mh, gw * mw), dx,
                                   iters, omega, impulses, (mh, mw))
    return _to_members(v, mh, mw), _to_members(p[None], mh, mw)[:, 0]


def project_fused(vel: torch.Tensor, dx: float = 1.0, iters: int = 10,
                  omega: float = 1.96, impulses=None, member=None,
                  global_offset=None, global_shape=None, halo: int = 0,
                  **unported):
    """(projected velocity, pressure) for a 2D ``[2, H, W]`` float32
    velocity: optional impulse drain (clamped positions, the last active
    slot wins, values rounded through ``vel.dtype``), divergence,
    ``iters`` RB-SOR sweeps from zero, gradient subtract; per member tile
    with ``member``, on a supergrid or on a ``[n, 2, mh, mw]`` member stack;
    of the owned block of a haloed shard block in block mode."""
    with span("fluid.k1.project"):
        refuse_unported("project_fused", unported)
        grid = None
        if vel.dim() == 4 and vel.shape[1] == 2:
            if global_offset is not None or global_shape is not None or halo:
                raise ValueError("project_fused: a member stack takes no "
                                 "block mode")
            if not project_fused_takes_stack(iters):
                raise ValueError(f"project_fused: a member stack takes iters "
                                 f"<= {WINDOW_MAX_ITERS} (the trapezoid), "
                                 f"got {iters}")
            grid = check_stack("project_fused", vel, member)
            member = tuple(vel.shape[2:])
            if vel.numel() >= 2 ** 31:
                raise ValueError("project_fused: a member stack of 2^31 "
                                 "values or more")
        elif vel.dim() != 3 or vel.shape[0] != 2:
            raise ValueError("project_fused: vel must be [2, H, W] or a "
                             "member stack [n, 2, mh, mw]")
        blk = check_block("project_fused", global_offset, global_shape, halo,
                          vel.shape[-2:], 2 * iters + 2, "2*iters+2")
        if grid is None:
            member = check_member("project_fused", member,
                                  *(vel.shape[1:] if blk is None
                                    else (blk.gh, blk.gw)))
        if vel.device.type == "cpu":
            if grid is not None:
                return _stack_reference(vel, dx, iters, omega, impulses,
                                        grid)
            return project_fused_reference(vel, dx, iters, omega, impulses,
                                           member, blk)
        if grid is None:
            _, h, w = vel.shape
        else:
            h, w = grid[0] * vel.shape[2], grid[1] * vel.shape[3]
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
            ipos = impulses.pos.to(torch.int32).contiguous()
            # round the written values through vel.dtype, as the scatter does
            ivel = (impulses.velocity.to(vel.dtype).to(torch.float32)
                    .contiguous())
            iact = impulses.active.to(torch.bool).contiguous()
        check_launch("project_fused", vel=(vel, F32), ipos=(ipos, _I32),
                     ivel=(ivel, F32), iact=(iact, _BOOL))

        mh, mw = member or (0, 0)
        if blk is None:
            g, (oi, oj), (gh, gw), (bh, bw) = 0, (0, 0), (h, w), (h, w)
        else:
            g, (oi, oj), (gh, gw) = blk.halo, blk.origin, (blk.gh, blk.gw)
            bh, bw = blk.bh, blk.bw
        out = torch.empty((2, bh, bw) if grid is None else vel.shape,
                          dtype=vel.dtype, device=vel.device)
        p_out = torch.empty((bh, bw) if grid is None else
                            vel[:, 0].shape, dtype=vel.dtype,
                            device=vel.device)
        imps = (ipos, ivel, iact)
        geometry = (n_imp, h, w, mh, mw, oi, oj, gh, gw, g)
        numbers = (float(dx), float(np.float32(1.0 / (2.0 * dx))), int(iters),
                   float(omega), float(np.float32(1.0 - omega)))
        if iters <= WINDOW_MAX_ITERS and member is None:
            plan = strip_plan(bh, bw, iters, strip_blocks(vel.device, iters))
            launch("fluid_project_window", vel, vel, out, p_out, *imps,
                   *geometry, *numbers, *plan)
            project_fused.window_launches += 1
        elif iters <= WINDOW_MAX_ITERS:
            launch("fluid_project_trapezoid", vel, vel, out, p_out, *imps,
                   *geometry, *numbers, *window_tile(2 * iters + 1),
                   int(grid is not None))
            project_fused.window_launches += 1
            project_fused.trapezoid_launches += 1
            project_fused.stack_launches += grid is not None
        else:
            # scratch: the haloed block's pressure in block mode, dx * div
            p = p_out if blk is None else torch.empty_like(vel[0])
            dxd = torch.empty_like(vel[0])
            launch("fluid_project", vel, vel, out, p, dxd, *imps, *geometry,
                   p_out, *numbers)
            project_fused.sequence_launches += 1
        project_fused.launches += 1
        project_fused.member_launches += member is not None
        project_fused.block_launches += blk is not None
        return out, p_out


project_fused.launches = 0
project_fused.member_launches = 0
project_fused.block_launches = 0
project_fused.window_launches = 0
project_fused.trapezoid_launches = 0
project_fused.sequence_launches = 0
project_fused.stack_launches = 0
