"""K4: the whole 2D red-black SOR pressure solve on the GPU
(``csrc/sor.cu``).

Replaces ``esp32_fluid_simulation_tpu/ops/pallas/sor.py:sor_solve_pallas``.
``sor_solve_kernel`` launches the CUDA kernels for CUDA tensors and runs
``sor_solve_reference``, its plain PyTorch version (``ops.poisson.
sor_solve``: zero init, even parity first, the same neighbour order and
``-1/a_ii`` LUT), for CPU tensors — only because they lie on the CPU.  Any
other device raises.  The half-sweep is K1's (``csrc/rb2d.cuh``).

Two routes, chosen by ``iters`` alone, as K1's: up to
``WINDOW_MAX_ITERS`` one launch (``fluid_sor_window``: each block solves a
tile of the output inside its window, the tile +- ``2*iters`` cells, in
shared memory), above it a fill and ``2*iters`` half-sweep launches
(``fluid_sor``) that stream the field through device memory.
``sor_solve_kernel.launches`` counts calls; ``window_launches`` and
``sequence_launches`` count each route's.

``member=(mh, mw)`` (K6, ``sor.py:83``, ``rb_common.py:145-176``): every
member tile of the grid is solved on its own — neighbour sums read 0 across
member walls and ``a_ii`` counts member-local neighbours — while the colour
stays the parity of the whole grid, as in the TPU kernel.  Its plain
version is therefore a masked solve over the whole grid, not the solve of
each member alone; ``sor_solve_kernel.member_launches`` counts its
launches.

Block mode (K11, ``global_offset=``/``global_shape=``/``halo=``,
``sor.py:101-110``, the sharded step's ``solver="sor_pallas"``): ``d`` is
one shard's block with ``halo >= 2*iters`` exchanged cells per side,
``global_offset`` the owned block's global origin ``(ox, oy)`` (two ints or
a 2-element integer tensor, read once on the host) and ``global_shape`` the
domain.  Walls, ``a_ii`` and the colour ``(gi + gj) % 2`` come from global
coordinates, a neighbour beyond the block reads 0, cells outside the domain
hold 0, and the owned ``bh x bw`` pressure is returned.  It combines with
``member=`` (member tiles of the domain).  The plain version is the same
masked ops over the haloed block, then the owned crop;
``sor_solve_kernel.block_launches`` counts its launches.
"""

from __future__ import annotations

import numpy as np
import torch

from ..poisson import _parity, _shift_zero, neg_inv_of, sor_solve
from .build import launch
from .modes import (F32, block_coords, check_block, check_launch,
                    check_member, refuse_unported)


# The window routes' tile (K4 here, K1 in project.py): (rows, columns) of
# the output a block owns, and the block's thread rows (32 threads each).
# A window, the tile +- its halo, holds at most WINDOW_ROWS x WINDOW_COLS
# cells (p and dx*d: 224,512 bytes of the 232,448 a block may use; the
# planes are 96 words wide): a larger halo takes a smaller tile
# (window_tile).
TILE = (104, 146, 32)
WINDOW_ROWS, WINDOW_COLS = 146, 192
# The largest iters the window routes take: at 15 K1's tile is 84 x 130
WINDOW_MAX_ITERS = 15


def window_tile(halo):
    """A window route's (rows, columns, thread rows) for windows of the
    tile +- ``halo`` cells: ``TILE``, cut so that its window fits."""
    th, tw, ny = TILE
    return (min(th, WINDOW_ROWS - 2 * halo), min(tw, WINDOW_COLS - 2 * halo),
            ny)


def walls_at(gi, gj, gh, gw, member=None):
    """``(i_lo, i_hi, j_lo, j_hi)``: boolean masks (broadcasting over the
    global row indices ``gi`` and column indices ``gj``) of the cells on
    each wall of the ``gh x gw`` domain, or of their ``(mh, mw)`` member
    tile."""
    if member is None:
        return gi == 0, gi == gh - 1, gj == 0, gj == gw - 1
    mh, mw = member
    i, j = gi % mh, gj % mw
    return i == 0, i == mh - 1, j == 0, j == mw - 1


def diag_at(walls):
    """``a_ii``, the int64 count of the neighbours not cut off by
    ``walls`` (``walls_at``'s four masks)."""
    return 4 - sum(m.long() for m in walls)


def member_walls(shape, member, device):
    """``walls_at`` of the member tiles of a grid of ``shape``."""
    gi = torch.arange(shape[0], device=device)[:, None]
    gj = torch.arange(shape[1], device=device)[None, :]
    return walls_at(gi, gj, *shape, member)


def member_sor_solve(d, dx, iters, omega, walls, parity=None, in_dom=None):
    """``sor_solve`` with zero ghosts and ``a_ii`` at the ``walls``, the
    ``parity`` of the whole grid (of ``d``'s grid when None), and the cells
    outside ``in_dom`` held at 0 (``ops.poisson.sor_sweep``'s
    arithmetic)."""
    i_lo, i_hi, j_lo, j_hi = walls
    neg_inv = neg_inv_of(diag_at(walls), d.dtype)
    if parity is None:
        parity = _parity(d.shape, device=d.device)
    p = torch.zeros_like(d)
    for _ in range(iters):
        for color in (0, 1):
            nb = (((torch.where(i_lo, 0.0, _shift_zero(p, 0, -1))
                    + torch.where(i_hi, 0.0, _shift_zero(p, 0, 1)))
                   + torch.where(j_lo, 0.0, _shift_zero(p, 1, -1)))
                  + torch.where(j_hi, 0.0, _shift_zero(p, 1, 1)))
            gs = neg_inv * (dx * d - nb)
            p_new = (1.0 - omega) * p + omega * gs
            mask = parity == color
            if in_dom is not None:
                mask = mask & in_dom
            p = torch.where(mask, p_new, p)
    return p


def owned(x, blk):
    """The owned ``bh x bw`` cells of a haloed block (trailing two axes)."""
    g = blk.halo
    return x[..., g:g + blk.bh, g:g + blk.bw]


def block_sor_solve(d, dx, iters, omega, blk, member=None):
    """The plain block-mode solve: ``member_sor_solve`` over the haloed
    block with the domain's walls (or its members'), the global parity and
    the domain mask, then the owned crop."""
    gi, gj, in_dom = block_coords(blk, d.shape, d.device)
    p = member_sor_solve(d, dx, iters, omega,
                         walls_at(gi, gj, blk.gh, blk.gw, member),
                         (gi + gj) & 1, in_dom)
    return owned(p, blk)


def sor_solve_reference(d, dx=1.0, iters=10, omega=1.96, member=None,
                        block=None):
    """Plain PyTorch version: ``ops.poisson.sor_solve`` in 2D, its
    member-masked form, or (``block``, a ``modes.Block``) its block-mode
    form."""
    if block is not None:
        return block_sor_solve(d, dx, iters, omega, block, member)
    if member is None:
        return sor_solve(d, dx, iters, omega)
    return member_sor_solve(d, dx, iters, omega,
                            member_walls(d.shape, member, d.device))


def sor_solve_kernel(d: torch.Tensor, dx: float = 1.0, iters: int = 10,
                     omega: float = 1.96, member=None, global_offset=None,
                     global_shape=None, halo: int = 0,
                     **unported) -> torch.Tensor:
    """Pressure ``p`` with ``lap(p) = d`` after ``iters`` red-black SOR
    sweeps from zero, for an ``[H, W]`` float32 ``d`` (per member tile with
    ``member``; the owned block of a haloed shard block in block mode)."""
    refuse_unported("sor_solve_kernel", unported)
    if d.dim() != 2:
        raise ValueError("sor_solve_kernel: d must be [H, W]")
    blk = check_block("sor_solve_kernel", global_offset, global_shape, halo,
                      d.shape, 2 * iters, "2*iters")
    member = check_member("sor_solve_kernel", member,
                          *(d.shape if blk is None else (blk.gh, blk.gw)))
    if d.device.type == "cpu":
        return sor_solve_reference(d, dx, iters, omega, member, blk)
    check_launch("sor_solve_kernel", d=(d, F32))
    h, w = d.shape
    # the half-sweeps put rows on grid.y, 8 a block, at most 65535 blocks
    if h < 2 or w < 2 or h > 8 * 65535 or iters < 0:
        raise ValueError(f"sor_solve_kernel: shape {tuple(d.shape)} / iters "
                         f"{iters} not supported (2 <= H <= 524280, W >= 2, "
                         "iters >= 0)")
    mh, mw = member or (0, 0)
    g = 0 if blk is None else blk.halo
    oi, oj = (0, 0) if blk is None else blk.origin
    gh, gw = (h, w) if blk is None else (blk.gh, blk.gw)
    out = (torch.empty_like(d) if g == 0 else
           torch.empty((blk.bh, blk.bw), dtype=d.dtype, device=d.device))
    geometry = (h, w, mh, mw, oi, oj, gh, gw, g)
    numbers = (float(dx), int(iters), float(omega),
               float(np.float32(1.0 - omega)))
    if iters <= WINDOW_MAX_ITERS:
        launch("fluid_sor_window", d, d, out, *geometry, *numbers,
               *window_tile(2 * iters))
        sor_solve_kernel.window_launches += 1
    else:
        # scratch: the haloed block's pressure in block mode, dx * d
        p = out if g == 0 else torch.empty_like(d)
        dxd = torch.empty_like(d)
        launch("fluid_sor", d, d, p, dxd, *geometry, out, *numbers)
        sor_solve_kernel.sequence_launches += 1
    sor_solve_kernel.launches += 1
    sor_solve_kernel.member_launches += member is not None
    sor_solve_kernel.block_launches += blk is not None
    return out


sor_solve_kernel.launches = 0
sor_solve_kernel.member_launches = 0
sor_solve_kernel.block_launches = 0
sor_solve_kernel.window_launches = 0
sor_solve_kernel.sequence_launches = 0
