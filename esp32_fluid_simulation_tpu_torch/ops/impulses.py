"""The drag queue's drain (``.ino:258-269``): positions clamped to the grid,
the last active slot winning at a duplicated cell.

It sits below the models and the kernels: K1's plain version drains the
queue through it, K2's member overlay (``ops/cuda/advect.py``
``member_overlay``) resolves an ensemble's queues through it, and the
steps import it from ``models.stable_fluids``.
"""

from __future__ import annotations

import math

import torch

from ..spans import span
from ..state import Impulses


def _resolved_impulse_targets(imp: Impulses, shape):
    """Queue-drain resolution in slot space (``.ino:264-269``): each slot's
    cell, clamped to the grid, and the index of the LAST active slot that
    writes that cell (-1 where no active slot does)."""
    nd = len(shape)
    k = imp.pos.shape[0]
    idx = tuple(imp.pos[:, a].long().clamp(0, shape[a] - 1)
                for a in range(nd))
    same = idx[0][:, None] == idx[0][None, :]
    for ax in range(1, nd):
        same &= idx[ax][:, None] == idx[ax][None, :]
    slots = torch.arange(k, device=imp.pos.device)
    winner = torch.where(same & imp.active[None, :], slots[None, :],
                         torch.full_like(slots[None, :], -1)).amax(dim=1)
    return idx, winner


def apply_impulses(vel: torch.Tensor, imp: Impulses) -> torch.Tensor:
    """Write drag velocities into cells (``.ino:264-269``), the last active
    slot winning at a duplicated cell; positions are clamped to the grid.
    Returns a fresh tensor; ``apply_impulses_`` writes into ``vel``."""
    return apply_impulses_(vel.clone(), imp)


def apply_impulses_(vel: torch.Tensor, imp: Impulses) -> torch.Tensor:
    """``apply_impulses`` in place: ``vel`` (2D or 3D) is written and
    returned.

    One scatter for all slots: every slot writes the value its cell ends
    with (the winner's, or the cell's own where no active slot writes it),
    so duplicate indices carry equal values and the write order does not
    matter — no host sync, no per-slot pass, no copy of the field."""
    with span("fluid.drain"):
        idx, winner = _resolved_impulse_targets(imp, vel.shape[1:])
        where = (slice(None),) + idx
        vals = imp.velocity.to(vel.dtype)[winner.clamp(min=0)].T  # [nd, k]
        vel[where] = torch.where(winner >= 0, vals, vel[where])
        return vel


def impulses_in_window(imp: Impulses, global_shape, origin,
                       shape) -> Impulses:
    """``imp`` in the frame of a ``shape`` window whose first cell sits at
    global ``origin`` of a ``global_shape`` grid (2D or 3D): positions
    clamped to the grid, then shifted; the slots whose cell lies outside
    the window become inactive, so ``apply_impulses`` on the window writes
    exactly the window's cells of the whole grid's drain."""
    idx = [imp.pos[:, a].long().clamp(0, global_shape[a] - 1) - origin[a]
           for a in range(len(global_shape))]
    inside = imp.active
    for x, n in zip(idx, shape):
        inside = inside & (x >= 0) & (x < n)
    return Impulses(pos=torch.stack(idx, dim=1).to(imp.pos.dtype),
                    velocity=imp.velocity, active=inside)


def write_cells(cells, write, vals, shape, base=None):
    """A ``[C, *shape]`` tensor: ``base`` (zeros when None, in ``vals``'
    dtype) with ``vals`` (``[C, K]``) written at the flat cell indices
    ``cells`` (``[K]``) where ``write``.  The other slots land in one spare
    element past the end and are dropped (JAX's ``mode="drop"``), so nothing
    waits on the host; the cells written must be distinct."""
    c, n = vals.shape[0], math.prod(shape)
    dev = vals.device
    if base is None:
        flat = torch.zeros(c * n + 1, dtype=vals.dtype, device=dev)
    else:
        flat = torch.empty(c * n + 1, dtype=base.dtype, device=dev)
        flat[:-1].copy_(base.reshape(-1))
        vals = vals.to(base.dtype)
    ch = torch.arange(c, device=dev)[:, None] * n
    idx = torch.where(write[None, :], ch + cells[None, :], c * n)
    flat[idx.reshape(-1)] = vals.reshape(-1)
    return flat[:-1].view((c,) + tuple(shape))


def overlay_from_targets(cells, write, vals, shape):
    """The dense ``[nd+1, *shape]`` float32 overlay of K2's store-time
    drain: channels ``[0, nd)`` the values written at ``cells`` where
    ``write``, channel ``nd`` a 1.0 write flag."""
    k = vals.shape[1]
    combo = torch.cat([vals.to(torch.float32),
                       torch.ones((1, k), dtype=torch.float32,
                                  device=vals.device)], dim=0)
    return write_cells(cells, write, combo, shape)


def member_writes(imp: Impulses, gw: int, mh: int, mw: int):
    """An ensemble's ``[n, K]`` impulses on the supergrid of its ``mh x mw``
    members, ``gw`` to a row: each slot's ``(rows, cols)`` and whether it
    writes.  Positions clamp to the member; within a member the last
    active slot at a cell wins (``.ino:264-269``)."""
    n, k, _ = imp.pos.shape
    dev = imp.pos.device
    m = torch.arange(n, device=dev)[:, None]
    li = imp.pos[:, :, 0].long().clamp(0, mh - 1)        # [n, K] local
    lj = imp.pos[:, :, 1].long().clamp(0, mw - 1)
    cell = li * mw + lj
    later = torch.ones((k, k), dtype=torch.bool, device=dev).triu(1)
    superseded = ((cell[:, :, None] == cell[:, None, :]) & later
                  & imp.active[:, None, :]).any(dim=2)
    return m // gw * mh + li, m % gw * mw + lj, imp.active & ~superseded


def member_cells(imp: Impulses, gh: int, gw: int, mh: int, mw: int):
    """``(flat cells, write mask, vals)`` of an ensemble's ``[n, K]``
    impulses on the ``gh x gw`` supergrid of its members, for
    ``write_cells`` and ``overlay_from_targets``."""
    n, k, nd = imp.pos.shape
    rows, cols, write = member_writes(imp, gw, mh, mw)
    vals = imp.velocity.permute(2, 0, 1).reshape(nd, n * k)
    return (rows * (gw * mw) + cols).reshape(-1), write.reshape(-1), vals
