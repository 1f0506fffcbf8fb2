"""The drag queue's drain (``.ino:258-269``): positions clamped to the grid,
the last active slot winning at a duplicated cell.

It sits below the models and the kernels: K1's plain version drains the
queue through it, and the steps import it from ``models.stable_fluids``.
"""

from __future__ import annotations

import torch

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
    idx, winner = _resolved_impulse_targets(imp, vel.shape[1:])
    where = (slice(None),) + idx
    vals = imp.velocity.to(vel.dtype)[winner.clamp(min=0)].T   # [nd, k]
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
