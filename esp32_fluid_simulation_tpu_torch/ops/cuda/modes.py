"""Argument checks shared by the kernel wrappers: block mode (K11) of K1,
K2 and K4, its refusal by the 3D kernels, and the member-tile shape of the
tiled-domain modes (K6)."""

from __future__ import annotations

from typing import NamedTuple

import torch

BLOCK_MODE = ("global_offset", "global_shape", "halo")
NEXT_SLICE = ("block mode of the 3D kernels (K11 for K7 and K9) is the next "
              "slice, ROADMAP.md queue 1 item 10")


def refuse_unported(name, kwargs, also=()):
    """Raise TypeError for an argument the TPU kernel does not take, and
    NotImplementedError for one it takes that is not ported: block mode
    (the 3D kernels' wrappers pass it here) and the names in ``also``.
    None, False and the JAX default ``halo=0`` mean "not asked for"."""
    for key, value in kwargs.items():
        if key not in BLOCK_MODE and key not in also:
            raise TypeError(f"{name} got an unexpected argument {key!r}")
        if value is None or value is False or (key == "halo" and value == 0):
            continue
        why = (NEXT_SLICE if key in BLOCK_MODE
               else "ROADMAP.md queue 1, 'Not to port'")
        raise NotImplementedError(f"{name}: {key}= is not ported ({why})")


class Block(NamedTuple):
    """One shard's block in its domain: the owned ``bh x bw`` cells start at
    global ``(ox, oy)`` of the ``gh x gw`` domain, and the haloed array
    carries ``halo`` more cells on each side."""

    ox: int
    oy: int
    gh: int
    gw: int
    halo: int
    bh: int
    bw: int

    @property
    def origin(self):
        """Global coordinates of the haloed array's cell (0, 0)."""
        return self.ox - self.halo, self.oy - self.halo


def host_offset(global_offset):
    """``(ox, oy)`` as Python ints from a pair of ints or a 2-element
    integer tensor (read once on the host)."""
    if isinstance(global_offset, torch.Tensor):
        if global_offset.is_floating_point() or global_offset.numel() != 2:
            raise ValueError("global_offset must be 2 integers")
        global_offset = global_offset.reshape(-1).tolist()
    ox, oy = (int(v) for v in global_offset)
    return ox, oy


def check_block(name, global_offset, global_shape, halo, shape, need,
                what):
    """Block mode's arguments as a ``Block``, or None without
    ``global_offset``.  ``shape`` is the haloed array's ``(rows, cols)``;
    ``halo`` must be at least ``need`` (``what`` says why), as the TPU
    kernel demands.  ``global_shape`` or a nonzero ``halo`` without
    ``global_offset`` raise (the TPU kernel ignores them)."""
    if global_offset is None:
        if global_shape is not None or halo:
            raise ValueError(f"{name}: global_shape= and halo= need "
                             "global_offset= (block mode)")
        return None
    if global_shape is None:
        raise ValueError(f"{name}: block mode needs global_shape=")
    halo = int(halo)
    if halo < need:
        raise ValueError(f"{name}: block mode needs halo >= {what} ghost "
                         f"cells ({halo} < {need})")
    ox, oy = host_offset(global_offset)
    gh, gw = (int(n) for n in global_shape)
    bh, bw = shape[0] - 2 * halo, shape[1] - 2 * halo
    if bh < 1 or bw < 1 or not (0 <= ox and ox + bh <= gh and 0 <= oy
                                and oy + bw <= gw) or min(gh, gw) < 2:
        raise ValueError(f"{name}: a {tuple(shape)} block with halo {halo} "
                         f"at {(ox, oy)} does not lie in the "
                         f"{(gh, gw)} domain")
    return Block(ox, oy, gh, gw, halo, bh, bw)


def block_coords(blk: Block, shape, device):
    """Global row and column indices ``([rows, 1], [1, cols])`` of a
    ``shape`` array whose cell (0, 0) is the haloed array's, and the
    ``in_dom`` mask of the cells inside the domain."""
    oi, oj = blk.origin
    gi = torch.arange(shape[0], device=device)[:, None] + oi
    gj = torch.arange(shape[1], device=device)[None, :] + oj
    in_dom = (gi >= 0) & (gi < blk.gh) & (gj >= 0) & (gj < blk.gw)
    return gi, gj, in_dom


def check_member(name, member, h, w):
    """``(mh, mw)`` as ints, for member tiles of at least 2x2 that divide
    the ``h x w`` grid, or None."""
    if member is None:
        return None
    mh, mw = (int(m) for m in member)
    if mh < 2 or mw < 2 or h % mh or w % mw:
        raise ValueError(f"{name}: member {tuple(member)} must be at least "
                         f"2x2 and divide the grid {h}x{w}")
    return mh, mw
