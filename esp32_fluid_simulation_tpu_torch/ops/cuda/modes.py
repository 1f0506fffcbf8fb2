"""Argument checks shared by the kernel wrappers: the tensors of a CUDA
launch, block mode (K11) of K1, K2, K4, K7 and K9, and the member-tile
shape of the tiled-domain modes (K6) on a supergrid or on a member stack,
and the two layouts' permutes (``_to_members``, ``_from_members``), on
which the stack modes' plain versions lay a stack out as its supergrid."""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

BLOCK_MODE = ("global_offset", "global_shape", "halo")
F32 = (torch.float32,)
FLOATS = (torch.float32, torch.bfloat16)


def check_launch(name, **tensors):
    """Raise ValueError unless each keyword's ``(tensor, dtypes)`` is fit
    for a launch of wrapper ``name``: the tensors on one CUDA device (the
    first's; else "unsupported device"), contiguous, each of one of its
    ``dtypes``.  A None tensor is an absent buffer.  The keywords name the
    tensors in the messages."""
    first = None
    for label, (t, dtypes) in tensors.items():
        if t is None:
            continue
        if first is None:
            if not t.is_cuda:
                raise ValueError(f"{name}: unsupported device {t.device}")
            first = label, t.device
        elif t.device != first[1]:
            raise ValueError(f"{name}: {label} and {first[0]} on different "
                             "devices")
        if t.dtype not in dtypes:
            raise ValueError(f"{name}: {label} dtype {t.dtype} not supported "
                             f"({', '.join(str(d)[6:] for d in dtypes)})")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {label} must be contiguous")


def refuse_unported(name, kwargs, also=()):
    """Raise TypeError for an argument the TPU kernel does not take, and
    NotImplementedError for one of ``also``, which it takes and the port
    does not.  None and False mean "not asked for"."""
    for key, value in kwargs.items():
        if key not in also:
            raise TypeError(f"{name} got an unexpected argument {key!r}")
        if value is None or value is False:
            continue
        raise NotImplementedError(f"{name}: {key}= is not ported (ROADMAP.md "
                                  "queue 1, 'Not to port')")


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


def host_offset(global_offset, n=2):
    """The ``n`` coordinates of an origin as Python ints, from a sequence of
    ints or an ``n``-element integer tensor (read once on the host)."""
    if isinstance(global_offset, torch.Tensor):
        if global_offset.is_floating_point():
            raise ValueError(f"global_offset must be {n} integers")
        global_offset = global_offset.reshape(-1).tolist()
    if len(global_offset) != n:
        raise ValueError(f"global_offset must be {n} integers, got "
                         f"{list(global_offset)}")
    return tuple(int(v) for v in global_offset)


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


def check_block3d(name, global_offset, global_shape, halo, shape, need,
                  what):
    """``check_block`` for a 3D field ``[..., D, rows, cols]`` whose
    vertical axis is shard-local: ``global_shape`` is the domain's
    ``(D, H, W)`` with the field's own ``D``, the halo on the two
    horizontal axes only."""
    if global_offset is not None and global_shape is not None:
        gshape = tuple(int(n) for n in global_shape)
        if len(gshape) != 3:
            raise ValueError(f"{name}: global_shape {gshape} is not (D, H, "
                             "W)")
        if gshape[0] != shape[-3]:
            raise ValueError(f"{name}: the vertical axis must be shard-local "
                             f"(field D={shape[-3]} != global D={gshape[0]})")
        global_shape = gshape[1:]
    return check_block(name, global_offset, global_shape, halo, shape[-2:],
                       need, what)


def chunk_geometry(name, global_offset, global_shape, shape):
    """``(origin, domain)`` of a 3D chunk (K9 block mode): the haloed
    array's global origin ``(oz, oi, oj)``, 0 without ``global_offset``,
    and the domain ``(gd, gh, gw)``, the array's own shape without
    ``global_shape``."""
    origin = (0, 0, 0) if global_offset is None else host_offset(
        global_offset, 3)
    domain = tuple(shape) if global_shape is None else tuple(
        int(n) for n in global_shape)
    if len(domain) != 3 or min(domain) < 2:
        raise ValueError(f"{name}: global_shape {domain} is not (D, H, W), "
                         "each >= 2")
    return origin, domain


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


def member_grid(n):
    """``(gh, gw)``: the tiling of ``n`` members, the most square
    factorization with ``gh <= gw``, members row-major over it."""
    gh = math.isqrt(n)
    while n % gh:
        gh -= 1
    return gh, n // gh


def check_stack(name, x, member, channels=None):
    """For a member stack ``x`` ``[n, C, mh, mw]`` (``C`` in ``channels``
    where given), ``member`` must be its ``(mh, mw)``; returns the tiling
    ``(gh, gw)`` of its supergrid (``member_grid``)."""
    n, c, mh, mw = x.shape
    if member is None or tuple(int(m) for m in member) != (mh, mw):
        raise ValueError(f"{name}: a member stack {tuple(x.shape)} needs "
                         f"member=({mh}, {mw}), got {member}")
    if n < 1 or mh < 2 or mw < 2 or (channels and c not in channels):
        raise ValueError(f"{name}: member stack {tuple(x.shape)} not "
                         "supported")
    return member_grid(n)


def _to_members(x: torch.Tensor, mh: int, mw: int) -> torch.Tensor:
    """``[C, gh*mh, gw*mw]`` -> ``[gh*gw, C, mh, mw]`` (tiled domain ->
    member stack, row-major over the tile grid)."""
    c, h, w = x.shape
    gh, gw = h // mh, w // mw
    return (x.reshape(c, gh, mh, gw, mw).permute(1, 3, 0, 2, 4)
            .reshape(gh * gw, c, mh, mw))


def _from_members(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """``[gh*gw, C, mh, mw]`` -> ``[C, h, w]``, the inverse of
    ``_to_members``."""
    n, c, mh, mw = x.shape
    gh, gw = h // mh, w // mw
    return (x.reshape(gh, gw, c, mh, mw).permute(2, 0, 3, 1, 4)
            .reshape(c, h, w))
