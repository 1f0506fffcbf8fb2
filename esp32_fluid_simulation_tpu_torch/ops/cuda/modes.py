"""Argument checks shared by the kernel wrappers: the refusal of the TPU
kernels' block mode (K11, ROADMAP.md queue 1 item 10) and the member-tile
shape of the tiled-domain modes (K6)."""

from __future__ import annotations

BLOCK_MODE = ("global_offset", "global_shape", "halo")


def refuse_unported(name, kwargs, also=()):
    """Raise TypeError for an argument the TPU kernel does not take, and
    NotImplementedError for one it takes that is not ported: block mode and
    the names in ``also``.  None, False and the JAX default ``halo=0`` mean
    "not asked for"."""
    for key, value in kwargs.items():
        if key not in BLOCK_MODE and key not in also:
            raise TypeError(f"{name} got an unexpected argument {key!r}")
        if value is None or value is False or (key == "halo" and value == 0):
            continue
        why = ("block mode is K11, ROADMAP.md queue 1 item 10"
               if key in BLOCK_MODE else "ROADMAP.md queue 1, 'Not to port'")
        raise NotImplementedError(f"{name}: {key}= is not ported ({why})")


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
