"""The member swirl generator: every member of an ensemble swirled by its
own ring of tangential pokes, each member at its own phase.

``shape`` is ``[members, H, W]``.  Member ``m`` at step ``t`` receives what
``swirl.py`` gives one grid of ``H x W`` at step ``t + member_stride * m``
(the program's own convention, ``run.py --ensemble``): ``n_points`` pokes
on a ring of radius ``radius_frac * min(H, W)`` around the member's centre,
the ring turned by ``turn_rad`` a step, each poke at ``speed`` cells/s along
the ring's tangent.  The seed draws the starting angle, shared by every
member, so every seed sends the same number of pokes at the same speed, in
other places.  The pokes are ``swirl.py``'s own: step ``t`` holds step
``t - member_stride``'s pokes less its first member's, with the last
member's computed anew, so a step computes one member's pokes and copies
the rest.  They are handed over as three flat numpy arrays of plain
numbers, one row a poke: its member, its member-local cell and its
velocity.  Arrays cross to the program without a Python object a poke,
and slicing one (``[::2]``) drops pokes as slicing a list would.  They are
read-only, since a step's arrays are kept for the step ``member_stride``
later.
"""

from __future__ import annotations

import importlib.util
from pathlib import Path

import numpy as np


def _load_swirl():
    path = Path(__file__).with_name("swirl.py")
    spec = importlib.util.spec_from_file_location("bench_port_traffic_swirl",
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


_SWIRL = _load_swirl()


def _frozen(a: np.ndarray) -> np.ndarray:
    a.flags.writeable = False
    return a


class MemberSwirl:
    def __init__(self, params: dict, shape, seed: int):
        self.members, h, w = (int(n) for n in shape)
        self.stride = int(params["member_stride"])
        self.grid = _SWIRL.make(params, (h, w), seed)
        self._member = _frozen(np.repeat(np.arange(self.members),
                                         self.grid.n))
        self._recent = {}   # step -> its (positions, velocities)

    def _grid(self, t: int):
        """``swirl.py``'s pokes of one member at grid step ``t``, as
        arrays."""
        pos, vel = self.grid.step(t)
        return (np.array(pos, np.int64).reshape(-1, 2),
                np.array(vel, np.float64).reshape(-1, 2))

    def _pokes(self, t: int):
        """Step ``t``'s positions and velocities, member-major."""
        last = self._grid(t + self.stride * (self.members - 1))
        before = self._recent.get(t - self.stride)
        if before is None:
            grids = [self._grid(t + self.stride * m)
                     for m in range(self.members - 1)] + [last]
        else:
            n = self.grid.n
            grids = [(before[0][n:], before[1][n:]), last]
        return tuple(_frozen(np.concatenate([g[i] for g in grids]))
                     for i in (0, 1))

    def step(self, t: int):
        """``(members, positions, velocities)`` for step ``t``: arrays,
        member-major, of each poke's member ``[P]``, its ``(i, j)`` cell in
        the member ``[P, 2]`` and its ``(v_i, v_j)`` in cells/s
        ``[P, 2]``."""
        pos, vel = self._pokes(t)
        self._recent[t] = (pos, vel)
        self._recent.pop(t - self.stride, None)
        if len(self._recent) > self.stride:
            self._recent = {s: v for s, v in self._recent.items()
                            if t - self.stride < s <= t}
        return self._member, pos, vel


def make(params: dict, shape, seed: int) -> MemberSwirl:
    return MemberSwirl(params, shape, seed)
