"""The swirl generator: a ring of tangential pokes that turns every step.

The arithmetic of the program's scripted swirl (``io_host/touch.py``,
``scripted_swirl``), kept here so that the yardstick cannot move with the
program: ``n_points`` pokes on a ring of radius ``radius_frac * min(H, W)``
around the grid centre, the ring turned by ``turn_rad`` a step, each poke
at ``speed`` cells/s along the ring's tangent.  The seed draws the ring's
starting angle, so every seed sends the same number of pokes at the same
speed, in other places.  The program receives only the plain numbers.
"""

from __future__ import annotations

import math
import random


class Swirl:
    def __init__(self, params: dict, shape, seed: int):
        self.h, self.w = int(shape[-2]), int(shape[-1])
        self.n = int(params["n_points"])
        self.radius = params["radius_frac"] * min(self.h, self.w)
        self.turn = float(params["turn_rad"])
        self.speed = float(params["speed"])
        self.phase0 = random.Random(f"swirl/{seed}").uniform(0.0, 2 * math.pi)

    def step(self, t: int):
        """``(positions, velocities)`` for step ``t``: lists of
        ``(i, j)`` cell indices and ``(v_i, v_j)`` in cells/s."""
        ci, cj = self.h / 2.0, self.w / 2.0
        phase = self.phase0 + self.turn * t
        pos, vel = [], []
        for k in range(self.n):
            a = phase + 2 * math.pi * k / self.n
            i = int(round(ci + self.radius * math.sin(a)))
            j = int(round(cj + self.radius * math.cos(a)))
            pos.append((min(max(i, 0), self.h - 1), min(max(j, 0), self.w - 1)))
            vel.append((self.speed * math.cos(a), -self.speed * math.sin(a)))
        return pos, vel


def make(params: dict, shape, seed: int) -> Swirl:
    return Swirl(params, shape, seed)
