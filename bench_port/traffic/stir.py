"""The stir generator: a horizontal ring of tangential pokes around a 3D
plume's vertical axis, turning every step.

``n_points`` pokes on a ring of radius ``radius_frac * min(H, W)`` in the
plane ``z = round(height_frac * D)`` (axis 0 is vertical), centred on the
(i, j) centre of the grid, where the plume's source sits; each poke at
``speed`` cells/s along the ring's tangent, with no vertical component;
the ring turned by ``turn_rad`` a step.  The seed draws the ring's
starting angle, so every seed sends the same number of pokes at the same
speed, in other places.  The program receives only the plain numbers.
"""

from __future__ import annotations

import math
import random


class Stir:
    def __init__(self, params: dict, shape, seed: int):
        self.d, self.h, self.w = (int(n) for n in shape)
        self.n = int(params["n_points"])
        self.radius = params["radius_frac"] * min(self.h, self.w)
        self.z = min(max(int(round(params["height_frac"] * self.d)), 0),
                     self.d - 1)
        self.turn = float(params["turn_rad"])
        self.speed = float(params["speed"])
        self.phase0 = random.Random(f"stir/{seed}").uniform(0.0, 2 * math.pi)

    def step(self, t: int):
        """``(positions, velocities)`` for step ``t``: lists of
        ``(z, i, j)`` cell indices and ``(v_z, v_i, v_j)`` in cells/s."""
        ci, cj = self.h / 2.0, self.w / 2.0
        phase = self.phase0 + self.turn * t
        pos, vel = [], []
        for k in range(self.n):
            a = phase + 2 * math.pi * k / self.n
            i = int(round(ci + self.radius * math.sin(a)))
            j = int(round(cj + self.radius * math.cos(a)))
            pos.append((self.z, min(max(i, 0), self.h - 1),
                        min(max(j, 0), self.w - 1)))
            vel.append((0.0, self.speed * math.cos(a),
                        -self.speed * math.sin(a)))
        return pos, vel


def make(params: dict, shape, seed: int) -> Stir:
    return Stir(params, shape, seed)
