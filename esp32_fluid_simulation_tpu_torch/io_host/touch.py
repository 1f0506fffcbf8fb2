"""Touch-input semantics: raw touch points -> drag velocities -> impulses
(counterpart of ``esp32_fluid_simulation_tpu/io_host/touch.py``).

Host-side pure Python, as in the JAX package: the calibration map from the
raw 4096x4096 touch domain into grid coords (``.ino:18-21, 77-78``), the
drag state machine (``.ino:80-86``), the graphics->sim x/y swap
(``.ino:258-267``), and ``scripted_swirl``, the deterministic impulse
schedule benchmarks and parity runs feed the step.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence, Tuple

import numpy as np

from ..config import SimConfig
from ..state import Impulses

# Reference constants (.ino:17-21).
POLLING_PERIOD_MS = 10
TOUCH_MIN_X, TOUCH_MAX_X = 200, 3700
TOUCH_MIN_Y, TOUCH_MAX_Y = 240, 3800


def _arduino_map(x: int, in_min: int, in_max: int, out_min: int,
                 out_max: int) -> int:
    """Arduino integer ``map()`` (truncating division), as used at .ino:77-78."""
    return (x - in_min) * (out_max - out_min) // (in_max - in_min) + out_min


@dataclasses.dataclass(frozen=True)
class TouchCalibration:
    min_x: int = TOUCH_MIN_X
    max_x: int = TOUCH_MAX_X
    min_y: int = TOUCH_MIN_Y
    max_y: int = TOUCH_MAX_Y
    polling_period_ms: int = POLLING_PERIOD_MS

    def to_grid(self, raw_x: int, raw_y: int, cfg: SimConfig):
        """Raw ADC point -> graphics-frame grid coords (.ino:77-78)."""
        h, w = cfg.shape[-2], cfg.shape[-1]
        gx = _arduino_map(raw_x, self.min_x, self.max_x, 0, w)
        gy = _arduino_map(raw_y, self.min_y, self.max_y, 0, h)
        return gx, gy


def drags_from_touch_trace(
    trace: Sequence[Tuple[bool, int, int]],
    cfg: SimConfig,
    cal: TouchCalibration = TouchCalibration(),
):
    """Poll trace ``[(touched, raw_x, raw_y), ...]`` -> drag events
    ``[(coords_xy, velocity_xy), ...]`` in graphics frame; a drag is emitted
    only when the previous poll was also touched (``.ino:80-92``)."""
    drags = []
    last = None
    for touched, rx, ry in trace:
        if touched:
            gx, gy = cal.to_grid(rx, ry, cfg)
            if last is not None:
                dx, dy = gx - last[0], gy - last[1]
                scale = 1000.0 / cal.polling_period_ms
                drags.append(((gx, gy), (dx * scale, dy * scale)))
            last = (gx, gy)
        else:
            last = None
    return drags


def drags_to_impulses(drags, cfg: SimConfig, device="cuda") -> Impulses:
    """Graphics-frame drags -> sim-frame impulses: swap x/y for both the cell
    index and the velocity (``.ino:264-268``)."""
    pos = [(gy, gx) for (gx, gy), _ in drags]
    vel = [(vy, vx) for _, (vx, vy) in drags]
    return Impulses.from_lists(cfg, pos, vel, device=device)


def scripted_swirl(cfg: SimConfig, t_step: int, n_points: int = 8,
                   speed: float = 300.0, device="cuda") -> Impulses:
    """A rotating ring of tangential pokes around the grid center (the
    scripted stand-in for a finger swirl)."""
    pos, vel = swirl_lists(cfg, t_step, n_points, speed)
    return Impulses.from_lists(cfg, pos, vel, device=device)


def swirl_lists(cfg: SimConfig, t_step: int, n_points: int = 8,
                speed: float = 300.0):
    """``scripted_swirl``'s pokes as ``(positions, velocities)`` lists."""
    h, w = cfg.shape[-2], cfg.shape[-1]
    ci, cj = h / 2.0, w / 2.0
    r = 0.3 * min(h, w)
    phase = 0.15 * t_step
    pos, vel = [], []
    for k in range(n_points):
        a = phase + 2 * math.pi * k / n_points
        i = int(round(ci + r * math.sin(a)))
        j = int(round(cj + r * math.cos(a)))
        vi = speed * math.cos(a)
        vj = -speed * math.sin(a)
        pos.append((np.clip(i, 0, h - 1), np.clip(j, 0, w - 1)))
        vel.append((vi, vj))
    return pos, vel
