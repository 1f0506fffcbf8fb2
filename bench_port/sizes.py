"""Bytes of the dye bed's state and frame, from a configuration's shapes
and dtypes: the least a step must move, whatever implements it."""

from __future__ import annotations

_ITEM = {"float32": 4, "bfloat16": 2}


def velocity_bytes(sim: dict) -> int:
    h, w = sim["shape"]
    return 2 * h * w * _ITEM[sim["dtype"]]


def dye_bytes(sim: dict) -> int:
    h, w = sim["shape"]
    return 3 * h * w * _ITEM[sim["color_dtype"]]


def frame_bytes(sim: dict, scaling: int) -> int:
    """The RGB565 frame: ``(H-1)*s x (W-1)*s`` two-byte words."""
    h, w = sim["shape"]
    return (h - 1) * scaling * (w - 1) * scaling * 2


def step_bytes(sim: dict, scaling: int) -> int:
    """One step: the velocity and dye read once, the velocity, dye and
    frame written once."""
    return (2 * velocity_bytes(sim) + 2 * dye_bytes(sim)
            + frame_bytes(sim, scaling))
