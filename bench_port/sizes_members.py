"""Bytes of an ensemble's member stacks, from a configuration's shape
``[members, H, W]`` and dtypes, and the least each of its kernels and its
whole step must move: each input read once and each output written once,
whatever implements them (the layout the program steps the members in is
its own choice, and no byte of it counts)."""

from __future__ import annotations

_ITEM = {"float32": 4, "bfloat16": 2}


def cells(sim: dict) -> int:
    n, h, w = sim["shape"]
    return n * h * w


def velocity_bytes(sim: dict) -> int:
    """Every member's ``[2, H, W]`` velocity."""
    return 2 * cells(sim) * _ITEM[sim["dtype"]]


def dye_bytes(sim: dict) -> int:
    """Every member's ``[3, H, W]`` dye."""
    return 3 * cells(sim) * _ITEM[sim["color_dtype"]]


def project_bytes(sim: dict) -> int:
    """K1 ``member=``: the velocity read and written (the pressure is
    scratch; the pokes drain before it)."""
    return 2 * velocity_bytes(sim)


def advect_bytes(sim: dict) -> int:
    """K2 ``member=``, both calls: the velocity read and written; then the
    velocity and the dye read, the dye written.  The pokes' overlay is the
    program's way to drain them, and is left out."""
    vel, dye = velocity_bytes(sim), dye_bytes(sim)
    return 2 * vel + vel + 2 * dye


def step_bytes(sim: dict) -> int:
    """One step: the velocity and the dye read and written once."""
    return 2 * velocity_bytes(sim) + 2 * dye_bytes(sim)
