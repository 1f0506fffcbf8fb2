"""Bytes of the 3D smoke plume's state, pressure and frame, from a
configuration's shape and dtypes, and the least each of its kernels and
its whole step must move: each input read once and each output written
once, whatever implements them."""

from __future__ import annotations

import math

_ITEM = {"float32": 4, "bfloat16": 2}


def cells(sim: dict) -> int:
    return math.prod(sim["shape"])


def velocity_bytes(sim: dict) -> int:
    """The ``[3, D, H, W]`` velocity."""
    return 3 * cells(sim) * _ITEM[sim["dtype"]]


def scalar_bytes(sim: dict) -> int:
    """One scalar field: the density or the temperature."""
    return cells(sim) * _ITEM[sim["scalar_dtype"]]


def pressure_bytes(sim: dict) -> int:
    """The pressure, or the divergence: one field in the velocity dtype."""
    return cells(sim) * _ITEM[sim["dtype"]]


def frame_bytes(sim: dict) -> int:
    """The MIP along axis 0: ``H x W`` two-byte RGB565 words."""
    _, h, w = sim["shape"]
    return h * w * 2


def advect_bytes(sim: dict) -> int:
    """K7, both calls: the velocity read and written; then the velocity
    and both scalars read, both scalars written."""
    vel, sc = velocity_bytes(sim), scalar_bytes(sim)
    return 2 * vel + vel + 2 * sc + 2 * sc


def fd_bytes(sim: dict) -> int:
    """K8: the divergence reads the velocity and writes one field; the
    gradient subtract reads the velocity and the pressure and writes the
    velocity."""
    vel, p = velocity_bytes(sim), pressure_bytes(sim)
    return (vel + p) + (vel + p + vel)


def sor_bytes(sim: dict) -> int:
    """K9: the divergence read, the pressure written."""
    return 2 * pressure_bytes(sim)


def mip_bytes(sim: dict) -> int:
    """K10: the density read, the frame written."""
    return scalar_bytes(sim) + frame_bytes(sim)


def step_bytes(sim: dict) -> int:
    """One step and its frame: the velocity, density and temperature read
    and written once, the frame written once."""
    return (2 * velocity_bytes(sim) + 4 * scalar_bytes(sim)
            + frame_bytes(sim))
