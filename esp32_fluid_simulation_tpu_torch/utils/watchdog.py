"""Failure detection and recovery (counterpart of
``esp32_fluid_simulation_tpu/utils/watchdog.py:24-49``).

The reference has none (crashes acknowledged in ``README.md:11``); SOR with
omega=1.96 can go unstable if forcing violates its assumptions.  The
guarded step checks the new state's finiteness on the device and, where it
fails, resets to the initial condition, with no host round-trip: the flag
selects between the two states through ``torch.where``, as ``lax.cond``
does in JAX.  Fault injection (salting the state with NaN) is exercised in
``tests/test_torch_host.py``.
"""

from __future__ import annotations

import torch

from ..config import SimConfig
from ..state import SimState, Impulses
from ..models.stable_fluids import step, init_color


def make_guarded_step(cfg: SimConfig, donate: bool = True):
    """Step that detects a non-finite state after the update and resets to
    the initial condition (velocity zero, sector dye) in that case.

    Returns ``(new_state, was_reset)``, ``was_reset`` a 0-dim bool tensor
    on the state's device (reading it is the caller's sync, not the
    step's).  The initial dye is built once per device.  ``donate`` is
    accepted for the JAX signature and has no effect on eager code."""
    del donate
    fresh = {}

    def guarded(state: SimState, impulses: Impulses):
        new = step(state, impulses, cfg)
        dev = new.velocity.device
        if dev not in fresh:
            fresh[dev] = init_color(cfg, dev)
        ok = torch.isfinite(new.velocity).all() & torch.isfinite(
            new.color).all()
        vel = torch.where(ok, new.velocity, new.velocity.new_zeros(()))
        color = torch.where(ok, new.color, fresh[dev].to(new.color.dtype))
        return SimState(velocity=vel, color=color, step=new.step), ~ok

    return guarded
