"""Debug-mode step: NaN/Inf localization (counterpart of
``esp32_fluid_simulation_tpu/utils/debug.py``, which instruments the step
with ``checkify``'s float checks).

The watchdog (``utils/watchdog.py``) detects and recovers in production;
this step instead *localizes* the first non-finite value to the stage of
``step`` that produced it, for debugging blowups (e.g. omega=1.96 with a
violated dt/forcing envelope).  Each stage's check is a host sync, so it
is for debug runs only.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..config import SimConfig
from ..state import SimState, Impulses
from ..models.stable_fluids import (_advect_by, _advect_color,
                                    _impulses_and_forces, _on_device,
                                    _project)


class StepError:
    """What ``checked`` found: ``get()`` names the first stage whose output
    was not finite (None when every stage was), ``throw()`` raises it."""

    def __init__(self, message: Optional[str] = None):
        self.message = message

    def get(self) -> Optional[str]:
        return self.message

    def throw(self) -> None:
        if self.message is not None:
            raise FloatingPointError(self.message)


def make_checked_step(cfg: SimConfig):
    """Returns ``checked(state, impulses) -> (error, new_state)``; call
    ``error.throw()`` (or inspect ``error.get()``) after the step.

    The stages of ``step`` run one by one and each output is checked:
    the velocity self-advect, the impulses (and confinement), the
    projection, the dye advect.  The drag queue is scattered before the
    projection (K1, where the config fuses it, runs without impulses), as
    in ``step_with_metrics``.  A ``domain_tile`` config is refused."""
    if cfg.domain_tile is not None:
        raise NotImplementedError("make_checked_step does not split the "
                                  "tiled-domain step into stages")

    def checked(state: SimState, impulses: Impulses):
        impulses = _on_device(impulses, state.velocity.device)
        adv = _advect_by(cfg, state.velocity)
        error = None

        def check(stage, t):
            nonlocal error
            if error is None and not bool(torch.isfinite(t).all()):
                error = (f"non-finite {stage} output at step "
                         f"{state.step + 1}")

        vel = adv(state.velocity, state.velocity, cfg.dt, no_slip=True)
        check("self-advect", vel)
        vel = _impulses_and_forces(vel, impulses, cfg)
        check("impulses", vel)
        vel = _project(vel, cfg)
        check("projection", vel)
        color = _advect_color(adv, state.color, vel, cfg)
        check("dye", color)
        return StepError(error), SimState(velocity=vel, color=color,
                                          step=state.step + 1)

    return checked
