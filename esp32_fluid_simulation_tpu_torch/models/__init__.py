from .stable_fluids import (
    init_state,
    apply_impulses,
    step,
    make_step,
    step_render,
    make_step_render,
    step_with_metrics,
    make_step_with_metrics,
    make_multi_step,
    stack_schedule,
)
from .smoke3d import (
    SmokeConfig,
    SmokeState,
    init_smoke,
    smoke_step,
    make_smoke_step,
)

__all__ = [
    "init_state",
    "apply_impulses",
    "step",
    "make_step",
    "step_render",
    "make_step_render",
    "step_with_metrics",
    "make_step_with_metrics",
    "make_multi_step",
    "stack_schedule",
    "SmokeConfig",
    "SmokeState",
    "init_smoke",
    "smoke_step",
    "make_smoke_step",
]
