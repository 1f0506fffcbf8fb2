from .stable_fluids import (
    init_state,
    apply_impulses,
    step,
    make_step,
    step_render,
    make_step_render,
    make_step_with_metrics,
    make_multi_step,
    stack_schedule,
)

__all__ = [
    "init_state",
    "apply_impulses",
    "step",
    "make_step",
    "step_render",
    "make_step_render",
    "make_step_with_metrics",
    "make_multi_step",
    "stack_schedule",
]
