"""Host microseconds a traced step inside the impulse drain's span
(``fluid.drain``: ``apply_impulses_``, the ensemble's scatter off the
kernel route), the ~20 small eager ops that write the drag queue into
the velocity.  Under the profiler, which inflates host time; None where
the program opens no such span (a drain that K1 or K2's overlay does)."""

from bench_port.program_spans import length, merged, per_step_us


def read(summary: dict, ctx: dict):
    spans = merged(summary, lambda name: name == "fluid.drain")
    return per_step_us(summary, length(spans)) if spans else None
