"""Host microseconds a traced step inside the kernel wrappers' spans
(``fluid.k1.`` ... ``fluid.k10.``, ``fluid.ensemble.overlay``): their
checks, allocations and launches.  Under the profiler, which inflates
host time; None where no wrapper's span is open."""

from bench_port.program_spans import length, merged, per_step_us, wrapper


def read(summary: dict, ctx: dict):
    spans = merged(summary, wrapper)
    return per_step_us(summary, length(spans)) if spans else None
