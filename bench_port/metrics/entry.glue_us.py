"""Host microseconds a traced step inside the program's spans
(``fluid.*``) and outside its kernel wrappers' (``fluid.k1.`` ...
``fluid.k10.``, ``fluid.ensemble.overlay``) and the feed's
(``fluid.impulses``): the step's own Python and eager glue, the drain and
the frame's glue among it.  Under the profiler, which inflates host time;
None where the program opens no span."""

from bench_port.program_spans import (FEED, length, merged, overlap,
                                      per_step_us, program, wrapper)


def read(summary: dict, ctx: dict):
    spans = merged(summary, program)
    if not spans:
        return None
    inner = merged(summary, lambda name: wrapper(name) or name == FEED)
    return per_step_us(summary, length(spans) - overlap(spans, inner))
