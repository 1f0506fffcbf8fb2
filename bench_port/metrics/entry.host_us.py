"""Host microseconds a traced step inside any of the program's spans
(the union of ``fluid.*``): the program's whole dispatch of the feed and
the step, its kernel wrappers, eager ops and glue.  Under the profiler,
which inflates host time; None where the program opens no span."""

from bench_port.program_spans import length, merged, per_step_us, program


def read(summary: dict, ctx: dict):
    spans = merged(summary, program)
    return per_step_us(summary, length(spans)) if spans else None
