"""Microseconds a traced step in which the card is idle (no kernel, copy
or set; the complement of ``busy``) while the host is inside one of the
program's spans (the union of ``fluid.*``): the card waiting on the
program's own host code, not on the harness's traffic, event or
synchronise.  None where the program opens no span."""

from bench_port.program_spans import (length, merged, overlap, per_step_us,
                                      program)


def read(summary: dict, ctx: dict):
    spans = merged(summary, program)
    if not spans:
        return None
    busy = summary.get("busy", [])
    return per_step_us(summary, length(spans) - overlap(spans, busy))
