"""The program's spans in a trace's summary, as the span readers
(``metrics/entry.host_us.py`` and its kin) take them: which names are
the program's, its kernel wrappers' and its feed's, and the host time an
interval list covers, alone or where it meets another.

Every list is ``[start_s, end_s]`` pairs on the trace's clock, merged
with ``tracing._union``; spans of one thread nest, so the union of a set
of names counts a nested stretch once."""

import re

from bench_port.tracing import _union

PROGRAM = "fluid."
FEED = "fluid.impulses"
# the kernel wrappers' spans (checks, allocation, launch): K1-K11 and the
# ensemble's overlay build, one launch of its own
WRAPPER = re.compile(r"fluid\.k\d+\.|fluid\.ensemble\.overlay$")


def merged(summary: dict, pick) -> list:
    """The union of the spans whose name ``pick`` takes."""
    return _union([iv for name, ivs in summary.get("spans", {}).items()
                   if pick(name) for iv in ivs])


def program(name: str) -> bool:
    return name.startswith(PROGRAM)


def wrapper(name: str) -> bool:
    return WRAPPER.match(name) is not None


def length(ivs) -> float:
    return sum(e - s for s, e in ivs)


def overlap(a, b) -> float:
    """The time two merged lists share."""
    i = j = 0
    shared = 0.0
    while i < len(a) and j < len(b):
        shared += max(0.0, min(a[i][1], b[j][1]) - max(a[i][0], b[j][0]))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return shared


def per_step_us(summary: dict, seconds: float):
    """``seconds`` of the traced stretch as microseconds a traced step."""
    return 1e6 * seconds / summary["steps"] if summary["steps"] else None
