"""``span(name)``: a named range of the port's host code, in a
``torch.profiler`` trace or in an untraced ``record()``.

While a profiler records, ``span`` returns ``torch.profiler.
record_function(name)``: the range lands in the same trace as the CUDA
kernels, copies and runtime calls, on the profiler's one clock, so a gap
on the card can be put down to the host code that opened it.  While a
``record()`` is open and no profiler records, the spans of the thread
that opened it are stamped with ``time.perf_counter_ns`` into the
recorder's list, in memory, for the tools that measure host time without
the profiler's inflation; the benchmark's window never opens one.
Otherwise ``span`` returns one shared no-op context, and a span costs the
one check and one global read (0.1-0.4 us over an empty ``with`` on an
H100 machine's host; a recorder's stamps 1-2 us a span, the profiler's
range 10-19 us).  A bare ``record_function`` costs 7-12 us even with no
profiler recording, a share of a 1 ms step that the untraced runs would
pay.

A leaf module with no imports from the package, so that ``state.py`` and
the kernel wrappers can import it; ``utils.profiling`` re-exports it.

The spans, which the benchmark's breakdown of the card's idle time names
(``bench.step > fluid.k2.advect``):

==========================  =============================================
``fluid.impulses``          ``state.Impulses.from_lists`` and
                            ``from_member_lists`` (the padding; on the card
                            the pinned staging and its one copy, which does
                            not block the host)
``fluid.step_render``       ``models.stable_fluids.step_render``
``fluid.ensemble_step``     ``models.ensemble.make_ensemble_step``'s step
``fluid.ensemble.plan``     the supergrid step's host-only planning in
                            it (``tiled_ensemble_config``, ``_on_stack``)
``fluid.ensemble.move``     ``models.ensemble._step_super``'s move of the
                            impulses onto the state's device
``fluid.ensemble.layout``   ``models.ensemble._to_super`` and
                            ``_from_super`` (a member stack to the supergrid
                            or back; not on the kernel route, whose
                            kernels take the stack as it lies)
``fluid.ensemble.overlay``  ``ops.cuda.advect.member_overlay`` in
                            ``models.ensemble._step_super`` (the members'
                            drain as K2's overlay)
``fluid.drain``             ``ops.impulses.apply_impulses_`` (the plume's
                            drain, the 2D eager route's, K1's plain
                            version's) and ``models.ensemble.
                            _apply_member_impulses`` (the ensemble's off
                            the kernel route)
``fluid.k1.project``        ``ops.cuda.project.project_fused``
``fluid.k2.advect``         ``ops.cuda.advect.advect_kernel``
``fluid.k3.render``         ``render.cuda_upscale.render_rgb565_kernel``
``fluid.smoke_step``        ``models.smoke3d.smoke_step``
``fluid.k7.advect3d``       ``ops.cuda.advect3d.advect3d_kernel`` and
                            ``advect3d_source_kernel``
``fluid.k8.fd3d``           ``ops.cuda.fd3d.divergence3d`` and
                            ``subtract_gradient3d``
``fluid.k9.sor3d``          ``ops.cuda.sor3d.sor3d_solve``
``fluid.render``            ``render.smoke.render_smoke`` (the plume's
                            frame: its checks and glue around K10)
``fluid.k10.mip``           ``render.cuda_smoke.render_smoke_mip_kernel``
==========================  =============================================
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import NamedTuple

import torch
from torch._C._autograd import _profiler_enabled

_OFF = contextlib.nullcontext()
_recorder = None    # the open ``Recorder``, else None


def span(name: str):
    """A context that records ``name`` while a profiler records, or while
    a ``record()`` is open on this thread."""
    if _profiler_enabled():
        return torch.profiler.record_function(name)
    if _recorder is None:
        return _OFF
    return _recorder.span(name)


class SpanTotal(NamedTuple):
    """One name's spans: how many, their duration and their self time
    (the duration less the time their child spans cover), in ns."""

    calls: int
    total_ns: int
    self_ns: int


class Recorder:
    """The spans of one thread, stamped on ``clock`` (ns), kept in memory:
    ``spans`` holds ``[name, parent index or -1, start, end]`` in order of
    entry."""

    def __init__(self, clock):
        self.clock = clock
        self.thread = threading.get_ident()
        self.spans = []
        self._open = -1     # index of the innermost open span

    def span(self, name: str):
        if threading.get_ident() != self.thread:
            return _OFF
        return _Stamp(self, name)

    def totals(self) -> dict:
        """``{name: SpanTotal}`` over every span recorded."""
        covered = [0] * len(self.spans)
        for _, parent, start, end in self.spans:
            if parent >= 0:
                covered[parent] += end - start
        out = {}
        for (name, _, start, end), child in zip(self.spans, covered):
            calls, total, own = out.get(name, (0, 0, 0))
            out[name] = SpanTotal(calls + 1, total + end - start,
                                  own + end - start - child)
        return out


class _Stamp:
    """One span of a ``Recorder``: the start stamped last on entry, the
    end first on exit, so the bookkeeping counts in the parent's self
    time, not in this span."""

    __slots__ = ("rec", "name", "index")

    def __init__(self, rec: Recorder, name: str):
        self.rec, self.name = rec, name

    def __enter__(self):
        rec = self.rec
        self.index = len(rec.spans)
        entry = [self.name, rec._open, 0, 0]
        rec.spans.append(entry)
        rec._open = self.index
        entry[2] = rec.clock()

    def __exit__(self, *exc):
        rec = self.rec
        entry = rec.spans[self.index]
        entry[3] = rec.clock()
        rec._open = entry[1]


@contextlib.contextmanager
def record(clock=time.perf_counter_ns):
    """Open a ``Recorder`` for the calling thread: while it is open and no
    profiler records, that thread's spans are stamped into it.  One at a
    time; nothing is written anywhere until its reader asks."""
    global _recorder
    if _recorder is not None:
        raise RuntimeError("a span recorder is already open")
    rec = Recorder(clock)
    _recorder = rec
    try:
        yield rec
    finally:
        _recorder = None
