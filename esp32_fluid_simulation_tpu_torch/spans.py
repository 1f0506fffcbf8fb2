"""``span(name)``: a named range of the port's host code in a
``torch.profiler`` trace.

While a profiler records, ``span`` returns ``torch.profiler.
record_function(name)``: the range lands in the same trace as the CUDA
kernels, copies and runtime calls, on the profiler's one clock, so a gap
on the card can be put down to the host code that opened it.  Otherwise it
returns one shared no-op context, and a span costs the one check (about
0.3-0.5 us on an H100 machine's host).  A bare ``record_function`` costs
7-12 us even with no profiler recording, a share of a 1 ms step that the
untraced runs would pay.

A leaf module with no imports from the package, so that ``state.py`` and
the kernel wrappers can import it; ``utils.profiling`` re-exports it.

The spans, which the benchmark's breakdown of the card's idle time names
(``bench.step > fluid.k2.advect``):

=====================  =============================================
``fluid.impulses``     ``state.Impulses.from_lists``
``fluid.step_render``  ``models.stable_fluids.step_render``
``fluid.k1.project``   ``ops.cuda.project.project_fused``
``fluid.k2.advect``    ``ops.cuda.advect.advect_kernel``
``fluid.k3.render``    ``render.cuda_upscale.render_rgb565_kernel``
=====================  =============================================
"""

from __future__ import annotations

import contextlib

import torch
from torch._C._autograd import _profiler_enabled

_OFF = contextlib.nullcontext()


def span(name: str):
    """A context that records ``name`` while a profiler records."""
    if _profiler_enabled():
        return torch.profiler.record_function(name)
    return _OFF
