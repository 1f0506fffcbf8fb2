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

==========================  =============================================
``fluid.impulses``          ``state.Impulses.from_lists`` and
                            ``from_member_lists`` (the padding; on the card
                            the pinned staging and its one copy, which does
                            not block the host)
``fluid.step_render``       ``models.stable_fluids.step_render``
``fluid.ensemble_step``     ``models.ensemble.make_ensemble_step``'s step
``fluid.ensemble.layout``   ``models.ensemble._to_super`` and
                            ``_from_super`` (a member stack to the supergrid
                            or back; not on the kernel route, whose
                            kernels take the stack as it lies)
``fluid.ensemble.overlay``  ``ops.cuda.advect.member_overlay`` in
                            ``models.ensemble._step_super`` (the members'
                            drain as K2's overlay)
``fluid.k1.project``        ``ops.cuda.project.project_fused``
``fluid.k2.advect``         ``ops.cuda.advect.advect_kernel``
``fluid.k3.render``         ``render.cuda_upscale.render_rgb565_kernel``
``fluid.smoke_step``        ``models.smoke3d.smoke_step``
``fluid.k7.advect3d``       ``ops.cuda.advect3d.advect3d_kernel`` and
                            ``advect3d_source_kernel``
``fluid.k8.fd3d``           ``ops.cuda.fd3d.divergence3d`` and
                            ``subtract_gradient3d``
``fluid.k9.sor3d``          ``ops.cuda.sor3d.sor3d_solve``
``fluid.k10.mip``           ``render.cuda_smoke.render_smoke_mip_kernel``
==========================  =============================================
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
