"""Host microseconds a traced step inside the plume step's span
(``fluid.smoke_step``) and outside its kernel wrappers' (``fluid.k7``,
``fluid.k8``, ``fluid.k9``): the dispatch of the step's eager ops (the
stack of the scalars, the source and buoyancy, the impulse drain) and of
the step itself.  Under the profiler, which inflates host time; None
where the program opens no such span."""

from bench_port.tracing import _union

STEP = "fluid.smoke_step"
WRAPPERS = ("fluid.k7.", "fluid.k8.", "fluid.k9.")


def read(summary: dict, ctx: dict):
    spans = summary.get("spans", {})
    step = _union(spans.get(STEP, []))
    if not step or not summary["steps"]:
        return None
    wrappers = _union([iv for name, ivs in spans.items()
                       if name.startswith(WRAPPERS) for iv in ivs])
    # both lists are merged, so the pairwise overlaps add up exactly
    covered = sum(max(0.0, min(e, f) - max(s, g))
                  for s, e in step for g, f in wrappers)
    inside = sum(e - s for s, e in step) - covered
    return 1e6 * inside / summary["steps"]
