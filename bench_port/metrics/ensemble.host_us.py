"""Host microseconds a traced step inside the ensemble step's span
(``fluid.ensemble_step``) and outside its kernel wrappers' (``fluid.k1``,
``fluid.k2``): the dispatch of the layout conversions, of the drain's
overlay and of the step itself.  Under the profiler, which inflates host
time; None where the program opens no such span."""

from bench_port.tracing import _union

STEP = "fluid.ensemble_step"
WRAPPERS = ("fluid.k1.", "fluid.k2.")


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
