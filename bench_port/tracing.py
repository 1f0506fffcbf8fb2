"""One profiler trace of a short stretch of steps, reduced to a summary
that the per-layer readers (``metrics/*.py``) and the breakdown read.

The stretch is traced with ``torch.profiler`` (CPU and CUDA activity), a
few steps of warm-up first so that the profiler's own start-up falls
outside what is kept.  The Chrome trace goes to a temporary file, is read
back and deleted.  One trace per process, taken last: after one trace,
later short traces have been seen to miss device events.

The harness wraps its calls in spans (``record_function``):
``bench.traffic`` (the generator), ``bench.feed`` (the program turning
the traffic's lists into its input), ``bench.step`` (the program's step),
``bench.event`` (the end-of-step event) and ``bench.sync``.  The
program's own spans (``fluid.*``) nest inside them; the summary keeps
every span by name, with the CUDA runtime calls and the card's busy
intervals, for readers that intersect them.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
PROGRAM_SPANS = ("bench.feed", "bench.step")
PROFILER_STEP = "ProfilerStep#"   # the profiler's own span of each step
BREAKDOWN_ENTRIES = 10


def capture(body, n_warm: int, n_active: int, cuda: bool) -> dict:
    """Trace ``body(i)`` for ``n_warm`` + ``n_active`` steps, keep the
    last ``n_active``, and return ``summarize`` of them."""
    from torch.profiler import ProfilerActivity, profile, schedule

    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        with profile(activities=activities,
                     schedule=schedule(wait=0, warmup=n_warm,
                                       active=n_active, repeat=1),
                     on_trace_ready=lambda p: p.export_chrome_trace(path)
                     ) as prof:
            for i in range(n_warm + n_active):
                body(i)
                prof.step()
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    return summarize(events, n_active)


def _union(intervals):
    """Sorted, merged ``[start, end)`` pairs."""
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def _inside(t, merged, starts) -> bool:
    k = bisect.bisect_right(starts, t) - 1
    return k >= 0 and t <= merged[k][1]


def _labels(host, times):
    """For each of the sorted ``times``, what the host was doing: the
    innermost host event that contains it, under the outermost ``bench.``
    span that does.  ``host`` is sorted by start, outer events first; one
    thread's events nest, so a stack holds those that contain the time."""
    labels, stack, i = [], [], 0
    for t in times:
        while i < len(host) and host[i][1] <= t:
            while stack and stack[-1][2] < host[i][1]:
                stack.pop()
            stack.append(host[i])
            i += 1
        while stack and stack[-1][2] < t:
            stack.pop()
        if not stack:
            labels.append("host: no op")
            continue
        inner = stack[-1][0]
        span = next((h[0] for h in stack if h[0].startswith("bench.")), None)
        labels.append(inner if span in (None, inner) else f"{span} > {inner}")
    return labels


def summarize(events, steps: int) -> dict:
    """The trace as plain lists and totals (seconds), for ``steps`` steps:
    ``kernels`` (name, seconds, whether an ATen op launched it),
    ``device`` (every kernel, copy and set), ``runtime`` (CUDA runtime
    calls and whether the program's span made them), ``window_s``,
    ``busy_s`` (the union of device intervals), ``device_ops`` and
    ``idle_gaps`` (the breakdown); and ``spans`` (every span, the
    harness's and the program's, by name), ``calls`` (every CUDA runtime
    and driver call, by name) and ``busy`` (the union of device
    intervals), each as ``[start_s, end_s]`` pairs in seconds from the
    start of the stretch, on the trace's clock."""
    dev, host, runtime_at = [], [], {}
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat = e.get("cat")
        s = float(e["ts"])
        end = s + float(e["dur"])
        corr = (e.get("args") or {}).get("correlation")
        if cat in DEVICE_CATS:
            dev.append((e["name"], cat, s, end, corr))
        elif cat in HOST_CATS:
            host.append((e["name"], s, end, cat))
            if cat in ("cuda_runtime", "cuda_driver") and corr is not None:
                runtime_at[corr] = s
    host.sort(key=lambda h: (h[1], -h[2]))
    if not host and not dev:
        return {"steps": steps, "kernels": [], "device": [], "runtime": [],
                "window_s": 0.0, "busy_s": 0.0, "device_ops": [],
                "idle_gaps": [], "spans": {}, "calls": {}, "busy": []}
    lo = min([h[1] for h in host] + [d[2] for d in dev])
    hi = max([h[2] for h in host] + [d[3] for d in dev])

    aten = _union([(s, e) for name, s, e, cat in host
                   if cat == "cpu_op" and name.startswith("aten::")])
    aten_starts = [m[0] for m in aten]
    spans = _union([(s, e) for name, s, e, cat in host
                    if name in PROGRAM_SPANS])
    span_starts = [m[0] for m in spans]

    kernels = []
    for name, cat, s, e, corr in dev:
        if cat != "kernel":
            continue
        launched = runtime_at.get(corr)
        eager = launched is not None and _inside(launched, aten, aten_starts)
        kernels.append({"name": name, "seconds": (e - s) * 1e-6,
                        "eager": eager})
    runtime = [{"name": name, "in_program": _inside(s, spans, span_starts)}
               for name, s, e, cat in host
               if cat in ("cuda_runtime", "cuda_driver")]

    busy = _union([(s, e) for _, _, s, e, _ in dev])
    busy_us = sum(e - s for s, e in busy)
    by_op = defaultdict(float)
    for name, _, s, e, _ in dev:
        by_op[name] += (e - s) * 1e-6

    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    pairs = [(s, e) for s, e in zip(edges[0::2], edges[1::2]) if e > s]
    gaps = defaultdict(float)
    for (s, e), label in zip(pairs, _labels(host, [(s + e) / 2
                                                   for s, e in pairs])):
        gaps[label] += (e - s) * 1e-6

    def since(s, e):
        return [(s - lo) * 1e-6, (e - lo) * 1e-6]

    spans_by_name, calls = defaultdict(list), defaultdict(list)
    for name, s, e, cat in host:
        if cat == "user_annotation" and not name.startswith(PROFILER_STEP):
            spans_by_name[name].append(since(s, e))
        elif cat in ("cuda_runtime", "cuda_driver"):
            calls[name].append(since(s, e))

    def top(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])
                [:BREAKDOWN_ENTRIES]]

    return {"steps": steps, "kernels": kernels,
            "device": [{"name": name, "cat": cat, "seconds": (e - s) * 1e-6}
                       for name, cat, s, e, _ in dev],
            "runtime": runtime, "window_s": (hi - lo) * 1e-6,
            "busy_s": busy_us * 1e-6, "device_ops": top(by_op),
            "idle_gaps": top(gaps), "spans": dict(spans_by_name),
            "calls": dict(calls), "busy": [since(s, e) for s, e in busy]}
