"""The harness shared by every cell: the lookup by name, set-up, the timed
window, the traced stretch, the comparison with the plain reference and
the result line.  It names no configuration, entry, output or metric:
each is a file of its own under this directory, found by the names in
``BENCHMARK.json``, so that a new cell, entry or reader is new files and
new entries of ``BENCHMARK.json`` only.

The files a cell brings (where another cell has one already, it is
shared):

* ``configs/<config>.json``: the program's settings (``sim``, with its
  ``shape``) and the ``entry`` that runs them, with the source and every
  change from it;
* ``traffic/<mix>.json``: the ``generator``, its parameters and the
  render ``scaling`` the user asks for; ``traffic/<generator>.py`` has
  ``make(params, shape, seed)``, whose ``step(t)`` gives step ``t``'s
  traffic as a tuple of lists of plain numbers;
* ``entries/<entry>.py``: the program under test;
* ``reference/<entry>.py``: the plain PyTorch step it is compared with;
* ``limits/<cell>.json``: the limit of each number compared, with the
  readings it was set from (``readings.py``);
* ``metrics/<metric>.py``: one reader per per-layer metric.

An entry module has ``build(sim, scaling, device)``, which makes the
program's state on the device and returns an object with
``feed(*lists)`` (the program's input for a step, made from the
traffic's lists), ``step(fed)``, ``inputs()`` (the tensors the next step
reads, by name), ``outputs()`` (the tensors the last step produced, by
name) and, where the program counts what it launches, ``counters()``
(running totals, by name); and ``cpu_sim(sim)``: the same settings at a
shape that the CPU self-test can hold.

A reference module has ``NUMBERS`` (each number that ``compare`` returns,
with the output that it judges); ``step(inputs, *lists, sim, scaling,
lower=False)``, the outputs of one step from the program's stored inputs,
by the names of ``outputs()``; ``compare(got, want)``, the numbers, 0 for
an exact match and larger the worse; and ``lower_state(inputs, sim)``,
the program's stored inputs as the control stores them, one precision
down, for ``step(..., lower=True)`` to start from (``readings.py``).

A reader has ``read(summary, ctx)``, which returns a number, or None
where it finds nothing to read.  ``summary`` is ``tracing.summarize``'s
(kernels, device operations, runtime calls, the spans, calls and busy
intervals by name on the trace's clock, the breakdown), with
``counters``: the entry's counters a step over the traced stretch.
``ctx`` holds ``sim``, ``scaling``, ``step_s`` (host-clock seconds a step
of the untraced window) and ``hbm_bytes_per_s`` (the card's published
bandwidth, None for a card that ``peaks`` does not list).

The window is a closed loop with one caller: take the traffic's lists for
step ``t``, let the program turn them into its input, step, record an
end-of-step event from a pool made at set-up.  At a few moments drawn
from the seed the step's input and output are copied aside; once the
window has closed and the program's state is freed, the reference steps
each copied input and the outputs are compared.
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import math
import random
import statistics
import sys
import time
from pathlib import Path

import torch

from bench_port import peaks, tracing

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
N_SAMPLES = 6            # steps of the window compared with the reference
WARM_STEPS = 3           # steps run before the pool of events is sized
RATE_STEPS = 5           # steps timed to size the pool
TRACE_WARM = 3           # profiler warm-up steps, not kept
TRACE_SECONDS = 0.25     # about this many seconds of steps are traced
TRACE_STEPS = (20, 250)  # fewest and most steps traced
# modules that no run may hold: JAX, and the JAX package the port was made
# from, compared by whole top-level names (the port's name begins with it)
BANNED_MODULES = ("jax", "jaxlib", "flax", "esp32_fluid_simulation_tpu")


def load_module(path: Path):
    spec = importlib.util.spec_from_file_location(
        "bench_port_" + path.stem.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _read_json(path: Path):
    with open(path) as f:
        return json.load(f)


def find_cell(name: str, benchmark: dict | None = None) -> dict:
    """Everything a run of cell ``name`` needs, read from its files."""
    bench = benchmark or _read_json(ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; known: "
                         f"{', '.join(sorted(cells))}")
    cell = cells[name]
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])

    def mine(metrics):
        return [m for m in metrics if name in m.get("workloads", [name])]

    return {"name": name, "chips": cell["chips"],
            "config": _read_json(ROOT / conf["file"]),
            "traffic": _read_json(BENCH / "traffic"
                                  / f"{cell['traffic']}.json"),
            "limits": _read_json(BENCH / "limits"
                                 / f"{name}.json")["limits"],
            "end_to_end": mine(bench["end_to_end"]),
            "per_layer": mine(bench["per_layer"])}


class CudaClock:
    """The card: its device, events, synchronise and memory peak."""

    cuda = True

    def __init__(self):
        self.device = torch.device("cuda", 0)

    def event(self):
        return torch.cuda.Event(enable_timing=True)

    @staticmethod
    def ms(a, b) -> float:
        return a.elapsed_time(b)

    def sync(self):
        torch.cuda.synchronize(self.device)

    def peak_bytes(self) -> int:
        return torch.cuda.max_memory_allocated(self.device)

    def release(self):
        torch.cuda.empty_cache()

    def kind(self) -> str:
        return torch.cuda.get_device_name(self.device)


def _span(name, on):
    return torch.profiler.record_function(name) if on else (
        contextlib.nullcontext())


class Driver:
    """The program under one cell's traffic: the steps of the window, the
    copies of the sampled steps and the end-of-step events."""

    def __init__(self, entry, gen, clock):
        self.entry, self.gen, self.clock = entry, gen, clock
        self.t = 0
        self.pool = []
        self.buffers = []
        self.samples = []   # the traffic's lists of each copied step

    def one(self, spans=False, copy_to=None):
        """One step; with ``copy_to`` its input and output go there."""
        with _span("bench.traffic", spans):
            lists = self.gen.step(self.t)
        with _span("bench.feed", spans):
            fed = self.entry.feed(*lists)
        if copy_to is not None:
            for k, v in self.entry.inputs().items():
                copy_to["in"][k].copy_(v)
        with _span("bench.step", spans):
            self.entry.step(fed)
        if copy_to is not None:
            for k, v in self.entry.outputs().items():
                copy_to["out"][k].copy_(v)
        return lists

    def allocate(self, n: int):
        """Room for ``n`` copied steps, shaped as the entry's tensors."""
        def like(d):
            return {k: torch.empty_like(v) for k, v in d.items()}
        self.buffers = [{"in": like(self.entry.inputs()),
                         "out": like(self.entry.outputs())}
                        for _ in range(n)]

    def window(self, seconds: float, marks=(), max_steps=None):
        """Steps until ``seconds`` have passed (or ``max_steps``), copying
        the step issued first after each fraction of ``marks``.  Returns
        the steps, the wall seconds to the final synchronise, and the
        interval before each end-of-step event (ms)."""
        clock, pool = self.clock, self.pool
        marks = sorted(marks)
        start = clock.event()
        n, k = 0, 0
        t0 = time.perf_counter()
        deadline = t0 + seconds
        start.record()
        while max_steps is None or n < max_steps:
            now = time.perf_counter()
            if now >= deadline:
                break
            copy_to = None
            if k < len(marks) and now >= t0 + marks[k] * seconds:
                copy_to = self.buffers[k]
            lists = self.one(copy_to=copy_to)
            if copy_to is not None:
                self.samples.append(lists)
                k += 1
            if n == len(pool):
                pool.append(clock.event())
            pool[n].record()
            n += 1
            self.t += 1
        clock.sync()
        wall = time.perf_counter() - t0
        intervals = [clock.ms(start, pool[0])] if n else []
        intervals += [clock.ms(pool[i - 1], pool[i]) for i in range(1, n)]
        return n, wall, intervals

    def traced(self, n_active: int):
        """The profiler's summary of ``n_active`` steps after its warm-up,
        with the entry's counters a step over those steps and the warm-up
        as ``counters``."""
        last = TRACE_WARM + n_active - 1
        clock = self.clock

        def body(i):
            self.one(spans=True)
            with _span("bench.event", True):
                self.pool[i % len(self.pool)].record()
            if i == last:
                with _span("bench.sync", True):
                    clock.sync()
            self.t += 1

        counters = getattr(self.entry, "counters", dict)
        before = counters()
        summary = tracing.capture(body, TRACE_WARM, n_active, clock.cuda)
        steps = TRACE_WARM + n_active
        launched = {k: (v - before[k]) / steps
                    for k, v in counters().items()}
        traced = {}
        for k in summary["kernels"]:
            traced[k["name"]] = traced.get(k["name"], 0) + 1 / n_active
        print(f"trace: {n_active} steps; the program's launch counters a "
              f"step {launched}; kernels a step in the trace "
              f"{sorted(traced.items(), key=lambda kv: -kv[1])[:6]}",
              file=sys.stderr, flush=True)
        summary["counters"] = launched
        return summary


def sample_marks(seed: int):
    """The fractions of the window at which steps are copied for the
    comparison, drawn from the seed."""
    rng = random.Random(f"samples/{seed}")
    return sorted(rng.uniform(0.02, 0.98) for _ in range(N_SAMPLES))


def _worse(a, b):
    """The larger of two readings, a NaN counting as the worst."""
    return a if (a != a or not a <= b) else b


def run_cell(cell: dict, seed: int, seconds: float, trace: bool, clock,
             t_start: float, entry_factory=None) -> dict:
    """One run of ``cell``: the result line as a dict (``compared``
    last).  ``entry_factory(sim, scaling, device)`` replaces the cell's
    entry (the control, and the tests' planted faults)."""
    conf, traffic = cell["config"], cell["traffic"]
    sim, scaling = conf["sim"], int(traffic["scaling"])
    reference = load_module(BENCH / "reference" / f"{conf['entry']}.py")
    gen = load_module(BENCH / "traffic"
                      / f"{traffic['generator']}.py").make(
                          traffic, sim["shape"], seed)
    if entry_factory is None:
        entry_factory = load_module(BENCH / "entries"
                                    / f"{conf['entry']}.py").build
    stamps = [("start", t_start), ("imports", time.perf_counter())]
    entry = entry_factory(sim, scaling, clock.device)
    clock.sync()
    stamps.append(("entry", time.perf_counter()))
    drv = Driver(entry, gen, clock)

    # set-up: the cell's own shapes warmed through the window's own path,
    # then the pool of events sized from the rate of a few timed steps
    drv.t = -(WARM_STEPS + RATE_STEPS)
    drv.one()
    drv.allocate(N_SAMPLES)
    drv.window(math.inf, marks=[0.0], max_steps=WARM_STEPS - 1)
    drv.samples.clear()
    _, wall, _ = drv.window(math.inf, max_steps=RATE_STEPS)
    stamps.append(("warm-up", time.perf_counter()))
    per_step = max(wall / RATE_STEPS, 1e-6)
    drv.pool = [clock.event() for _ in range(int(2 * seconds / per_step)
                                               + 64)]
    for e in drv.pool:
        e.record()
    clock.sync()
    drv.t = 0
    setup_s = time.perf_counter() - t_start
    stamps.append(("events", t_start + setup_s))
    print("set-up: " + ", ".join(
        f"{b[0]} {b[1] - a[1]:.3f} s" for a, b in zip(stamps, stamps[1:])),
        file=sys.stderr, flush=True)

    steps, wall, intervals = drv.window(seconds, marks=sample_marks(seed))
    step_s = wall / steps
    print(f"window: {steps} steps in {wall:.3f} s, intervals median "
          f"{statistics.median(intervals):.4f} ms, max {max(intervals):.4f}"
          " ms", file=sys.stderr, flush=True)
    summary = None
    if trace:
        n_active = min(max(round(TRACE_SECONDS / step_s), TRACE_STEPS[0]),
                       TRACE_STEPS[1])
        summary = drv.traced(n_active)
    peak = clock.peak_bytes()

    # the program's state and events go before the reference runs
    samples, buffers = drv.samples, drv.buffers
    del drv, entry
    clock.release()
    worst, failed = {}, 0
    limits = cell["limits"]
    for lists, buf in zip(samples, buffers):
        want = reference.step(buf["in"], *lists, sim, scaling)
        numbers = reference.compare(buf["out"], want)
        del want
        failed += any(not v <= limits[k] for k, v in numbers.items())
        for k, v in numbers.items():
            worst[k] = _worse(v, worst.get(k, 0.0))
    correct = bool(samples) and failed == 0 and set(worst) == set(limits)

    device = {"platform": "gpu" if clock.cuda else "cpu",
              "kind": clock.kind(), "count": 1, "memory_peak_bytes": peak}
    metrics = {}
    result = {"correct": correct, "attempted": steps, "failed": failed,
              "metrics": metrics, "device": device}
    if not trace:
        values = {"step_ms": 1e3 * step_s,
                  "step_p95_ms": statistics.quantiles(
                      intervals, n=100, method="inclusive")[94],
                  "setup_s": setup_s}
        for m in cell["end_to_end"]:
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    else:
        ctx = {"sim": sim, "scaling": scaling, "step_s": step_s,
               "hbm_bytes_per_s": peaks.hbm_bytes_per_s(device["kind"])}
        for m in cell["per_layer"]:
            reader = load_module(BENCH / "metrics" / f"{m['name']}.py")
            value = reader.read(summary, ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        device["busy_s"] = summary["busy_s"]
        device["window_s"] = summary["window_s"]
        result["breakdown"] = {"device_ops": summary["device_ops"],
                               "idle_gaps": summary["idle_gaps"]}
    # a reading that is not finite, or missing, is written as null
    result["compared"] = {
        k: {"value": worst[k] if math.isfinite(worst.get(k, math.nan))
            else None, "limit": lim} for k, lim in limits.items()}
    return result


def banned_modules(modules=None) -> list:
    """The names of ``BANNED_MODULES`` that ``modules`` (by default
    ``sys.modules``) holds, by the top-level name of each module."""
    held = {name.partition(".")[0]
            for name in (sys.modules if modules is None else modules)}
    return sorted(held & set(BANNED_MODULES))


def emit(result: dict, out=None, err=None):
    """The numbers compared, each beside its limit, as the last lines on
    standard error; the result as the last line on standard output."""
    out = sys.stdout if out is None else out
    err = sys.stderr if err is None else err
    for k, v in result["compared"].items():
        print(f"compared {k} {v['value']!r} limit {v['limit']!r}", file=err)
    err.flush()
    print(json.dumps(result), file=out)
    out.flush()
