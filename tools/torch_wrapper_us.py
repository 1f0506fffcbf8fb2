"""Host time of the port, without the profiler: the feed and the kernel
wrappers a call at a time, or a benchmark cell's whole step by span, on
one NVIDIA GPU.

    python3 tools/torch_wrapper_us.py [--root DIR] [--against DIR] [--calls 40]
    python3 tools/torch_wrapper_us.py --cell <workload> [--root DIR] \
        [--against DIR] [--seed N] [--steps N] [--rounds 3] [--traced 1]

For the feed (``Impulses.from_lists`` of 8 pokes, config 0's and the
plume's) and each wrapper call of the benchmarked steps -- K1 and both K2
passes of config 0's ``step_render`` at 4096² (s=1), K7's two passes, K8's
two wrappers, K9 and K10 of the 256³ plume -- prints the median host
microseconds of ``--calls`` calls, each after a ``torch.cuda.synchronize()``
(the queue empty, as in a step's first launches), and of as many calls back
to back, beside the card's name and power limit.  No profiler runs.  The
inputs are the state after a few steps of each model.  ``--root`` names the
checkout whose package is measured (default: this one).  ``--against``
names a second checkout (a parent commit unpacked with ``git archive``):
its package is loaded beside the first under another name, with its own
kernel library, and the two packages' calls take turns within one process,
their order swapped every round, so that a busy host weighs on both alike.

With ``--cell`` the benchmark's cell (``BENCHMARK.json``; its entry,
traffic and seed built through ``bench_port.core`` of this checkout) is
stepped whole, in two passes over the same N steps (N as the benchmark's
traced stretch, or ``--steps``):

* untraced, in ``--rounds`` rounds, each checkout's turn in alternating
  order: the closed loop (traffic, ``feed``, ``step``, an end-of-step
  event from a pool), synchronised every 25 steps outside the timing so
  that no launch waits on a full queue; its host dispatch a step (feed +
  step), with no recorder and with ``spans.record()`` open (where the
  package has it), which gives each span's calls, total and self us a
  step; then the same steps queued behind a ``torch.cuda._sleep`` gate,
  so that the card runs them back to back: the card's us a step, and the
  margin, card minus host dispatch (16 steps a round);
* traced, in a fresh process a checkout (one profiler trace a process;
  ``--traced`` such processes a checkout, in turns):
  ``bench_port.tracing.capture`` through ``core.Driver.traced``, each
  span's us a step, the card's idle a step by the innermost ``fluid.*``
  span under the harness's span (and in a step-level span's self time, by
  the child span it follows), and the span readers' values.

It also times one span with neither a profiler nor a recorder on, with a
recorder open and under a CPU profiler.  Prints one JSON line, with the
traced/untraced ratio of each span.  With ``--against`` the second
checkout's package is loaded under the package's own name in turn with
the first (the entries import it by that name).  Imports nothing of JAX.
"""

import argparse
import contextlib
import importlib
import importlib.util
import json
import statistics
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

PKG = "esp32_fluid_simulation_tpu_torch"
HERE = Path(__file__).resolve().parents[1]
CHUNK = 25            # untraced steps between synchronises
GATED = 16            # steps queued behind the card's gate
STEP_SPANS = ("fluid.smoke_step", "fluid.ensemble_step", "fluid.step_render")


def load_package(root: Path, name: str):
    """The package of checkout ``root``, imported as ``name``."""
    pkg = root / PKG
    spec = importlib.util.spec_from_file_location(
        name, pkg / "__init__.py", submodule_search_locations=[str(pkg)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def wrapper_calls(pkg, root: Path, dev):
    """``{label: call}`` of ``pkg``'s feed and wrappers at the benchmarked
    shapes."""
    import torch

    def sub(name):
        return importlib.import_module(f"{pkg.__name__}.{name}")

    scripted_swirl = sub("io_host.touch").scripted_swirl
    advect_kernel = sub("ops.cuda.advect").advect_kernel
    advect3d_kernel = sub("ops.cuda.advect3d").advect3d_kernel
    fd3d = sub("ops.cuda.fd3d")
    project_fused = sub("ops.cuda.project").project_fused
    sor3d_solve = sub("ops.cuda.sor3d").sor3d_solve
    mip = sub("render.cuda_smoke").render_smoke_mip_kernel

    cfg = pkg.SimConfig.from_json(
        (root / "examples" / "config0_4096_production.json").read_text())
    st, step = pkg.init_state(cfg, device=dev), pkg.make_step_render(cfg)
    for t in range(5):
        st, _ = step(st, scripted_swirl(cfg, t, device=dev))
    imp = scripted_swirl(cfg, 5, device=dev)
    vel, dye, md = st.velocity, st.color, cfg.advect_max_disp
    sc = pkg.SmokeConfig(shape=(256, 256, 256), advect_impl="pallas",
                         sor_impl="pallas")
    sm, smoke = pkg.init_smoke(sc, device=dev), pkg.make_smoke_step(sc)
    for _ in range(5):
        sm = smoke(sm)
    v3, scal = sm.velocity, torch.stack([sm.density, sm.temperature])
    div = fd3d.divergence3d(v3, sc.dx)
    p = sor3d_solve(div, sc.dx, sc.sor_iters, sc.omega)
    md3 = sc.advect_max_disp
    pokes2 = ([(1229 + 200 * k, 2867 - 250 * k) for k in range(8)],
              [(300.0 - 40 * k, -150.0 + 45 * k) for k in range(8)])
    pokes3 = ([(154, 128 + 3 * k, 102 + 6 * k) for k in range(8)],
              [(0.0, 45.0 - 11 * k, -20.0 + 7 * k) for k in range(8)])
    return {
        "feed (config 0)": lambda: pkg.Impulses.from_lists(
            cfg, *pokes2, device=dev),
        "feed (plume)": lambda: pkg.Impulses.from_lists(
            sc, *pokes3, device=dev),
        "K1 project_fused": lambda: project_fused(
            vel, cfg.dx, cfg.sor_iters, cfg.omega, impulses=imp),
        "K2 self-advect": lambda: advect_kernel(
            vel, vel, cfg.dt, True, max_disp=md),
        "K2 dye + frame": lambda: advect_kernel(
            dye, vel, cfg.dt, False, max_disp=md, clip01=True, rgb565=True),
        "K7 self-advect": lambda: advect3d_kernel(
            v3, v3, sc.dt, no_slip=True, max_disp=md3),
        "K7 scalars": lambda: advect3d_kernel(
            scal, v3, sc.dt, no_slip=False, max_disp=md3),
        "K8 divergence3d": lambda: fd3d.divergence3d(v3, sc.dx),
        "K8 subtract_gradient3d": lambda: fd3d.subtract_gradient3d(
            v3, p, sc.dx),
        "K9 sor3d_solve": lambda: sor3d_solve(div, sc.dx, sc.sor_iters,
                                              sc.omega),
        "K10 render_smoke_mip_kernel": lambda: mip(sm.density),
    }


def host_us(fns, calls, sync):
    """Median host us of a call of each of ``fns`` (``{side: call}``), the
    sides taking turns call by call, their order reversed every round."""
    import torch
    for fn in fns.values():
        for _ in range(5):
            fn()
    torch.cuda.synchronize()
    sides = list(fns)
    times = {side: [] for side in sides}
    for r in range(calls):
        for side in sides if r % 2 == 0 else sides[::-1]:
            if sync:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            fns[side]()
            times[side].append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    return {side: round(1e6 * statistics.median(v), 1)
            for side, v in times.items()}


def _take_package() -> dict:
    """Remove the package's modules from ``sys.modules`` and return them."""
    return {k: sys.modules.pop(k) for k in list(sys.modules)
            if k == PKG or k.startswith(PKG + ".")}


class Checkout:
    """A checkout's package, under the package's own name while
    ``active()``: two checkouts take turns in one process, each with its
    own modules (and kernel library)."""

    def __init__(self, root: Path):
        self.root, self.modules = root, {}
        with self.active():
            load_package(root, PKG)

    @contextlib.contextmanager
    def active(self):
        others = _take_package()
        sys.modules.update(self.modules)
        try:
            yield sys.modules[PKG] if PKG in sys.modules else None
        finally:
            self.modules = _take_package()
            sys.modules.update(others)


class Side:
    """One checkout's program under the cell's traffic: the entry, the
    generator, a pool of end-of-step events, the step count."""

    def __init__(self, checkout: Checkout, cell: dict, seed: int, clock):
        from bench_port import core
        self.checkout, self.clock = checkout, clock
        conf, traffic = cell["config"], cell["traffic"]
        with checkout.active():
            self.spans = sys.modules[PKG + ".spans"]
            self.entry = core.load_module(
                core.BENCH / "entries" / f"{conf['entry']}.py").build(
                    conf["sim"], int(traffic["scaling"]), clock.device)
        self.gen = core.load_module(
            core.BENCH / "traffic" / f"{traffic['generator']}.py").make(
                traffic, conf["sim"]["shape"], seed)
        self.t = 0
        self.pool = [clock.event() for _ in range(64)]

    def one(self, k: int):
        """One step of the closed loop; host ns of its feed and step."""
        span = self.spans.span
        lists = self.gen.step(self.t)
        t0 = time.perf_counter_ns()
        with span("bench.feed"):
            fed = self.entry.feed(*lists)
        with span("bench.step"):
            self.entry.step(fed)
        took = time.perf_counter_ns() - t0
        self.pool[k % len(self.pool)].record()
        self.t += 1
        return took

    def host_pass(self, n: int, recorder: bool):
        """``n`` untraced steps: mean host us a step and the recorder's
        totals a step (None without one)."""
        ctx = self.spans.record() if recorder else contextlib.nullcontext()
        with self.checkout.active(), ctx as rec:
            took = 0
            for k in range(n):
                if k % CHUNK == 0:
                    self.clock.sync()
                took += self.one(k)
            self.clock.sync()
        totals = None if rec is None else {
            name: {"calls": t.calls / n, "total_us": t.total_ns / n / 1e3,
                   "self_us": t.self_ns / n / 1e3}
            for name, t in rec.totals().items()}
        return took / n / 1e3, totals

    def card_pass(self, n: int, gate_cycles: int):
        """``n`` steps queued behind a sleep on the card: the card's us a
        step between the first and the last end-of-step event, and whether
        the gate ran out before the host had queued them (the card then
        waited on the host, and the reading is high)."""
        import torch
        events = [self.clock.event() for _ in range(n)]
        gate = self.clock.event()
        with self.checkout.active():
            self.clock.sync()
            torch.cuda._sleep(gate_cycles)
            gate.record()
            for k in range(n):
                self.one(k)
                events[k].record()
            short = gate.query()
            self.clock.sync()
        return 1e3 * self.clock.ms(events[0], events[-1]) / (n - 1), short


def _sleep_cycles_per_ms() -> float:
    import torch
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    a.record()
    torch.cuda._sleep(10 ** 7)
    b.record()
    torch.cuda.synchronize()
    return 10 ** 7 / a.elapsed_time(b)


def span_cost_us(spans, n: int = 20000) -> dict:
    """Host us of one ``with span(...)``: with neither a profiler nor a
    recorder on, with a recorder open (where the package has one) and
    under a CPU profiler; beside an empty ``with`` of a no-op context."""
    from torch.profiler import ProfilerActivity, profile

    def loop(fn):
        t0 = time.perf_counter()
        for _ in range(n):
            with fn("fluid.cost"):
                pass
        return round(1e6 * (time.perf_counter() - t0) / n, 3)

    off = contextlib.nullcontext()
    out = {"empty_with": loop(lambda name: off), "off": loop(spans.span)}
    if hasattr(spans, "record"):
        with spans.record():
            out["recorder"] = loop(spans.span)
    with profile(activities=[ProfilerActivity.CPU]):
        out["profiler"] = loop(spans.span)
    return out


def idle_by_span(summary: dict):
    """Seconds of the traced stretch with the card idle, by what the host
    was in: the innermost ``fluid.*`` span under the outermost ``bench.*``
    one (``bench.step > fluid.drain``), the bare harness span where no
    program span is open, ``no span`` where none is; and, of the idle in
    a step-level span's self time, by the stretch: after which of its
    child spans (``fluid.smoke_step after fluid.drain``)."""
    spans = sorted((s, -e, name) for name, ivs in summary["spans"].items()
                   if name.startswith(("bench.", "fluid.")) for s, e in ivs)
    cuts = sorted({0.0, summary["window_s"]}
                  | {x for s, e, _ in spans for x in (s, -e)})
    busy = summary["busy"]
    by_span, by_stretch = defaultdict(float), defaultdict(float)
    stack, i, j = [], 0, 0     # open spans: [name, end, last child closed]

    def close_until(t):
        while stack and stack[-1][1] <= t:
            name = stack.pop()[0]
            if stack:
                stack[-1][2] = name

    for a, b in zip(cuts, cuts[1:]):
        mid = (a + b) / 2
        while i < len(spans) and spans[i][0] <= mid:
            s, neg_end, name = spans[i]
            close_until(s)
            stack.append([name, -neg_end, None])
            i += 1
        close_until(mid)
        while j < len(busy) and busy[j][1] <= a:
            j += 1
        covered, k = 0.0, j
        while k < len(busy) and busy[k][0] < b:
            covered += min(b, busy[k][1]) - max(a, busy[k][0])
            k += 1
        idle = b - a - covered
        if idle <= 0:
            continue
        harness = next((e[0] for e in stack if e[0].startswith("bench.")),
                       None)
        inner = next((e for e in reversed(stack)
                      if e[0].startswith("fluid.")), None)
        label = " > ".join(x for x in (harness, inner and inner[0]) if x)
        by_span[label or "no span"] += idle
        if inner and inner[0] in STEP_SPANS:
            by_stretch[f"{inner[0]} after {inner[2] or 'its start'}"] += idle
    return dict(by_span), dict(by_stretch)


def traced_part(args) -> dict:
    """The traced pass of one checkout, in this process alone."""
    from bench_port import core
    clock = core.CudaClock()
    checkout = Checkout(Path(args.root).resolve())
    side = Side(checkout, core.find_cell(args.cell), args.seed, clock)
    with checkout.active():
        for k in range(8):
            side.one(k)
        clock.sync()
        drv = core.Driver(side.entry, side.gen, clock)
        drv.pool = [clock.event() for _ in range(core.TRACE_WARM
                                                 + args.steps)]
        summary = drv.traced(args.steps)
    n = summary["steps"]
    spans = defaultdict(float)
    for name, ivs in summary["spans"].items():
        spans[name] = 1e6 * sum(e - s for s, e in ivs) / n
    by_span, by_stretch = idle_by_span(summary)
    idle = {k: 1e6 * v / n for k, v in by_span.items()}
    under_step = {k: v for k, v in idle.items()
                  if k.split(" > ")[0] == "bench.step"}
    unnamed = sum(v for k, v in under_step.items()
                  if k == "bench.step" or k.split(" > ")[-1] in STEP_SPANS)
    readers = {}
    for m in core.find_cell(args.cell)["per_layer"]:
        if m["source"] == "program_span":
            reader = core.load_module(core.BENCH / "metrics"
                                      / f"{m['name']}.py")
            readers[m["name"]] = reader.read(summary, {})
    return {"steps": n, "span_us": dict(spans),
            "busy_us": 1e6 * summary["busy_s"] / n,
            "window_us": 1e6 * summary["window_s"] / n,
            "idle_us": dict(sorted(idle.items(), key=lambda kv: -kv[1])),
            "idle_stretch_us": {k: 1e6 * v / n for k, v in sorted(
                by_stretch.items(), key=lambda kv: -kv[1])},
            "idle_under_step_unnamed_share": (
                unnamed / sum(under_step.values()) if under_step else None),
            "readers": readers}


def _median_totals(rounds):
    """Per-span medians over the rounds' recorder totals."""
    names = sorted({name for r in rounds for name in r})
    return {name: {key: statistics.median(r[name][key] for r in rounds
                                          if name in r)
                   for key in ("calls", "total_us", "self_us")}
            for name in names}


def cell_mode(args, card: str) -> dict:
    from bench_port import core
    clock = core.CudaClock()
    roots = {"root": Path(args.root).resolve()}
    if args.against:
        roots["against"] = Path(args.against).resolve()
    cell = core.find_cell(args.cell)
    sides = {}
    for name, root in roots.items():
        sides[name] = Side(Checkout(root), cell, args.seed, clock)
        for k in range(8):
            with sides[name].checkout.active():
                sides[name].one(k)
        clock.sync()
    # the benchmark's traced stretch: ~0.25 s of the closed loop's steps
    first = sides["root"]
    t0 = time.perf_counter()
    with first.checkout.active():
        for k in range(50):
            first.one(k)
        clock.sync()
    pace = (time.perf_counter() - t0) / 50
    n = args.steps or min(max(round(core.TRACE_SECONDS / pace),
                              core.TRACE_STEPS[0]), core.TRACE_STEPS[1])
    per_ms = _sleep_cycles_per_ms()
    got = {name: defaultdict(list) for name in sides}
    for r in range(args.rounds):
        order = list(sides) if r % 2 == 0 else list(sides)[::-1]
        for name in order:
            side, res = sides[name], got[name]
            host, _ = side.host_pass(n, recorder=False)
            res["dispatch_us"].append(host)
            if hasattr(side.spans, "record"):
                host_on, totals = side.host_pass(n, recorder=True)
                res["dispatch_us_recorder_on"].append(host_on)
                res["spans"].append(totals)
            gate_ms = 3 * GATED * host / 1e3 + 5
            card_us, short = side.card_pass(GATED, int(gate_ms * per_ms))
            res["card_us"].append(card_us)
            res["gate_short"].append(short)
    out = {"card": card, "cell": args.cell, "seed": args.seed, "steps": n,
           "rounds": args.rounds, "untraced_pace_us": 1e6 * pace}
    for name, side in sides.items():
        res = got[name]
        untraced = {k: statistics.median(v) for k, v in res.items()
                    if k not in ("spans", "gate_short")}
        untraced["margin_us"] = untraced["card_us"] - untraced["dispatch_us"]
        untraced["gate_short"] = any(res["gate_short"])
        if res["spans"]:
            untraced["spans"] = _median_totals(res["spans"])
        with side.checkout.active():
            cost = span_cost_us(side.spans)
        out[name] = {"dir": str(roots[name]), "untraced": untraced,
                     "span_cost_us": cost}
    del sides, first
    clock.release()
    # one trace a process; two checkouts in turns, each first once
    order = [x for r in range(args.traced)
             for x in (list(roots) if r % 2 == 0 else list(roots)[::-1])]
    for name in order:
        proc = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--traced-part",
             "--cell", args.cell, "--root", str(roots[name]), "--seed",
             str(args.seed), "--steps", str(n)],
            capture_output=True, text=True, check=False)
        if proc.returncode != 0:
            sys.exit(f"torch_wrapper_us: the traced pass of {roots[name]} "
                     f"failed:\n{proc.stderr[-4000:]}")
        traced = json.loads(proc.stdout.strip().splitlines()[-1])
        side = out[name]
        untraced = side["untraced"].get("spans", {})
        ratio = {span: round(traced["span_us"][span] / u["total_us"], 3)
                 for span, u in untraced.items()
                 if traced["span_us"].get(span) and u["total_us"] > 0}
        host = sum(traced["span_us"].get(k, 0.0)
                   for k in ("bench.feed", "bench.step"))
        ratio["dispatch"] = round(host / side["untraced"]["dispatch_us"], 3)
        side.setdefault("traced", []).append(traced)
        side.setdefault("ratio", []).append(ratio)
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=str(HERE))
    ap.add_argument("--against")
    ap.add_argument("--calls", type=int, default=40)
    ap.add_argument("--cell")
    ap.add_argument("--seed", type=int, default=3000026001)
    ap.add_argument("--steps", type=int, default=0)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--traced", type=int, default=1)
    ap.add_argument("--traced-part", action="store_true",
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("torch_wrapper_us: no CUDA device")
    sys.path.insert(0, str(HERE))
    if args.traced_part:
        print(json.dumps(traced_part(args)))
        return
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    if args.cell:
        print(json.dumps(cell_mode(args, card)))
        return
    roots = {"root": Path(args.root).resolve()}
    if args.against:
        roots["against"] = Path(args.against).resolve()
    dev = torch.device("cuda", 0)
    calls = {side: wrapper_calls(load_package(root, f"{PKG}_{side}"), root,
                                 dev)
             for side, root in roots.items()}
    res = {"card": card, "calls": args.calls,
           **{side: str(root) for side, root in roots.items()}}
    for label in calls["root"]:
        fns = {side: calls[side][label] for side in calls}
        res[label] = {"after sync": host_us(fns, args.calls, True),
                      "back to back": host_us(fns, args.calls, False)}
    print(json.dumps(res))


if __name__ == "__main__":
    main()
