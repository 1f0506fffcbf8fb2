"""CPU self-test of the port's benchmark: the traffic generator, the lookup
by name, the byte counts, the plain reference against the port, the trace
reduction, and a whole run on the CPU stand-in for the card, sound, as
the control and with faults planted under it.

    python -m pytest bench_port/tests -q
"""

import json
import math
import re
import sys
import time
import types
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from bench_port import core, readings, sizes, tracing  # noqa: E402
from bench_port.tests.cpu import HostClock  # noqa: E402

BENCHMARK = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCHMARK["workloads"]]
BIG_SEED = 2 ** 40 + 12345
# the upstream's 61x81 bed: its files are kept, but it is no cell (PERF.md)
BED = "ref80x60.swirl.s4"


def _json(path):
    return json.loads((ROOT / "bench_port" / path).read_text())


def _config(name):
    """The configuration file of cell ``name`` (the bed's own for BED)."""
    if name == BED:
        return _json("configs/ref_80x60.json")
    conf = next(w["config"] for w in BENCHMARK["workloads"]
                if w["name"] == name)
    return json.loads((ROOT / next(c["file"] for c in BENCHMARK["configs"]
                                   if c["name"] == conf)).read_text())


def _module(kind, name):
    """``entries`` or ``reference`` module of cell ``name``'s entry."""
    entry = _config(name)["entry"]
    return core.load_module(ROOT / "bench_port" / kind / f"{entry}.py")


def small_cell(name):
    """Cell ``name`` at the shape its entry's ``cpu_sim`` gives; the bed
    as it is, under ``cfg0.swirl.s4``'s traffic."""
    if name == BED:
        cell = core.find_cell("cfg0.swirl.s4")
        cell.update(name=BED, config=_config(BED),
                    limits=_json(f"limits/{BED}.json")["limits"])
        return cell
    cell = core.find_cell(name)
    conf = cell["config"]
    conf["sim"] = _module("entries", name).cpu_sim(conf["sim"])
    return cell


def run(cell, seed=BIG_SEED, seconds=0.3, trace=False, factory=None):
    return core.run_cell(cell, seed, seconds, trace, HostClock(),
                         time.perf_counter(), factory)


# -- traffic --------------------------------------------------------------

def test_swirl_is_the_programs_scripted_swirl():
    from esp32_fluid_simulation_tpu_torch import SimConfig
    from esp32_fluid_simulation_tpu_torch.io_host.touch import scripted_swirl

    params = json.loads((ROOT / "bench_port/traffic/swirl.s1.json")
                        .read_text())
    gen = core.load_module(ROOT / "bench_port/traffic/swirl.py").make(
        params, (61, 81), BIG_SEED)
    gen.phase0 = 0.0
    cfg = SimConfig()
    for t in (0, 1, 17, 400):
        pos, vel = gen.step(t)
        want = scripted_swirl(cfg, t, device="cpu")
        assert len(pos) == 8 and want.active.sum() == 8
        assert torch.equal(torch.tensor(pos, dtype=torch.int32),
                           want.pos[:8])
        assert torch.equal(torch.tensor(vel, dtype=torch.float32),
                           want.velocity[:8])


def test_swirl_seed_moves_the_pokes_not_the_work():
    params = json.loads((ROOT / "bench_port/traffic/swirl.s4.json")
                        .read_text())
    make = core.load_module(ROOT / "bench_port/traffic/swirl.py").make
    a, b, c = (make(params, (4096, 4096), s) for s in
               (BIG_SEED, BIG_SEED, BIG_SEED + 1))
    assert a.step(5) == b.step(5)
    assert a.step(5)[0] != c.step(5)[0]
    for g in (a, c):
        pos, vel = g.step(9)
        assert len(pos) == 8
        assert all(0 <= i < 4096 and 0 <= j < 4096 for i, j in pos)
        assert all(math.isclose(math.hypot(*v), 300.0) for v in vel)


# -- lookup by name -------------------------------------------------------

@pytest.mark.parametrize("name", CELLS)
def test_cell_files_found_by_name(name):
    cell = core.find_cell(name)
    entry = cell["config"]["entry"]
    for path in (f"entries/{entry}.py", f"reference/{entry}.py",
                 f"traffic/{cell['traffic']['generator']}.py"):
        assert (ROOT / "bench_port" / path).is_file(), path
    for m in cell["per_layer"]:
        assert (ROOT / "bench_port/metrics" / f"{m['name']}.py").is_file()
    assert {m["name"] for m in cell["end_to_end"]} >= {"setup_s"}
    assert len(cell["end_to_end"]) >= 2 and cell["per_layer"]
    assert set(cell["limits"]) == set(_module("reference", name).NUMBERS)
    assert callable(_module("entries", name).cpu_sim)


def test_unknown_cell_is_refused():
    with pytest.raises(SystemExit):
        core.find_cell("no.such.cell")


def test_benchmark_json_keeps_to_its_form():
    name = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
    keys = {"configs": {"name", "source", "file", "reduced", "why"},
            "workloads": {"name", "config", "traffic", "chips", "why"}}
    for group, want in keys.items():
        for item in BENCHMARK[group]:
            assert set(item) == want and name.match(item["name"])
    for m in BENCHMARK["end_to_end"] + BENCHMARK["per_layer"]:
        assert name.match(m["name"]) and m["better"] in ("lower", "higher")
    for m in BENCHMARK["per_layer"]:
        assert m["moves"] in {e["name"] for e in BENCHMARK["end_to_end"]}
        assert set(m["workloads"]) <= set(CELLS)
    for conf in BENCHMARK["configs"]:
        assert conf["file"].startswith("bench_port/")
        assert len(conf["source"]) <= 200


# -- byte counts ------------------------------------------------------------

def test_step_bytes_by_hand():
    sim = core.find_cell("cfg0.swirl.s1")["config"]["sim"]
    vel, dye = 2 * 4096 * 4096 * 4, 3 * 4096 * 4096 * 2
    assert sizes.velocity_bytes(sim) == vel == 134_217_728
    assert sizes.dye_bytes(sim) == dye == 100_663_296
    assert sizes.frame_bytes(sim, 1) == 4095 * 4095 * 2
    assert sizes.frame_bytes(sim, 4) == 16380 * 16380 * 2
    assert round(sizes.step_bytes(sim, 1) / 1e6, 1) == 503.3
    assert round(sizes.step_bytes(sim, 4) / 1e6, 1) == 1006.4
    big = core.find_cell("cfg0_8192.swirl.s1")["config"]["sim"]
    assert sizes.velocity_bytes(big) == 2 * 8192 * 8192 * 4
    assert round(2 * sizes.velocity_bytes(big) / 1e6, 1) == 1073.7
    assert round(sizes.step_bytes(big, 1) / 1e6, 1) == 2013.2
    ref = _json("configs/ref_80x60.json")["sim"]
    assert sizes.step_bytes(ref, 4) == (2 * 2 * 61 * 81 * 4
                                        + 2 * 3 * 61 * 81 * 4
                                        + 240 * 320 * 2)


def test_roofline_readers_hold_at_the_bound():
    """A kernel or step that takes exactly its least time reads 100%."""
    sim = core.find_cell("cfg0.swirl.s4")["config"]["sim"]
    bw = 3.35e12
    vel, dye = sizes.velocity_bytes(sim), sizes.dye_bytes(sim)
    frame = sizes.frame_bytes(sim, 4)
    least = {"project_tile_kernel": 2 * vel,
             "advect_kernel": 3 * vel + 2 * dye,
             "render_rgb565_kernel": dye + frame}
    steps = 7
    summary = {"steps": steps, "kernels": [
        {"name": f"void {k}<float>(float*)", "seconds": steps * b / bw,
         "eager": False} for k, b in least.items()]}
    ctx = {"sim": sim, "scaling": 4, "hbm_bytes_per_s": bw,
           "step_s": sizes.step_bytes(sim, 4) / bw}
    for metric in ("k1_project_roofline", "k2_advect_roofline",
                   "k3_upscale_roofline", "step_roofline"):
        reader = core.load_module(ROOT / f"bench_port/metrics/{metric}.py")
        assert reader.read(summary, ctx) == pytest.approx(100.0)
        assert reader.read(summary, dict(ctx, hbm_bytes_per_s=None)) is None


# -- the trace reduction --------------------------------------------------

def _x(name, cat, ts, dur, corr=None, pid=1):
    e = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
         "pid": pid, "tid": 1}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def test_summarize_unions_labels_and_counts():
    events = [
        _x("bench.feed", "user_annotation", 0, 30),
        _x("aten::to", "cpu_op", 1, 28),
        _x("cudaMemcpyAsync", "cuda_runtime", 2, 3, corr=1),
        _x("cudaStreamSynchronize", "cuda_runtime", 6, 20),
        _x("bench.step", "user_annotation", 40, 60),
        _x("aten::add", "cpu_op", 41, 5),
        _x("cudaLaunchKernel", "cuda_runtime", 42, 2, corr=2),
        _x("cudaLaunchKernel", "cuda_runtime", 60, 2, corr=3),
        _x("Memcpy HtoD", "gpu_memcpy", 8, 4, corr=1, pid=0),
        _x("add_kernel", "kernel", 45, 10, corr=2, pid=0),
        _x("void advect_kernel<float>", "kernel", 62, 30, corr=3, pid=0),
        _x("cudaDeviceSynchronize", "cuda_runtime", 101, 1),
    ]
    s = tracing.summarize(events, steps=1)
    assert s["window_s"] == pytest.approx(102e-6)
    assert s["busy_s"] == pytest.approx(44e-6)   # 4 + 10 + 30
    assert [k["eager"] for k in s["kernels"]] == [True, False]
    syncs = core.load_module(ROOT / "bench_port/metrics/"
                             "entry.syncs_per_step.py")
    assert syncs.read(s, {}) == 1   # the harness's own sync not counted
    eager = core.load_module(ROOT / "bench_port/metrics/"
                             "eager.launches_per_step.py")
    assert eager.read(s, {}) == 1
    idle = core.load_module(ROOT / "bench_port/metrics/device.idle_pct.py")
    assert idle.read(s, {}) == pytest.approx(100 * (1 - 44 / 102))
    gaps = dict(s["idle_gaps"])
    assert gaps == pytest.approx({"bench.feed > cudaMemcpyAsync": 8e-6,
                                  "bench.feed > aten::to": 33e-6,
                                  "bench.step": 17e-6})
    assert sum(gaps.values()) == pytest.approx(58e-6)
    assert s["device_ops"][0][0] == "void advect_kernel<float>"


def _us(pairs):
    return [[round(a * 1e6, 6), round(b * 1e6, 6)] for a, b in pairs]


def test_summarize_keeps_spans_calls_and_busy_intervals():
    """The program's ``fluid.*`` spans nested inside ``bench.step`` (one of
    them twice), the runtime calls and the card's busy intervals, in
    seconds from the stretch's start (1000 us on the trace's clock); the
    profiler's own step span is left out."""
    events = [
        _x("ProfilerStep#4", "user_annotation", 1000, 100),
        _x("bench.feed", "user_annotation", 1000, 20),
        _x("fluid.impulses", "user_annotation", 1002, 16),
        _x("cudaStreamSynchronize", "cuda_runtime", 1005, 10),
        _x("bench.step", "user_annotation", 1030, 60),
        _x("fluid.step_render", "user_annotation", 1031, 58),
        _x("fluid.k2.advect", "user_annotation", 1032, 10),
        _x("cudaLaunchKernel", "cuda_runtime", 1040, 1, corr=1),
        _x("fluid.k1.project", "user_annotation", 1045, 8),
        _x("cudaLaunchKernel", "cuda_runtime", 1050, 1, corr=2),
        _x("fluid.k2.advect", "user_annotation", 1060, 15),
        _x("cudaLaunchKernel", "cuda_runtime", 1073, 1, corr=3),
        _x("void advect_kernel<float>", "kernel", 1042, 20, corr=1, pid=0),
        _x("void project_tile_kernel<float>", "kernel", 1055, 30, corr=2,
           pid=0),
        _x("void advect_kernel<bf16>", "kernel", 1085, 3, corr=3, pid=0),
    ]
    s = tracing.summarize(events, steps=1)
    assert {k: _us(v) for k, v in s["spans"].items()} == {
        "bench.feed": [[0, 20]], "fluid.impulses": [[2, 18]],
        "bench.step": [[30, 90]], "fluid.step_render": [[31, 89]],
        "fluid.k2.advect": [[32, 42], [60, 75]],
        "fluid.k1.project": [[45, 53]]}
    assert {k: _us(v) for k, v in s["calls"].items()} == {
        "cudaStreamSynchronize": [[5, 15]],
        "cudaLaunchKernel": [[40, 41], [50, 51], [73, 74]]}
    assert _us(s["busy"]) == [[42, 88]]
    # what a reader can take from them: the card idle while the host is
    # inside the step's span (30-42 and 88-90 us)
    step = s["spans"]["bench.step"][0]
    idle = step[1] - step[0] - sum(
        max(0.0, min(e, step[1]) - max(b, step[0])) for b, e in s["busy"])
    assert idle == pytest.approx(14e-6)
    assert s["window_s"] == pytest.approx(100e-6)


# -- the plain reference against the port ---------------------------------

def _port_state(sim, scaling, seed, steps):
    from esp32_fluid_simulation_tpu_torch import (Impulses, SimConfig,
                                                  init_state)
    from esp32_fluid_simulation_tpu_torch.models.stable_fluids import (
        make_step_render)
    cfg = SimConfig(**dict(sim, shape=tuple(sim["shape"]), scaling=scaling))
    params = {"n_points": 8, "radius_frac": 0.3, "turn_rad": 0.15,
              "speed": 300.0}
    gen = core.load_module(ROOT / "bench_port/traffic/swirl.py").make(
        params, sim["shape"], seed)
    st, step = init_state(cfg, device="cpu"), make_step_render(cfg)
    for t in range(steps):
        pos, vel = gen.step(t)
        before = {"velocity": st.velocity, "dye": st.color}
        st, frame = step(st, Impulses.from_lists(cfg, pos, vel,
                                                 device="cpu"))
    return before, pos, vel, {"velocity": st.velocity, "dye": st.color,
                              "frame": frame}


@pytest.mark.parametrize("name,steps", [(BED, 30)] + [
    (c, 12) for c in CELLS if _config(c)["entry"] == "step_render"])
def test_reference_equals_the_port(name, steps):
    """The reference stepped from the port's state at step ``steps - 1``
    equals the port's step to the bit: the eager path at 61x81, the
    kernels' plain versions (which the kernels equal on the card) at a
    small config-0 grid."""
    cell = small_cell(name)
    sim, s = cell["config"]["sim"], cell["traffic"]["scaling"]
    ref = core.load_module(ROOT / "bench_port/reference/step_render.py")
    before, pos, vel, got = _port_state(sim, s, BIG_SEED, steps)
    want = ref.step(before, pos, vel, sim, s)
    assert ref.compare(got, want) == dict.fromkeys(ref.NUMBERS, 0.0)
    lower = ref.step(before, pos, vel, sim, s, lower=True)
    numbers = ref.compare(lower, want)
    assert all(v > 0 for v in numbers.values()), numbers


def test_imports_neither_jax_nor_the_jax_package():
    """No file of the harness imports JAX, the JAX package, ``bench.py``
    or the program's roofline model; no reference imports anything of the
    program at all."""
    banned = re.compile(r"^\s*(from|import)\s+(jax|bench\b|"
                        r"esp32_fluid_simulation_tpu(\.|\s|$)|"
                        r".*utils\.roofline|.*utils import roofline)", re.M)
    for path in (ROOT / "bench_port").rglob("*.py"):
        assert not banned.search(path.read_text()), path
    refs = sorted((ROOT / "bench_port/reference").glob("*.py"))
    assert refs
    for path in refs:
        assert not re.search(r"^\s*(from|import)\s+esp32", path.read_text(),
                             re.M), path


def test_harness_names_no_entry_of_its_own():
    """The harness's shared files import nothing of the program and name
    no type or field of an entry: a new entry is new files only."""
    program = re.compile(r"^\s*(from|import)\s+esp32", re.M)
    named = re.compile(r"\b(SimConfig|init_state|Impulses|StepRender|"
                       r"velocity|dye|colou?r|frame|impulses?)\b")
    for f in ("core.py", "readings.py", "run.py", "tracing.py"):
        text = (ROOT / "bench_port" / f).read_text()
        assert not program.search(text), f
        assert not named.search(text), (f, named.search(text))


def test_banned_modules_are_named_by_top_level_name():
    held = ["torch", "numpy", "jaxtyping", "esp32_fluid_simulation_tpu_torch",
            "esp32_fluid_simulation_tpu_torch.ops.cuda.project"]
    assert core.banned_modules(held) == []
    assert core.banned_modules(held + [
        "jax.numpy", "flax", "esp32_fluid_simulation_tpu.ops.advect"]) == [
            "esp32_fluid_simulation_tpu", "flax", "jax"]


# -- whole runs on the CPU stand-in ---------------------------------------

@pytest.mark.parametrize("name", CELLS + [BED])
def test_sound_run_is_correct(name):
    cell = small_cell(name)
    r = run(cell)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] > 0
    assert list(r)[-1] == "compared"
    assert set(r["metrics"]) == {m["name"] for m in cell["end_to_end"]}


def test_traced_run_reports_per_layer_metrics_only():
    r = run(small_cell(BED), trace=True)
    assert r["correct"]
    assert set(r["metrics"]) <= {m["name"] for m in BENCHMARK["per_layer"]}
    assert not set(r["metrics"]) & {m["name"] for m in
                                    BENCHMARK["end_to_end"]}
    assert r["device"]["window_s"] > 0 and "breakdown" in r


@pytest.mark.parametrize("name", CELLS + [BED])
def test_control_starts_from_the_entrys_inputs(name):
    """The control is built from the cell's entry and reference alone: its
    state is the entry's initial ``inputs()`` through ``lower_state``,
    bit for bit, and one precision below the program's.  For the dye bed
    that is the velocity rounded through bfloat16 and the dye one dtype
    down."""
    cell = small_cell(name)
    sim, s = cell["config"]["sim"], cell["traffic"]["scaling"]
    ref = _module("reference", name)
    program = _module("entries", name).build(sim, s, "cpu").inputs()
    control = readings.control_factory(cell)(sim, s, "cpu").inputs()
    want = ref.lower_state(program, sim)
    assert list(control) == list(program) == list(want)
    for k, v in control.items():
        assert v.dtype == want[k].dtype and torch.equal(v, want[k]), k
    if cell["config"]["entry"] == "step_render":
        lower = {"float32": torch.bfloat16,
                 "bfloat16": torch.float8_e4m3fn}[sim["color_dtype"]]
        assert torch.equal(control["velocity"],
                           program["velocity"].to(torch.bfloat16).float())
        assert control["dye"].dtype == lower
        assert torch.equal(control["dye"].float(),
                           program["dye"].to(lower).float())


@pytest.mark.parametrize("name", CELLS + [BED])
def test_control_is_not_correct(name):
    cell = small_cell(name)
    r = run(cell, seconds=0.5, factory=readings.control_factory(cell))
    assert not r["correct"]
    assert all(v["value"] > v["limit"] for v in r["compared"].values())


def _alter(t):
    """One element of ``t`` changed beyond any limit: a float by 1 and
    half the tensor's largest magnitude more, an integer word in every
    bit."""
    flat = t.view(-1)
    k = flat.numel() // 3
    if t.is_floating_point():
        flat[k] = flat[k].float() + 1 + 0.5 * float(flat.float().abs().max())
    else:
        signed = {torch.uint16: torch.int16, torch.uint32: torch.int32,
                  torch.uint64: torch.int64}
        words = flat.view(signed.get(t.dtype, t.dtype))
        words[k] = ~words[k]


class _Faulty:
    """The cell's entry with a fault planted under the window, through its
    ``inputs()``, ``outputs()`` and the traffic's lists alone."""

    def __init__(self, entry, fault):
        self.e, self.fault = entry, fault
        self._stale = {}

    def feed(self, *lists):
        if self.fault == "half_the_lists":
            lists = tuple(x[::2] for x in lists)
        return self.e.feed(*lists)

    def step(self, fed):
        if self.fault == "state_unchanged":
            before = {k: v.clone() for k, v in self.e.inputs().items()}
        self.e.step(fed)
        out = self.e.outputs()
        if self.fault == "state_unchanged":
            for k, v in self.e.inputs().items():
                v.copy_(before[k])
        elif self.fault.endswith("_altered"):
            _alter(out[self.fault.removesuffix("_altered")])
        elif self.fault == "stale_output":
            # what the step produces beside its state: the last step's
            keys = [k for k in out if k not in self.e.inputs()] or list(out)
            for k in keys:
                fresh = out[k].clone()
                if k in self._stale:
                    out[k].copy_(self._stale[k])
                self._stale[k] = fresh

    def inputs(self):
        return self.e.inputs()

    def outputs(self):
        return self.e.outputs()


def _faults(name):
    outputs = dict.fromkeys(_module("reference", name).NUMBERS.values())
    if name == BED:
        # its frame_pct limit, 1.5% of 76,800 words, lets one word through
        # by its own readings (the control's 4.6%): PERF.md, open questions
        outputs.pop("frame")
    return (["state_unchanged", "half_the_lists"]
            + [f"{o}_altered" for o in outputs] + ["stale_output"])


@pytest.mark.parametrize("name,fault", [
    (name, fault) for name in CELLS + [BED] for fault in _faults(name)])
def test_planted_fault_is_not_correct(name, fault):
    cell = small_cell(name)
    build = _module("entries", name).build

    def factory(sim, scaling, device):
        return _Faulty(build(sim, scaling, device), fault)

    r = run(cell, seconds=0.5, factory=factory)
    assert not r["correct"], r["compared"]


def test_traced_run_counts_the_entrys_launches_a_step():
    """``counters`` in the summary: the entry's counters a step over the
    traced stretch and its warm-up.  On the CPU the kernels' plain
    versions run and count no launch; the wrapper counts the steps and
    the swirl's 8 pokes a step."""
    cell = small_cell(BED)
    sim, s = cell["config"]["sim"], cell["traffic"]["scaling"]
    entry = _module("entries", BED).build(sim, s, "cpu")

    class Counted:
        steps, pokes = 0, 0

        def feed(self, *lists):
            self.pokes += len(lists[0])
            return entry.feed(*lists)

        def step(self, fed):
            self.steps += 1
            entry.step(fed)

        def counters(self):
            return dict(entry.counters(), steps=self.steps, pokes=self.pokes)

    gen = core.load_module(ROOT / "bench_port/traffic/swirl.py").make(
        cell["traffic"], sim["shape"], BIG_SEED)
    drv = core.Driver(Counted(), gen, HostClock())
    drv.pool = [drv.clock.event()]
    summary = drv.traced(4)
    assert summary["counters"] == {"K1": 0.0, "K2": 0.0, "K3": 0.0,
                                   "steps": 1.0, "pokes": 8.0}


def test_run_without_a_card_fails_and_prints_no_result(capsys):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    run_py = core.load_module(ROOT / "bench_port/run.py")
    rc = run_py.main(["--workload", CELLS[0], "--seed", "1", "--seconds",
                      "1", "--trace", "0"])
    assert rc != 0
    assert capsys.readouterr().out == ""


@pytest.mark.parametrize("jax_loaded", [False, True])
def test_run_that_loads_jax_fails_and_prints_no_result(monkeypatch, capfd,
                                                        jax_loaded):
    """A whole run on the CPU stand-in prints its result, unless the
    process holds JAX once the window has closed."""
    run_py = core.load_module(ROOT / "bench_port/run.py")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(core, "CudaClock", HostClock)
    cell = small_cell(CELLS[0])
    monkeypatch.setattr(core, "find_cell", lambda name: cell)
    if jax_loaded:
        monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    rc = run_py.main(["--workload", CELLS[0], "--seed", str(BIG_SEED),
                      "--seconds", "0.2", "--trace", "0"])
    captured = capfd.readouterr()
    if jax_loaded:
        assert rc != 0 and captured.out == ""
        assert "jax" in captured.err
    else:
        assert rc == 0
        assert json.loads(captured.out.splitlines()[-1])["correct"]
