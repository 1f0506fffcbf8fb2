"""The port's profiler spans (``spans.py``) on the CPU.

* under a ``torch.profiler`` the config-0 step (``fused_pallas`` K1,
  ``pallas`` K2, whose wrappers run their plain versions here) records
  ``fluid.step_render`` with ``fluid.k2.advect`` twice and
  ``fluid.k1.project`` once nested in it, at s=1 (the fused path) and at
  s=4 (``step`` + the render); K1's plain version drains the queue
  through ``apply_impulses_``, ``fluid.drain`` (the kernel drains it
  itself); ``Impulses.from_lists`` and each wrapper called directly
  record their span;
* with no profiler recording no span calls ``record_function``;
* a step's outputs are bit-equal with and without a profiler recording,
  and with a ``spans.record()`` open;
* ``utils.profiling.trace`` writes the spans into its Chrome trace;
* ``spans.record()``: the same spans with the same nesting as the
  profiler's, each name's calls, duration and self time on a stub clock,
  only the thread that opened it, one at a time, the profiler first while
  it records, and no clock read once it is closed.
"""

import json
import threading

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from esp32_fluid_simulation_tpu_torch import spans
from esp32_fluid_simulation_tpu_torch import Impulses, SimConfig, init_state
from esp32_fluid_simulation_tpu_torch.models.stable_fluids import (
    make_step_render)
from esp32_fluid_simulation_tpu_torch.ops.cuda.advect import advect_kernel
from esp32_fluid_simulation_tpu_torch.ops.cuda.project import project_fused
from esp32_fluid_simulation_tpu_torch.render.cuda_upscale import (
    render_rgb565_kernel)
from esp32_fluid_simulation_tpu_torch.spans import span
from esp32_fluid_simulation_tpu_torch.utils import profiling
from span_records import counting_clock, profiled, recorded

POS = [(5, 7), (12, 20), (18, 9)]
VEL = [(40.0, -25.0), (-30.0, 10.0), (5.0, 35.0)]
# the step's spans on the CPU, in order of entry: K1's plain version
# drains the queue inside K1's span
STEP = ["fluid.impulses", "fluid.step_render", "fluid.k2.advect",
        "fluid.k1.project", "fluid.drain", "fluid.k2.advect"]


def _cfg(scaling):
    return SimConfig(shape=(24, 32), solver="fused_pallas",
                     advect_impl="pallas", color_dtype="bfloat16",
                     scaling=scaling)


def _step(scaling):
    """One config-0-like step: the impulses fed and the state stepped."""
    cfg = _cfg(scaling)
    st = init_state(cfg, device="cpu")
    st = st._replace(velocity=torch.randn(st.velocity.shape,
                                          generator=torch.Generator()
                                          .manual_seed(7)))
    imp = Impulses.from_lists(cfg, POS, VEL, device="cpu")
    return make_step_render(cfg)(st, imp)


def _direct(which):
    """A direct call of the entry or wrapper that records ``which``."""
    g = torch.Generator().manual_seed(3)
    vel = torch.randn((2, 24, 32), generator=g)
    if which == "fluid.impulses":
        return Impulses.from_lists(_cfg(1), POS, VEL, device="cpu")
    if which == "fluid.k1.project":
        return project_fused(vel, iters=4)
    if which == "fluid.k2.advect":
        return advect_kernel(vel, vel, 1 / 30, True, self_advect=True)
    return render_rgb565_kernel(torch.rand((3, 24, 32), generator=g), s=4)


def _recorded(fn):
    """``fn()`` under a CPU profiler: its result and the ``fluid.*``
    events, in order of start."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    events = sorted((e for e in prof.events()
                     if e.name.startswith("fluid.")),
                    key=lambda e: e.time_range.start)
    return out, events


@pytest.mark.parametrize("scaling", [1, 4])
def test_step_records_its_wrappers_inside_step_render(scaling):
    _, events = _recorded(lambda: _step(scaling))
    names = [e.name for e in events]
    assert names == STEP
    outer = events[1].time_range
    for e in events[2:]:
        assert outer.start <= e.time_range.start <= e.time_range.end \
            <= outer.end, e.name
    assert events[0].time_range.end <= outer.start
    k1, drain = events[3].time_range, events[4].time_range
    assert k1.start <= drain.start <= drain.end <= k1.end


@pytest.mark.parametrize("name", ["fluid.impulses", "fluid.k1.project",
                                  "fluid.k2.advect", "fluid.k3.render"])
def test_direct_call_records_its_span(name):
    _, events = _recorded(lambda: _direct(name))
    assert [e.name for e in events] == [name]


@pytest.mark.parametrize("call", ["step_s1", "step_s4", "fluid.impulses",
                                  "fluid.k3.render"])
def test_no_record_function_without_a_profiler(call, monkeypatch):
    def refused(name):
        raise AssertionError(f"record_function({name!r}) with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refused)
    if call.startswith("step"):
        _step(int(call[-1]))
    else:
        _direct(call)
    with pytest.raises(AssertionError):
        with profile(activities=[ProfilerActivity.CPU]):
            with span("fluid.step_render"):
                pass


@pytest.mark.parametrize("scaling", [1, 4])
def test_outputs_bit_equal_with_and_without_a_profiler(scaling):
    plain_state, plain_frame = _step(scaling)
    (state, frame), _ = _recorded(lambda: _step(scaling))
    assert torch.equal(state.velocity, plain_state.velocity)
    assert torch.equal(state.color.view(torch.int16),
                       plain_state.color.view(torch.int16))
    assert torch.equal(frame, plain_frame)
    assert state.step == plain_state.step


def test_utils_trace_holds_the_spans(tmp_path):
    assert profiling.span is span
    with profiling.trace(str(tmp_path / "tr")):
        _step(1)
    (path,) = (tmp_path / "tr").glob("trace_*.json")
    events = json.loads(path.read_text())["traceEvents"]
    names = [e["name"] for e in events
             if e.get("cat") == "user_annotation"
             and e.get("name", "").startswith("fluid.")]
    assert sorted(names) == sorted(STEP)


# -- the untraced recorder --------------------------------------------------

@pytest.mark.parametrize("scaling", [1, 4])
def test_recorder_gives_the_profilers_spans_and_nesting(scaling):
    _, want = profiled(lambda: _step(scaling))
    _, got, rec = recorded(lambda: _step(scaling))
    assert [name for name, _ in got] == STEP
    assert got == want
    assert ("fluid.drain", "fluid.k1.project") in got
    assert all(end >= start for _, _, start, end in rec.spans)
    assert spans._recorder is None


def test_recorder_self_time_is_duration_less_children():
    """Stamps from a stub clock: a [0, 100] holds b [5, 12] and b [20, 60],
    the second holding c [31, 40]."""
    ticks = iter([0, 5, 12, 20, 31, 40, 60, 100])
    with spans.record(lambda: next(ticks)) as rec:
        with span("fluid.a"):
            with span("fluid.b"):
                pass
            with span("fluid.b"):
                with span("fluid.c"):
                    pass
    assert rec.spans == [["fluid.a", -1, 0, 100], ["fluid.b", 0, 5, 12],
                         ["fluid.b", 0, 20, 60], ["fluid.c", 2, 31, 40]]
    assert rec.totals() == {"fluid.a": (1, 100, 53), "fluid.b": (2, 47, 38),
                            "fluid.c": (1, 9, 9)}


def test_recorder_totals_of_a_step_on_a_stub_clock():
    """On the real step each span's self time is its duration less the
    durations of the spans stamped as its children."""
    clock, calls = counting_clock()
    _, _, rec = recorded(lambda: _step(4), clock)
    assert len(calls) == 2 * len(STEP)
    totals = rec.totals()
    for k, (name, _, start, end) in enumerate(rec.spans):
        children = sum(e - s for _, parent, s, e in rec.spans
                       if parent == k)
        assert end - start - children > 0, name
    for name in set(STEP):
        mine = [(k, s, e) for k, (n, _, s, e) in enumerate(rec.spans)
                if n == name]
        total = sum(e - s for _, s, e in mine)
        covered = sum(e - s for _, parent, s, e in rec.spans
                      if parent in {k for k, _, _ in mine})
        assert totals[name] == (len(mine), total, total - covered), name


def test_recorder_records_only_the_thread_that_opened_it():
    seen = {}

    def other():
        seen["context"] = span("fluid.other")
        with seen["context"]:
            pass

    with spans.record() as rec:
        worker = threading.Thread(target=other)
        worker.start()
        worker.join(timeout=30)
        with span("fluid.mine"):
            pass
    assert not worker.is_alive()
    assert seen["context"] is spans._OFF
    assert [s[0] for s in rec.spans] == ["fluid.mine"]


def test_recorder_is_one_at_a_time_and_closes():
    with spans.record():
        with pytest.raises(RuntimeError):
            with spans.record():
                pass
    assert spans._recorder is None
    with pytest.raises(KeyError):
        with spans.record():
            raise KeyError("inside")
    assert spans._recorder is None
    assert span("fluid.step_render") is spans._OFF


def test_profiler_takes_the_spans_while_it_records():
    clock, calls = counting_clock()
    with spans.record(clock) as rec:
        _, events = _recorded(lambda: _step(1))
    assert [e.name for e in events] == STEP
    assert rec.spans == [] and calls == []


@pytest.mark.parametrize("scaling", [1, 4])
def test_neither_on_reads_no_clock_and_no_record_function(scaling,
                                                          monkeypatch):
    def refused(name):
        raise AssertionError(f"record_function({name!r}) with no profiler")

    clock, calls = counting_clock()
    with spans.record(clock):
        pass
    monkeypatch.setattr(torch.profiler, "record_function", refused)
    _step(scaling)
    assert calls == []


@pytest.mark.parametrize("scaling", [1, 4])
def test_outputs_bit_equal_with_the_recorder_the_profiler_and_neither(
        scaling):
    plain_state, plain_frame = _step(scaling)
    (traced, traced_frame), _ = _recorded(lambda: _step(scaling))
    (stamped, stamped_frame), _, _ = recorded(lambda: _step(scaling))
    for state, frame in ((traced, traced_frame), (stamped, stamped_frame)):
        assert torch.equal(state.velocity, plain_state.velocity)
        assert torch.equal(state.color.view(torch.int16),
                           plain_state.color.view(torch.int16))
        assert torch.equal(frame, plain_frame)
