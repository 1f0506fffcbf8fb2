"""The port's profiler spans (``spans.py``) on the CPU.

* under a ``torch.profiler`` the config-0 step (``fused_pallas`` K1,
  ``pallas`` K2, whose wrappers run their plain versions here) records
  ``fluid.step_render`` with ``fluid.k2.advect`` twice and
  ``fluid.k1.project`` once nested in it, at s=1 (the fused path) and at
  s=4 (``step`` + the render); ``Impulses.from_lists`` and each wrapper
  called directly record their span;
* with no profiler recording no span calls ``record_function``;
* a step's outputs are bit-equal with and without a profiler recording;
* ``utils.profiling.trace`` writes the spans into its Chrome trace.
"""

import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from esp32_fluid_simulation_tpu_torch import Impulses, SimConfig, init_state
from esp32_fluid_simulation_tpu_torch.models.stable_fluids import (
    make_step_render)
from esp32_fluid_simulation_tpu_torch.ops.cuda.advect import advect_kernel
from esp32_fluid_simulation_tpu_torch.ops.cuda.project import project_fused
from esp32_fluid_simulation_tpu_torch.render.cuda_upscale import (
    render_rgb565_kernel)
from esp32_fluid_simulation_tpu_torch.spans import span
from esp32_fluid_simulation_tpu_torch.utils import profiling

POS = [(5, 7), (12, 20), (18, 9)]
VEL = [(40.0, -25.0), (-30.0, 10.0), (5.0, 35.0)]


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
    assert names == ["fluid.impulses", "fluid.step_render", "fluid.k2.advect",
                     "fluid.k1.project", "fluid.k2.advect"]
    outer = events[1].time_range
    for e in events[2:]:
        assert outer.start <= e.time_range.start <= e.time_range.end \
            <= outer.end, e.name
    assert events[0].time_range.end <= outer.start


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
    spans = [e["name"] for e in events
             if e.get("cat") == "user_annotation"
             and e.get("name", "").startswith("fluid.")]
    assert sorted(spans) == sorted(["fluid.impulses", "fluid.step_render",
                                    "fluid.k2.advect", "fluid.k1.project",
                                    "fluid.k2.advect"])
