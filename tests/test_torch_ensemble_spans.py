"""The ensemble's profiler spans and its layout counter on the CPU.

* under a ``torch.profiler`` one ensemble step on the kernel path
  (``advect_impl="pallas"``, whose wrappers run their plain versions here)
  records the feed's ``fluid.impulses``, then ``fluid.ensemble_step`` with
  ``fluid.ensemble.overlay`` once and the kernel wrappers nested in it, and
  no ``fluid.ensemble.layout``: the wrappers take the member stack as it
  lies; the eager route records the layout twice and no overlay, the
  member loop (``mode="vmap"``) no layout;
* ``models.ensemble.layout_conversions()`` advances 2 a step and 2 a
  rollout call on the eager route, not at all on the kernel route or in
  the member loop; the kernel route's wrappers take the member stack 3
  times a step (K2 twice, K1 once), and on the CPU, where their plain
  versions run, ``stack_launches`` stays where it was;
* with no profiler recording no span calls ``record_function``, and a
  step's outputs are bit-equal with and without a profiler recording.
"""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from esp32_fluid_simulation_tpu_torch import (Impulses, SimConfig,
                                              init_ensemble,
                                              make_ensemble_multi_step,
                                              make_ensemble_step,
                                              stack_schedule)
from esp32_fluid_simulation_tpu_torch.models.ensemble import (
    layout_conversions)
from stack_spy import spy_stack_calls, stack_launches

N = 4
MEMBER = [0, 1, 1, 3]
POS = [(5, 7), (12, 20), (18, 9), (30, 40)]
VEL = [(40.0, -25.0), (-30.0, 10.0), (5.0, 35.0), (20.0, 20.0)]
KERNEL_STEP = ["fluid.ensemble_step", "fluid.ensemble.overlay",
               "fluid.k2.advect", "fluid.k1.project", "fluid.k2.advect"]
EAGER_STEP = ["fluid.ensemble_step", "fluid.ensemble.layout",
              "fluid.ensemble.layout"]


def _cfg(advect_impl="pallas"):
    return SimConfig(shape=(32, 48), advect_impl=advect_impl)


def _state(cfg):
    st = init_ensemble(cfg, N, device="cpu")
    g = torch.Generator().manual_seed(7)
    return st._replace(velocity=20 * torch.randn(st.velocity.shape,
                                                 generator=g))


def _feed(cfg):
    return Impulses.from_member_lists(cfg, N, MEMBER, POS, VEL,
                                      device="cpu")


def _fed_step(cfg, mode="auto"):
    return make_ensemble_step(cfg, mode=mode)(_state(cfg), _feed(cfg))


def _recorded(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    events = sorted((e for e in prof.events()
                     if e.name.startswith("fluid.")),
                    key=lambda e: e.time_range.start)
    return out, events


@pytest.mark.parametrize("advect_impl,want", [("pallas", KERNEL_STEP),
                                              ("auto", EAGER_STEP)])
def test_step_records_its_spans_inside_the_ensemble_step(advect_impl, want):
    _, events = _recorded(lambda: _fed_step(_cfg(advect_impl)))
    assert [e.name for e in events] == ["fluid.impulses"] + want
    outer = events[1].time_range
    for e in events[2:]:
        assert outer.start <= e.time_range.start <= e.time_range.end \
            <= outer.end, e.name


def test_member_loop_records_the_step_and_no_layout():
    _, events = _recorded(lambda: _fed_step(_cfg("auto"), mode="vmap"))
    names = [e.name for e in events]
    assert names[:2] == ["fluid.impulses", "fluid.ensemble_step"]
    assert "fluid.ensemble.layout" not in names
    assert "fluid.ensemble.overlay" not in names


# (advect_impl, mode, steps, layout conversions, wrapper calls on a stack)
@pytest.mark.parametrize("advect_impl,mode,steps,want,stacked", [
    ("auto", "auto", 1, 2, 0), ("auto", "auto", 3, 6, 0),
    ("auto", "vmap", 2, 0, 0), ("pallas", "auto", 1, 0, 3),
    ("pallas", "auto", 3, 0, 9)])
def test_layout_counter_advances_two_a_step(advect_impl, mode, steps, want,
                                            stacked, monkeypatch):
    cfg = _cfg(advect_impl)
    step = make_ensemble_step(cfg, mode=mode)
    st, fed = _state(cfg), _feed(cfg)
    seen = spy_stack_calls(monkeypatch)
    before = layout_conversions(), stack_launches()
    for _ in range(steps):
        st = step(st, fed)
    assert layout_conversions() - before[0] == want
    assert seen["calls"] == stacked
    assert stack_launches() == before[1]


@pytest.mark.parametrize("advect_impl,want,stacked", [("auto", 2, 0),
                                                      ("pallas", 0, 9)])
def test_rollout_converts_twice_a_call(advect_impl, want, stacked,
                                       monkeypatch):
    cfg = _cfg(advect_impl)
    run = make_ensemble_multi_step(cfg)
    seen = spy_stack_calls(monkeypatch)
    before = layout_conversions(), stack_launches()
    run(_state(cfg), stack_schedule([_feed(cfg)] * 3))
    assert layout_conversions() - before[0] == want
    assert seen["calls"] == stacked
    assert stack_launches() == before[1]


def test_spans_change_no_output(monkeypatch):
    def refused(name):
        raise AssertionError(f"record_function({name!r}) with no profiler")

    cfg = _cfg("pallas")
    plain = _fed_step(cfg)
    monkeypatch.setattr(torch.profiler, "record_function", refused)
    untraced = _fed_step(cfg)
    monkeypatch.undo()
    traced, _ = _recorded(lambda: _fed_step(cfg))
    for st in (untraced, traced):
        assert torch.equal(st.velocity, plain.velocity)
        assert torch.equal(st.color, plain.color)
