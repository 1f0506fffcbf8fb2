"""The 3D smoke plume's profiler spans (``spans.py``) on the CPU.

* under a ``torch.profiler`` one plume step (K7 and K9 forced, whose
  wrappers run their plain versions here) records ``fluid.smoke_step``
  with ``fluid.k7.advect3d`` twice and ``fluid.k9.sor3d`` once nested in
  it; on the card, at 128^3, the step also nests ``fluid.k8.fd3d`` twice
  and its MIP frame records ``fluid.k10.mip`` after it;
* each 3D wrapper called directly records its span;
* with no profiler recording no span calls ``record_function``, and the
  step's outputs are bit-equal with and without a profiler recording.
"""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from esp32_fluid_simulation_tpu_torch import (Impulses, SmokeConfig,
                                              init_smoke, make_smoke_step,
                                              render_smoke)
from esp32_fluid_simulation_tpu_torch.ops.cuda.advect3d import (
    advect3d_kernel)
from esp32_fluid_simulation_tpu_torch.ops.cuda.fd3d import (
    divergence3d, subtract_gradient3d)
from esp32_fluid_simulation_tpu_torch.ops.cuda.sor3d import sor3d_solve
from esp32_fluid_simulation_tpu_torch.render.cuda_smoke import (
    render_smoke_mip_kernel)

CFG = SmokeConfig(shape=(10, 12, 14), advect_impl="pallas",
                  sor_impl="pallas")
POS = [(6, 5, 7), (6, 8, 3)]
VEL = [(0.0, 20.0, -15.0), (0.0, -10.0, 25.0)]
STEP = ["fluid.smoke_step", "fluid.k7.advect3d", "fluid.k7.advect3d",
        "fluid.k9.sor3d"]
CARD_STEP = ["fluid.smoke_step", "fluid.k7.advect3d", "fluid.k7.advect3d",
             "fluid.k8.fd3d", "fluid.k9.sor3d", "fluid.k8.fd3d"]


def _step_and_frame(cfg=CFG, device="cpu"):
    st = init_smoke(cfg, device=device)
    g = torch.Generator().manual_seed(5)
    st = st._replace(
        velocity=torch.randn(st.velocity.shape, generator=g).to(device),
        density=torch.rand(st.density.shape, generator=g)
        .to(device, st.density.dtype))
    imp = Impulses.from_lists(cfg, POS, VEL, device=device)
    st = make_smoke_step(cfg)(st, imp)
    return st, render_smoke(st.density)


def _direct(which):
    g = torch.Generator().manual_seed(3)
    vel = torch.randn((3, 6, 7, 8), generator=g)
    if which == "fluid.k7.advect3d":
        return advect3d_kernel(vel, vel, 1 / 30, True, max_disp=2)
    if which == "fluid.k8.fd3d":
        return subtract_gradient3d(vel, divergence3d(vel), 1.0)
    if which == "fluid.k9.sor3d":
        return sor3d_solve(vel[0].contiguous(), 1.0, 3, 1.5)
    return render_smoke_mip_kernel(torch.rand((6, 7, 8), generator=g))


def _recorded(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    events = sorted((e for e in prof.events()
                     if e.name.startswith("fluid.")),
                    key=lambda e: e.time_range.start)
    return out, events


def _assert_nested(events, step, after):
    assert [e.name for e in events] == ["fluid.impulses"] + step + after
    outer = events[1].time_range
    for e in events[2:len(step) + 1]:
        assert outer.start <= e.time_range.start <= e.time_range.end \
            <= outer.end, e.name
    for e in events[len(step) + 1:]:
        assert e.time_range.start >= outer.end, e.name


def test_step_records_the_3d_wrappers_inside_smoke_step():
    _, events = _recorded(_step_and_frame)
    _assert_nested(events, STEP, [])


@pytest.mark.gpu
def test_card_step_and_frame_record_every_3d_wrapper():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (K8 and K10 run only there)")
    cfg = SmokeConfig(shape=(128, 128, 128))
    _, events = _recorded(lambda: _step_and_frame(cfg, "cuda"))
    _assert_nested(events, CARD_STEP, ["fluid.k10.mip"])


@pytest.mark.parametrize("name", ["fluid.k7.advect3d", "fluid.k8.fd3d",
                                  "fluid.k9.sor3d", "fluid.k10.mip"])
def test_direct_call_records_its_span(name):
    _, events = _recorded(lambda: _direct(name))
    want = [name] * (2 if name == "fluid.k8.fd3d" else 1)
    assert [e.name for e in events] == want


def test_no_record_function_without_a_profiler(monkeypatch):
    def refused(name):
        raise AssertionError(f"record_function({name!r}) with no profiler")

    plain_state, plain_frame = _step_and_frame()
    monkeypatch.setattr(torch.profiler, "record_function", refused)
    state, frame = _step_and_frame()
    monkeypatch.undo()
    (traced_state, traced_frame), _ = _recorded(_step_and_frame)
    for st in (state, traced_state):
        for name in ("velocity", "density", "temperature"):
            assert torch.equal(getattr(st, name), getattr(plain_state, name))
    assert torch.equal(frame, plain_frame)
    assert torch.equal(traced_frame, plain_frame)
