"""Hand-worked cases of the span readers (``entry.host_us``,
``entry.glue_us``, ``kernels.wrapper_us``, ``eager.drain_us``,
``device.program_wait_us``): the program's spans nested in the harness's,
the card idle under a wrapper, under the step's glue and under the
harness, a trace with no ``fluid.*`` span and one with no drain.

    python -m pytest bench_port/tests -q
"""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from bench_port import core, program_spans, tracing  # noqa: E402
from bench_port.tests.test_bench_port import BENCHMARK, _x  # noqa: E402

READERS = ["entry.host_us", "entry.glue_us", "kernels.wrapper_us",
           "eager.drain_us", "device.program_wait_us"]


def _read(name, summary):
    reader = core.load_module(ROOT / "bench_port/metrics" / f"{name}.py")
    return reader.read(summary, {})


def _plume_trace():
    """One plume-like step (us): the feed's span, then the step's with a
    wrapper (K7), the drain and another wrapper (K9) in it, then the
    frame's with K10 in it; five stretches on the card."""
    return [
        _x("bench.traffic", "user_annotation", 0, 5),
        _x("bench.feed", "user_annotation", 5, 20),
        _x("fluid.impulses", "user_annotation", 6, 18),
        _x("cudaMemcpyAsync", "cuda_runtime", 10, 2, corr=1),
        _x("bench.step", "user_annotation", 30, 100),
        _x("fluid.smoke_step", "user_annotation", 31, 69),
        _x("fluid.k7.advect3d", "user_annotation", 35, 10),
        _x("cudaLaunchKernel", "cuda_runtime", 43, 1, corr=2),
        _x("fluid.drain", "user_annotation", 50, 30),
        _x("aten::index", "cpu_op", 52, 8),
        _x("cudaLaunchKernel", "cuda_runtime", 58, 1, corr=3),
        _x("fluid.k9.sor3d", "user_annotation", 85, 10),
        _x("cudaLaunchKernel", "cuda_runtime", 93, 1, corr=4),
        _x("fluid.render", "user_annotation", 102, 23),
        _x("fluid.k10.mip", "user_annotation", 110, 10),
        _x("cudaLaunchKernel", "cuda_runtime", 118, 1, corr=5),
        _x("bench.event", "user_annotation", 130, 2),
        _x("bench.sync", "user_annotation", 132, 8),
        _x("cudaDeviceSynchronize", "cuda_runtime", 133, 6),
        _x("Memcpy HtoD", "gpu_memcpy", 12, 2, corr=1, pid=0),
        _x("advect3d_kernel", "kernel", 44, 26, corr=2, pid=0),
        _x("index_elementwise_kernel", "kernel", 72, 2, corr=3, pid=0),
        _x("sor3d_pass_kernel", "kernel", 95, 10, corr=4, pid=0),
        _x("smoke_mip_kernel", "kernel", 119, 2, corr=5, pid=0),
    ]


# by hand, in us: the program's spans [6, 24], [31, 100], [102, 125] (18 +
# 69 + 23); the wrappers [35, 45], [85, 95], [110, 120]; the feed's 18; the
# drain [50, 80]; the card busy 12-14, 44-70, 72-74, 95-105, 119-121, so
# idle inside the program's spans 16 + (69 - 26 - 2 - 5) + (23 - 3 - 2)
PLUME = {"entry.host_us": 110.0, "entry.glue_us": 110.0 - 30 - 18,
         "kernels.wrapper_us": 30.0, "eager.drain_us": 30.0,
         "device.program_wait_us": 16.0 + 36 + 18}


@pytest.mark.parametrize("name", READERS)
@pytest.mark.parametrize("steps", [1, 2])
def test_nested_spans_by_hand(name, steps):
    summary = tracing.summarize(_plume_trace(), steps=steps)
    assert _read(name, summary) == pytest.approx(PLUME[name] / steps)


@pytest.mark.parametrize("name", READERS)
def test_no_drain_reads_none_for_the_drain_alone(name):
    """The parent's program has no ``fluid.drain``: its stretch is still
    the step's glue, so only the drain's reader changes, to None."""
    events = [e for e in _plume_trace() if e["name"] != "fluid.drain"]
    got = _read(name, tracing.summarize(events, steps=1))
    if name == "eager.drain_us":
        assert got is None
    else:
        assert got == pytest.approx(PLUME[name])


@pytest.mark.parametrize("name", READERS)
def test_no_program_span_reads_none(name):
    events = [e for e in _plume_trace() if not e["name"].startswith("fluid.")]
    summary = tracing.summarize(events, steps=1)
    assert summary["busy_s"] > 0 and summary["spans"]
    assert _read(name, summary) is None
    assert _read(name, tracing.summarize([], steps=1)) is None


def _idle_trace(idle):
    """A step whose span holds K1's wrapper [10, 30] and glue, then the
    harness's event [100, 120]; the card busy over [0, 120] but for
    ``idle``."""
    a, b = idle
    return [
        _x("bench.step", "user_annotation", 0, 100),
        _x("fluid.step_render", "user_annotation", 0, 100),
        _x("fluid.k1.project", "user_annotation", 10, 20),
        _x("bench.event", "user_annotation", 100, 20),
        _x("project_tile_kernel", "kernel", 0, a, pid=0),
        _x("advect_kernel", "kernel", b, 120 - b, pid=0),
    ]


# (the card's idle stretch, what the breakdown names it after, us of it
# the program waited for); a stretch across the step's end goes whole to
# what the host does at its midpoint in the breakdown, in part to the
# program in the reader
@pytest.mark.parametrize("idle,where,want", [
    ((15, 25), "fluid.k1.project", 10.0),
    ((40, 50), "fluid.step_render", 10.0),
    ((95, 105), "bench.event", 5.0),
    ((105, 115), "bench.event", 0.0)])
def test_idle_under_a_wrapper_the_glue_and_the_harness(idle, where, want):
    summary = tracing.summarize(_idle_trace(idle), steps=1)
    gaps = dict(summary["idle_gaps"])
    assert any(label.endswith(where) for label in gaps), gaps
    assert _read("device.program_wait_us", summary) == pytest.approx(want)
    assert _read("entry.host_us", summary) == pytest.approx(100.0)
    assert _read("kernels.wrapper_us", summary) == pytest.approx(20.0)
    assert _read("entry.glue_us", summary) == pytest.approx(80.0)


@pytest.mark.parametrize("a,b,want", [
    ([[0, 10], [20, 30]], [[5, 25]], 10.0),
    ([[0, 10]], [[10, 20]], 0.0),
    ([[0, 100]], [[1, 2], [3, 5], [90, 120]], 13.0),
    ([], [[0, 1]], 0.0)])
def test_overlap_of_merged_lists(a, b, want):
    assert program_spans.overlap(a, b) == pytest.approx(want)
    assert program_spans.overlap(b, a) == pytest.approx(want)


@pytest.mark.parametrize("name,wrapper", [
    ("fluid.k1.project", True), ("fluid.k10.mip", True),
    ("fluid.k2.advect", True), ("fluid.ensemble.overlay", True),
    ("fluid.ensemble_step", False), ("fluid.ensemble.plan", False),
    ("fluid.ensemble.move", False),
    ("fluid.drain", False), ("fluid.impulses", False),
    ("fluid.render", False), ("fluid.k1", False), ("bench.step", False)])
def test_wrapper_names(name, wrapper):
    assert program_spans.wrapper(name) is wrapper


def test_readers_are_listed_with_their_cells():
    per_layer = {m["name"]: m for m in BENCHMARK["per_layer"]}
    cells = [w["name"] for w in BENCHMARK["workloads"]]
    for name in READERS:
        m = per_layer[name]
        assert (m["source"], m["moves"], m["unit"]) == ("program_span",
                                                        "step_ms", "us")
        want = ["smoke256.plume"] if name == "eager.drain_us" else cells
        assert m["workloads"] == want
