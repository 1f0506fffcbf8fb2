"""The program's own profiler spans (``fluid.*``) under the harness's: the
breakdown names them where it read a bare ``bench.step``, and every other
part of the trace's summary reads as it does without them.

    python -m pytest bench_port/tests -q
"""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from bench_port import core, tracing  # noqa: E402
from bench_port.tests.test_bench_port import _x  # noqa: E402


def _program_trace():
    """One step: the feed's upload and synchronise inside
    ``fluid.impulses``; three wrappers inside ``fluid.step_render``, the
    card idle under the first wrapper before its launch and after the
    last kernel while the step's span is still open."""
    return [
        _x("bench.feed", "user_annotation", 0, 40),
        _x("fluid.impulses", "user_annotation", 1, 38),
        _x("aten::to", "cpu_op", 2, 28),
        _x("cudaMemcpyAsync", "cuda_runtime", 3, 2, corr=1),
        _x("cudaStreamSynchronize", "cuda_runtime", 6, 14),
        _x("cudaMemcpy", "cuda_runtime", 33, 3, corr=4),
        _x("bench.step", "user_annotation", 42, 78),
        _x("fluid.step_render", "user_annotation", 43, 75),
        _x("fluid.k2.advect", "user_annotation", 44, 16),
        _x("cudaLaunchKernel", "cuda_runtime", 58, 1, corr=2),
        _x("fluid.k1.project", "user_annotation", 62, 13),
        _x("cudaLaunchKernel", "cuda_runtime", 73, 1, corr=3),
        _x("fluid.k2.advect", "user_annotation", 78, 12),
        _x("cudaLaunchKernel", "cuda_runtime", 88, 1, corr=5),
        _x("cudaDeviceSynchronize", "cuda_runtime", 121, 1),
        _x("Memcpy HtoD", "gpu_memcpy", 7, 2, corr=1, pid=0),
        _x("Memcpy HtoD", "gpu_memcpy", 34, 1, corr=4, pid=0),
        _x("void advect_kernel<float>", "kernel", 60, 40, corr=2, pid=0),
        _x("void project_tile_kernel<float>", "kernel", 100, 10, corr=3,
           pid=0),
        _x("void advect_kernel<bf16>", "kernel", 110, 3, corr=5, pid=0),
    ]


def _bare(events):
    return [e for e in events if not e["name"].startswith("fluid.")]


# the card's idle intervals (0-7, 9-34, 35-60, 113-122 us), each given
# whole to what the host does at its midpoint (3.5, 21.5, 47.5, 117.5)
SPANNED_GAPS = {"bench.feed > cudaMemcpyAsync": 7e-6,
                "bench.feed > aten::to": 25e-6,
                "bench.step > fluid.k2.advect": 25e-6,
                "bench.step > fluid.step_render": 9e-6}
BARE_GAPS = {"bench.feed > cudaMemcpyAsync": 7e-6,
             "bench.feed > aten::to": 25e-6,
             "bench.step": 34e-6}


@pytest.mark.parametrize("spans,want", [(True, SPANNED_GAPS),
                                        (False, BARE_GAPS)])
def test_breakdown_names_the_programs_spans(spans, want):
    events = _program_trace() if spans else _bare(_program_trace())
    gaps = dict(tracing.summarize(events, steps=1)["idle_gaps"])
    assert gaps == pytest.approx(want)


@pytest.mark.parametrize("metric", ["entry.syncs_per_step",
                                    "eager.launches_per_step",
                                    "device.idle_pct"])
def test_programs_spans_leave_the_rest_unchanged(metric):
    """Every key but the breakdown's labels, and every reader of the
    trace, reads the same with and without the program's spans."""
    spanned = tracing.summarize(_program_trace(), steps=1)
    bare = tracing.summarize(_bare(_program_trace()), steps=1)
    for key in ("steps", "kernels", "device", "runtime", "window_s",
                "busy_s", "device_ops"):
        assert spanned[key] == bare[key], key
    assert spanned["busy_s"] == pytest.approx(56e-6)
    reader = core.load_module(ROOT / "bench_port/metrics" / f"{metric}.py")
    assert reader.read(spanned, {}) == reader.read(bare, {})
    if metric == "entry.syncs_per_step":
        # the feed's synchronise and blocking copy; the harness's own
        # synchronise, outside bench.step, is not counted
        assert reader.read(spanned, {}) == 2
