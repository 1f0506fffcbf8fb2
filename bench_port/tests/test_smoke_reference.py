"""CPU tests of what the plume cell ``smoke256.plume`` brings: the plain 3D
reference against the port, the stir generator, the byte counts of the 3D
kernels and the cell's readers.

    python -m pytest bench_port/tests -q
"""

import json
import math
import re
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from bench_port import core, sizes3d  # noqa: E402

CELL = "smoke256.plume"
BIG_SEED = 2 ** 40 + 777
BW = 3.35e12


def _mod(path):
    return core.load_module(ROOT / "bench_port" / path)


def _cell():
    return core.find_cell(CELL)


def _small_sim():
    return _mod("entries/smoke_mip.py").cpu_sim(_cell()["config"]["sim"])


def _port_steps(sim, traffic, seed, steps, lists=None):
    """The port stepped ``steps`` times under the stir: the last step's
    input, lists and output.  ``lists(t)`` replaces the generator's."""
    entry = _mod("entries/smoke_mip.py").build(sim, 1, "cpu")
    gen = _mod("traffic/stir.py").make(traffic, sim["shape"], seed)
    for t in range(steps):
        pos, vel = lists(t) if lists else gen.step(t)
        before = {k: v.clone() for k, v in entry.inputs().items()}
        entry.step(entry.feed(pos, vel))
    return before, pos, vel, entry.outputs()


def test_reference_equals_the_port():
    """The reference stepped from the port's state after a dozen stirred
    steps equals the port's step to the bit (the kernels' plain versions,
    which the kernels equal on the card); the control, one precision
    down, reads above 0 on every number."""
    sim, traffic = _small_sim(), _cell()["traffic"]
    ref = _mod("reference/smoke_mip.py")
    before, pos, vel, got = _port_steps(sim, traffic, BIG_SEED, 12)
    want = ref.step(before, pos, vel, sim, 1)
    assert ref.compare(got, want) == dict.fromkeys(ref.NUMBERS, 0.0)
    assert float(got["density"].float().max()) > 0
    lower = ref.step(ref.lower_state(before, sim), pos, vel, sim, 1,
                     lower=True)
    numbers = ref.compare(lower, want)
    assert all(v > 0 for v in numbers.values()), numbers
    assert lower["density"].dtype == torch.float8_e4m3fn


def test_reference_stands_alone():
    """The reference imports nothing of the port or of JAX and turns TF32
    off for its float32 arithmetic."""
    text = (ROOT / "bench_port/reference/smoke_mip.py").read_text()
    assert not re.search(r"^\s*(from|import)\s+(esp32|jax|bench_port)",
                         text, re.M)
    assert "torch.backends.cuda.matmul.allow_tf32 = False" in text
    assert "torch.backends.cudnn.allow_tf32 = False" in text


def test_stir_is_seed_stable_and_its_lists_count():
    traffic = _cell()["traffic"]
    make = _mod("traffic/stir.py").make
    shape = (256, 256, 256)
    a, b, c = (make(traffic, shape, s) for s in
               (BIG_SEED, BIG_SEED, BIG_SEED + 1))
    assert a.step(7) == b.step(7)
    assert a.step(7)[0] != c.step(7)[0]
    for g in (a, c):
        pos, vel = g.step(11)
        assert len(pos) == 8
        # a ring of radius 25.6 in the plane z = 154, around the column
        assert all(z == 154 for z, _, _ in pos)
        for (_, i, j), (vz, vi, vj) in zip(pos, vel):
            assert abs(math.hypot(i - 128, j - 128) - 25.6) < 1
            assert vz == 0 and math.isclose(math.hypot(vi, vj), 45.0)
    # half the lists is another step: the port's velocity moves
    sim = _small_sim()
    g = make(traffic, sim["shape"], BIG_SEED)
    full = _port_steps(sim, traffic, BIG_SEED, 3)[3]
    half = _port_steps(sim, traffic, BIG_SEED, 3,
                       lists=lambda t: tuple(x[::2] for x in g.step(t)))[3]
    assert not torch.equal(full["velocity"], half["velocity"])


def test_sizes3d_by_hand():
    sim = _cell()["config"]["sim"]
    n = 256 ** 3
    assert sizes3d.velocity_bytes(sim) == 3 * n * 4 == 201_326_592
    assert sizes3d.scalar_bytes(sim) == n * 2 == 33_554_432
    assert sizes3d.pressure_bytes(sim) == n * 4
    assert sizes3d.frame_bytes(sim) == 256 * 256 * 2
    mb = {f: round(getattr(sizes3d, f)(sim) / 1e6, 2) for f in
          ("advect_bytes", "fd_bytes", "sor_bytes", "mip_bytes",
           "step_bytes")}
    assert mb == {"advect_bytes": 738.2, "fd_bytes": 738.2,
                  "sor_bytes": 134.22, "mip_bytes": 33.69,
                  "step_bytes": 537.0}
    assert sizes3d.fd_bytes(sim) == 268_435_456 + 469_762_048
    # the least times at 3.35 TB/s (ms): 0.2204, 0.2204, 0.0401, 0.0101
    assert [round(1e3 * getattr(sizes3d, f)(sim) / BW, 4) for f in
            ("advect_bytes", "fd_bytes", "sor_bytes", "mip_bytes",
             "step_bytes")] == [0.2204, 0.2204, 0.0401, 0.0101, 0.1603]


READERS = {"k7_advect3d_roofline": ("advect3d_kernel", "advect_bytes"),
           "k8_fd3d_roofline": ("divergence3d_kernel", "fd_bytes"),
           "k9_sor3d_roofline": ("sor3d_pass_kernel", "sor_bytes"),
           "k10_mip_roofline": ("smoke_mip_kernel", "mip_bytes")}


@pytest.mark.parametrize("metric", sorted(READERS) + ["smoke.step_roofline"])
def test_roofline_readers_hold_at_the_bound(metric):
    """A kernel or step that takes exactly its least time reads 100%; with
    no published bandwidth, nothing."""
    sim = _cell()["config"]["sim"]
    steps = 5
    kernels = []
    for name, (kernel, fn) in READERS.items():
        least = getattr(sizes3d, fn)(sim) / BW
        parts = (["void divergence3d_kernel(float const*)",
                  "void subtract_gradient3d_kernel(float const*)"]
                 if name == "k8_fd3d_roofline"
                 else [f"void {kernel}<float>(float*)"])
        for p in parts:
            kernels.append({"name": p, "seconds": steps * least / len(parts),
                            "eager": False})
    # another kernel the readers must not count
    kernels.append({"name": "void advect_kernel<float>(float*)",
                    "seconds": 1.0, "eager": False})
    summary = {"steps": steps, "kernels": kernels}
    ctx = {"sim": sim, "scaling": 1, "hbm_bytes_per_s": BW,
           "step_s": sizes3d.step_bytes(sim) / BW}
    reader = _mod(f"metrics/{metric}.py")
    assert reader.read(summary, ctx) == pytest.approx(100.0)
    assert reader.read(summary, dict(ctx, hbm_bytes_per_s=None)) is None
    if metric != "smoke.step_roofline":
        assert reader.read(dict(summary, kernels=kernels[-1:]), ctx) is None


def test_smoke_host_us_by_hand():
    """Two traced steps: the step's span less its kernel wrappers' spans
    (which may nest or overlap), in us a step; None where the program has
    no such span."""
    reader = _mod("metrics/smoke.host_us.py")
    us = 1e-6
    spans = {
        "bench.step": [[0, 200 * us], [300 * us, 480 * us]],
        "fluid.smoke_step": [[10 * us, 150 * us], [310 * us, 470 * us]],
        # step 1: 20-40, 50-70 (with a nested span), 100-120 -> 60 of 140
        "fluid.k7.advect3d": [[20 * us, 40 * us], [50 * us, 70 * us]],
        "fluid.k8.fd3d": [[55 * us, 65 * us], [100 * us, 120 * us]],
        # step 2: 320-400 -> 80 of 160
        "fluid.k9.sor3d": [[320 * us, 400 * us]],
        "fluid.k10.mip": [[150 * us, 160 * us], [470 * us, 480 * us]],
        "fluid.impulses": [[0, 9 * us]],
    }
    summary = {"steps": 2, "spans": spans}
    assert reader.read(summary, {}) == pytest.approx((80 + 80) / 2)
    assert reader.read({"steps": 2, "spans": {"bench.step": [[0, 1]]}},
                       {}) is None


def test_cell_entries_keep_to_the_issue():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    conf = next(c for c in bench["configs"] if c["name"] == "smoke256")
    assert conf["reduced"] == ["advect_impl", "sor_impl"]
    cell = next(w for w in bench["workloads"] if w["name"] == CELL)
    assert cell["chips"] == 1 and cell["traffic"] == "plume"
    own = set(READERS) | {"smoke.step_roofline", "smoke.host_us"}
    shared = {"entry.syncs_per_step", "eager.launches_per_step",
              "device.idle_pct"}
    mine = [m for m in bench["per_layer"] if CELL in m["workloads"]]
    assert {m["name"] for m in mine} == own | shared
    assert all(m["moves"] == "step_ms" for m in mine)
    assert all(m["workloads"] == [CELL] for m in mine if m["name"] in own)
    assert all(m["workloads"][-1] == CELL for m in mine
               if m["name"] in shared)
    limits = json.loads((ROOT / f"bench_port/limits/{CELL}.json")
                        .read_text())["limits"]
    assert limits["frame_pct"] == 0
