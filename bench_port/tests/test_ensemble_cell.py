"""CPU self-test of the ensemble cell's own files: the member swirl against
the program's scripted swirl, the byte counts of the member stacks, and
the five readers on hand-made summaries.

    python -m pytest bench_port/tests -q
"""

import json
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from bench_port import core, sizes_members  # noqa: E402

CELL = "cfg4_256.swirl"
BIG_SEED = 2 ** 40 + 12345
BW = 3.35e12


def _params():
    return json.loads((ROOT / "bench_port/traffic/swirl.members.json")
                      .read_text())


def _gen(shape, seed=BIG_SEED):
    return core.load_module(ROOT / "bench_port/traffic/member_swirl.py").make(
        _params(), shape, seed)


def _reader(name):
    return core.load_module(ROOT / "bench_port/metrics" / f"{name}.py")


def _sim():
    return core.find_cell(CELL)["config"]["sim"]


# -- traffic --------------------------------------------------------------

@pytest.mark.parametrize("t", [0, 1, 17, 400])
def test_member_swirl_is_the_programs_scripted_swirl(t):
    """Member m at step t gets ``scripted_swirl`` at step ``t + 7m`` on a
    member-sized grid, the starting angle pinned to the program's 0."""
    from esp32_fluid_simulation_tpu_torch import SimConfig
    from esp32_fluid_simulation_tpu_torch.io_host.touch import scripted_swirl

    n, h, w = 6, 61, 81
    gen = _gen((n, h, w))
    gen.grid.phase0 = 0.0
    member, pos, vel = gen.step(t)
    assert member.tolist() == [m for m in range(n) for _ in range(8)]
    cfg = SimConfig(shape=(h, w))
    for m in range(n):
        want = scripted_swirl(cfg, t + 7 * m, device="cpu")
        assert want.active.sum() == 8
        mine = slice(8 * m, 8 * m + 8)
        assert torch.equal(torch.tensor(pos[mine], dtype=torch.int32),
                           want.pos[:8])
        assert torch.equal(torch.tensor(vel[mine], dtype=torch.float32),
                           want.velocity[:8])


def test_member_swirl_seed_moves_the_pokes_not_the_work():
    shape = _sim()["shape"]
    a, b, c = _gen(shape), _gen(shape), _gen(shape, BIG_SEED + 1)
    assert all(np.array_equal(x, y) for x, y in zip(a.step(5), b.step(5)))
    assert not np.array_equal(a.step(5)[1], c.step(5)[1])
    for g in (a, c):
        member, pos, vel = g.step(9)
        assert len(member) == len(pos) == len(vel) == 256 * 8
        assert all(0 <= i < 256 and 0 <= j < 256 for i, j in pos)
        assert all(math.isclose(math.hypot(*v), 300.0) for v in vel)


def test_member_swirl_reuse_equals_computing_every_member():
    """Step after step, each reusing the step ``member_stride`` before,
    the pokes equal a fresh generator's, which computes every member
    anew; the arrays handed over cannot be written."""
    shape = (5, 40, 56)
    run = _gen(shape)
    for t in range(30):
        got = run.step(t)
        want = _gen(shape).step(t)
        assert all(np.array_equal(x, y) for x, y in zip(got, want))
        assert not any(x.flags.writeable for x in got)


def test_half_the_lists_drops_every_other_poke():
    member, pos, vel = _gen((4, 32, 48)).step(3)
    half = [x[::2] for x in (member, pos, vel)]
    assert half[0].tolist() == [m for m in range(4) for _ in range(4)]
    assert half[1].tolist() == pos.tolist()[::2] and len(half[2]) == 16


# -- byte counts ------------------------------------------------------------

def test_member_bytes_by_hand():
    sim = _sim()
    vel, dye = 256 * 2 * 256 * 256 * 4, 256 * 3 * 256 * 256 * 4
    assert sizes_members.velocity_bytes(sim) == vel == 134_217_728
    assert sizes_members.dye_bytes(sim) == dye == 201_326_592
    assert round(sizes_members.project_bytes(sim) / 1e6, 1) == 268.4
    assert round(sizes_members.advect_bytes(sim) / 1e6, 1) == 805.3
    assert round(sizes_members.step_bytes(sim) / 1e6, 1) == 671.1


# -- the readers ------------------------------------------------------------

MEMBER_COUNTS = {"K1": 1.0, "K1_member": 1.0, "K2": 2.0, "K2_member": 2.0,
                 "K2_overlay": 1.0, "layouts": 2.0}


def _summary(counters, steps=4, spans=None):
    """``steps`` steps each running K1 and K2 at exactly their least
    time."""
    sim = _sim()
    k1 = sizes_members.project_bytes(sim) / BW
    k2 = sizes_members.advect_bytes(sim) / BW
    kernels = [{"name": "void project_tile_kernel<true>(float*)",
                "seconds": k1, "eager": False}] * steps
    kernels += [{"name": "void advect_kernel<float, 2>(float*)",
                 "seconds": k2 / 2, "eager": False}] * (2 * steps)
    return {"steps": steps, "kernels": kernels, "counters": counters,
            "spans": spans or {}}


def _ctx(step_s=None, bw=BW):
    return {"sim": _sim(), "scaling": 1, "hbm_bytes_per_s": bw,
            "step_s": step_s}


@pytest.mark.parametrize("metric", ["k6_project_member_roofline",
                                    "k6_advect_member_roofline"])
def test_member_rooflines_hold_at_the_bound(metric):
    reader = _reader(metric)
    assert reader.read(_summary(MEMBER_COUNTS), _ctx()) == pytest.approx(100)
    assert reader.read(_summary(MEMBER_COUNTS), _ctx(bw=None)) is None
    assert reader.read(dict(_summary(MEMBER_COUNTS), kernels=[]),
                       _ctx()) is None


@pytest.mark.parametrize("metric,key", [
    ("k6_project_member_roofline", "K1"),
    ("k6_advect_member_roofline", "K2")])
def test_member_rooflines_read_nothing_beside_another_launch(metric, key):
    """A launch of the kernel that was not a member launch: None."""
    counters = dict(MEMBER_COUNTS, **{key: MEMBER_COUNTS[key] + 0.25})
    assert _reader(metric).read(_summary(counters), _ctx()) is None
    assert _reader(metric).read(_summary({}), _ctx()) is None


def test_step_roofline_holds_at_the_bound():
    least = sizes_members.step_bytes(_sim()) / BW
    reader = _reader("ensemble.step_roofline")
    assert reader.read({}, _ctx(step_s=least)) == pytest.approx(100.0)
    assert reader.read({}, _ctx(step_s=2 * least)) == pytest.approx(50.0)
    assert reader.read({}, _ctx(step_s=least, bw=None)) is None


def test_host_us_is_the_steps_span_outside_the_wrappers():
    """Two steps: 100 us and 80 us spans, wrappers covering 30 + 20 and
    25 us of them (one wrapper running past its step's span)."""
    spans = {"fluid.ensemble_step": [[0.0, 100e-6], [200e-6, 280e-6]],
             "fluid.k2.advect": [[10e-6, 40e-6], [270e-6, 290e-6]],
             "fluid.k1.project": [[50e-6, 70e-6]],
             "fluid.ensemble.layout": [[1e-6, 9e-6]]}
    reader = _reader("ensemble.host_us")
    got = reader.read(_summary(MEMBER_COUNTS, steps=2, spans=spans), _ctx())
    assert got == pytest.approx((100 - 50 + 80 - 10) / 2)
    assert reader.read(_summary(MEMBER_COUNTS, spans={}), _ctx()) is None


def test_layouts_per_step_reads_the_programs_total():
    reader = _reader("ensemble.layouts_per_step")
    assert reader.read(_summary(MEMBER_COUNTS), _ctx()) == 2.0
    assert reader.read(_summary({"K1": 1.0}), _ctx()) is None
