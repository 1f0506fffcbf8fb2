"""The ensemble step against the benchmark's plain reference
(``bench_port/reference/ensemble_step.py``, loaded by path), on the CPU.

Seeded random member states and seeded pokes (more than the 16 slots for
some members, none for others, repeated and out-of-member cells), 4
members of 32x48, a few steps of ``make_ensemble_step``: each step equals
the reference stepped from the step's input, bit for bit, on both of the
program's routes here: the eager member loop (``advect_impl="auto"`` on
the CPU) and the kernels' plain ``member=`` versions (``"pallas"``: K2
with the overlay, K1, K2 on the dye, as ``chip_smoke.py``
``plain_tiled_step`` composes them; velocities past the kernel's clamp of
12 cells a step).  The reference's control (``lower=True``) reads above 0
on both numbers.  Imports no JAX.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from esp32_fluid_simulation_tpu_torch import (Impulses, SimConfig, SimState,
                                              make_ensemble_step,
                                              tiled_ensemble_config)
from esp32_fluid_simulation_tpu_torch.models.stable_fluids import (
    _from_members, _to_members)
from esp32_fluid_simulation_tpu_torch.ops.cuda.advect import (
    advect_reference, member_overlay_reference)
from esp32_fluid_simulation_tpu_torch.ops.cuda.project import (
    project_fused_reference)

ROOT = Path(__file__).resolve().parents[1]
N, H, W = 4, 32, 48


def _reference():
    path = ROOT / "bench_port/reference/ensemble_step.py"
    spec = importlib.util.spec_from_file_location("ensemble_reference", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


REF = _reference()


def _sim(advect_impl):
    return {"shape": [N, H, W], "dt": 1 / 30, "dx": 1.0, "sor_iters": 10,
            "omega": 1.96, "advect_impl": advect_impl, "advect_max_disp": 12,
            "dtype": "float32", "color_dtype": "float32",
            "max_impulses": 16}


def _cfg(advect_impl):
    return SimConfig(shape=(H, W), advect_impl=advect_impl)


def _state(seed, speed):
    g = torch.Generator().manual_seed(seed)
    vel = speed * torch.randn((N, 2, H, W), generator=g)
    dye = torch.rand((N, 3, H, W), generator=g)
    return SimState(velocity=vel, color=dye, step=0)


def _pokes(seed, t):
    """A step's flat lists: member 2 gets 20 pokes, member 3 none, cells
    out of the member and a repeated cell among them."""
    rng = np.random.default_rng([seed, t])
    member = [int(m) for m in rng.choice([0, 1, 2], 12)] + [2] * 20 + [0, 0]
    pos = [tuple(int(x) for x in rng.integers(-4, 52, 2))
           for _ in range(32)] + [(5, 6), (5, 6)]
    vel = [tuple(float(x) for x in 300.0 * rng.standard_normal(2))
           for _ in range(34)]
    return member, pos, vel


@pytest.mark.parametrize("advect_impl,speed", [("auto", 100.0),
                                               ("pallas", 500.0)])
@pytest.mark.parametrize("seed", [3, 4])
def test_ensemble_step_is_the_plain_reference(advect_impl, speed, seed):
    cfg, sim = _cfg(advect_impl), _sim(advect_impl)
    st = _state(seed, speed)
    step = make_ensemble_step(cfg)
    for t in range(3):
        lists = _pokes(seed, t)
        before = {"velocity": st.velocity, "dye": st.color}
        st = step(st, Impulses.from_member_lists(cfg, N, *lists,
                                                 device="cpu"))
        got = {"velocity": st.velocity, "dye": st.color}
        want = REF.step(before, *lists, sim, 1)
        assert REF.compare(got, want) == {"velocity_rel": 0.0,
                                          "dye_abs": 0.0}, t
        lower = REF.step(REF.lower_state(before, sim), *lists, sim, 1,
                         lower=True)
        assert all(v > 0 for v in REF.compare(lower, want).values())


def test_plain_member_kernels_are_the_plain_reference():
    """``_step_tiled``'s kernel path composed from the plain versions, as
    ``chip_smoke.py`` ``plain_tiled_step`` runs it, on the supergrid."""
    cfg = _cfg("pallas")
    cs, gh, gw = tiled_ensemble_config(cfg, N)
    st = _state(9, 500.0)
    lists = _pokes(9, 0)
    imp = Impulses.from_member_lists(cfg, N, *lists, device="cpu")
    overlay = member_overlay_reference(imp, gh, gw, H, W)
    sh, sw = cs.shape
    sv, sc = _from_members(st.velocity, sh, sw), _from_members(st.color,
                                                               sh, sw)
    m, md = (H, W), cs.advect_max_disp
    vel = advect_reference(sv, sv, cs.dt, True, md, member=m,
                           overlay=overlay)
    vel, _ = project_fused_reference(vel, cs.dx, cs.sor_iters, cs.omega,
                                     member=m)
    dye = advect_reference(sc, vel, cs.dt, False, md, clip01=True,
                           member=m)
    got = {"velocity": _to_members(vel, H, W), "dye": _to_members(dye, H, W)}
    want = REF.step({"velocity": st.velocity, "dye": st.color}, *lists,
                    _sim("pallas"), 1)
    assert REF.compare(got, want) == {"velocity_rel": 0.0, "dye_abs": 0.0}


def test_reference_refuses_odd_members():
    sim = dict(_sim("auto"), shape=[2, 17, 21])
    state = {"velocity": torch.zeros((2, 2, 17, 21)),
             "dye": torch.zeros((2, 3, 17, 21))}
    with pytest.raises(ValueError):
        REF.step(state, [], [], [], sim, 1)
