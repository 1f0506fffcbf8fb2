"""K1's and K2's member modes on an ensemble's member stack, on the CPU.

The wrappers take the ensemble's ``[n, C, mh, mw]`` state as it lies and
address its cells on the supergrid of the members' tiling
(``ops.cuda.modes.member_grid``; ``csrc/stack.cuh``).  Their plain
versions lay the stack out as that supergrid and back
(``modes._from_members``, ``_to_members``), so here, on three tilings
(4 members of 32x48, 2x2 tiles; 6 of 32x32, 2x3; 3 of 64x32, 1x3):

* member k of a stack is the supergrid's tile ``divmod(k, gw)``;
* ``advect_kernel`` with ``member=`` (self-advect with and without the
  overlay, the dye with ``clip01`` in float32 and bfloat16) and
  ``project_fused`` with ``member=`` (iters 0, 1, 10, 15, with and without
  impulses) on a stack equal ``_to_members`` of the same call on the
  ``_from_members`` supergrid, bit for bit, and launch nothing on the CPU
  (``stack_launches`` unmoved);
* ``make_ensemble_step`` on the kernel route (``advect_impl="pallas"``)
  equals the supergrid composition ``_from_super(_step_super(_to_super(s)))``
  over three fed steps, with no layout conversion and the wrappers taking
  the stack 3 times a step, as does its rollout;
* a stack whose ``member=`` is not its own ``(mh, mw)``, a velocity of
  another shape, and the modes a stack does not take are refused.

Imports no JAX.
"""

import pytest
import torch

from esp32_fluid_simulation_tpu_torch import (Impulses, SimConfig,
                                              init_ensemble,
                                              make_ensemble_multi_step,
                                              make_ensemble_step,
                                              stack_schedule)
from esp32_fluid_simulation_tpu_torch.models import ensemble as E
from esp32_fluid_simulation_tpu_torch.models.stable_fluids import (
    _from_members, _to_members)
from esp32_fluid_simulation_tpu_torch.ops.cuda.advect import (
    advect_kernel, member_overlay_reference)
from esp32_fluid_simulation_tpu_torch.ops.cuda.modes import member_grid
from esp32_fluid_simulation_tpu_torch.ops.cuda.project import project_fused
from stack_spy import spy_stack_calls, stack_launches

# tiling: (members, member tile)
LAYOUTS = {"2x2": (4, (32, 48)), "2x3": (6, (32, 32)), "1x3": (3, (64, 32))}
DT = 1 / 30


def _stack(seed, n, c, m, scale=1.0, shift=0.0):
    g = torch.Generator().manual_seed(seed)
    return scale * torch.randn((n, c) + m, generator=g) + shift


def _member_imps(n, m, seed):
    """Two pokes a member, one of them on a member wall."""
    g = torch.Generator().manual_seed(seed)
    member = [k for k in range(n) for _ in range(2)]
    pos = [(int(torch.randint(1, m[0] - 1, (), generator=g)), 0)
           if s else (m[0] - 1, int(torch.randint(m[1], (), generator=g)))
           for _ in range(n) for s in (0, 1)]
    vel = (60 * torch.randn((2 * n, 2), generator=g)).tolist()
    return Impulses.from_member_lists(SimConfig(shape=m, max_impulses=4), n,
                                      member, pos, vel, device="cpu")


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_stack_layout_is_the_permute(layout):
    """Member k of a stack is the supergrid's tile ``divmod(k, gw)`` of
    the ``member_grid`` tiling that ``tiled_ensemble_config`` takes, as
    ``_from_members`` lays it out and ``_to_members`` back."""
    n, m = LAYOUTS[layout]
    gh, gw = member_grid(n)
    assert gh * gw == n and (gh, gw) == E.tiled_ensemble_config(
        SimConfig(shape=m), n)[1:]
    x = _stack(1, n, 3, m)
    grid = _from_members(x, gh * m[0], gw * m[1])
    for k in range(n):
        qi, qj = divmod(k, gw)
        assert torch.equal(grid[:, qi * m[0]:(qi + 1) * m[0],
                                qj * m[1]:(qj + 1) * m[1]], x[k])
    assert torch.equal(_to_members(grid, *m), x)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_stack_advect_equals_the_supergrid_member_mode(layout):
    n, m = LAYOUTS[layout]
    gh, gw = member_grid(n)
    h, w = gh * m[0], gw * m[1]
    # sigma 200 cells/s: past the clamp of 12 cells on some cells
    vel_s = _stack(2, n, 2, m, 200.0)
    vel = _from_members(vel_s, h, w)
    ov = member_overlay_reference(_member_imps(n, m, 3), gh, gw, *m)
    before = advect_kernel.stack_launches
    for overlay in (None, ov):
        got = advect_kernel(vel_s, None, DT, True, 12, self_advect=True,
                            member=m, overlay=overlay)
        want = advect_kernel(vel, vel, DT, True, 12, self_advect=True,
                             member=m, overlay=overlay)
        assert torch.equal(got, _to_members(want, *m))
    for dtype in (torch.float32, torch.bfloat16):
        dye_s = _stack(4, n, 3, m, 0.6, 0.5).to(dtype)
        got = advect_kernel(dye_s, vel_s, DT, False, 12, clip01=True,
                            member=m)
        want = advect_kernel(_from_members(dye_s, h, w), vel, DT, False, 12,
                             clip01=True, member=m)
        assert got.dtype == dtype and got.shape == dye_s.shape
        assert torch.equal(got, _to_members(want, *m))
    assert advect_kernel.stack_launches == before


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_stack_project_equals_the_supergrid_member_mode(layout):
    n, m = LAYOUTS[layout]
    gh, gw = member_grid(n)
    h, w = gh * m[0], gw * m[1]
    vel_s = _stack(5, n, 2, m, 40.0)
    vel = _from_members(vel_s, h, w)
    imp = Impulses.from_lists(
        SimConfig(shape=(h, w), max_impulses=4),
        [(3, 5), (m[0], w - 1), (h - 1, m[1] - 1)],
        [(30.0, -12.0), (-8.0, 25.0), (9.0, 1.0)], device="cpu")
    before = project_fused.stack_launches
    for iters in (0, 1, 10, 15):
        for impulses in (None, imp):
            got_v, got_p = project_fused(vel_s, 1.0, iters, 1.96,
                                         impulses=impulses, member=m)
            want_v, want_p = project_fused(vel, 1.0, iters, 1.96,
                                           impulses=impulses, member=m)
            assert torch.equal(got_v, _to_members(want_v, *m))
            assert got_p.shape == (n,) + m
            assert torch.equal(got_p, _to_members(want_p[None], *m)[:, 0])
    assert project_fused.stack_launches == before


def _ensemble(cfg, n, seed):
    st = init_ensemble(cfg, n, device="cpu")
    return st._replace(velocity=_stack(seed, n, 2, cfg.shape, 40.0))


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_kernel_route_step_equals_the_supergrid_composition(layout,
                                                            monkeypatch):
    n, m = LAYOUTS[layout]
    cfg = SimConfig(shape=m, advect_impl="pallas")
    cs, gh, gw = E.tiled_ensemble_config(cfg, n)
    step = make_ensemble_step(cfg)
    feeds = [_member_imps(n, m, 10 + t) for t in range(3)]
    got = want = _ensemble(cfg, n, 6)
    seen = spy_stack_calls(monkeypatch)
    layouts, launched = E.layout_conversions(), stack_launches()
    for fed in feeds:
        got = step(got, fed)
    assert E.layout_conversions() == layouts
    assert seen["calls"] == 3 * len(feeds)
    assert stack_launches() == launched
    for fed in feeds:
        want = E._from_super(E._step_super(E._to_super(want, cs), fed, cs,
                                           gh, gw), cfg)
    assert got.step == want.step == len(feeds)
    assert torch.equal(got.velocity, want.velocity)
    assert torch.equal(got.color, want.color)
    run = make_ensemble_multi_step(cfg)(_ensemble(cfg, n, 6),
                                        stack_schedule(feeds))
    assert torch.equal(run.velocity, want.velocity)
    assert torch.equal(run.color, want.color)


def test_sequence_route_keeps_the_supergrid():
    """Above K1's trapezoid (iters > 15) the step converts the stack to the
    supergrid and back, and equals the composition."""
    n, m = LAYOUTS["2x2"]
    cfg = SimConfig(shape=m, advect_impl="pallas", sor_iters=16)
    cs, gh, gw = E.tiled_ensemble_config(cfg, n)
    fed = _member_imps(n, m, 20)
    st = _ensemble(cfg, n, 7)
    layouts = E.layout_conversions()
    got = make_ensemble_step(cfg)(st, fed)
    assert E.layout_conversions() == layouts + 2
    want = E._from_super(E._step_super(E._to_super(st, cs), fed, cs, gh, gw),
                         cfg)
    assert torch.equal(got.velocity, want.velocity)
    assert torch.equal(got.color, want.color)


@pytest.mark.parametrize("case", ["member", "none", "vel", "minmax", "rgb565",
                                  "block", "iters"])
def test_stack_refusals(case):
    n, m = LAYOUTS["2x3"]
    vel = _stack(8, n, 2, m)
    dye = _stack(9, n, 3, m)
    calls = {
        "member": lambda: advect_kernel(vel, vel, DT, True, member=(16, 32)),
        "none": lambda: project_fused(vel, member=None),
        "vel": lambda: advect_kernel(dye, vel[:, :, :-1], DT, False,
                                     member=m),
        "minmax": lambda: advect_kernel(vel, vel, DT, True, member=m,
                                        return_minmax=True),
        "rgb565": lambda: advect_kernel(dye, vel, DT, False, clip01=True,
                                        rgb565=True, member=m),
        "block": lambda: project_fused(vel, member=m, global_offset=(0, 0),
                                       global_shape=(64, 96), halo=22),
        "iters": lambda: project_fused(vel, iters=16, member=m),
    }
    with pytest.raises(ValueError):
        calls[case]()
