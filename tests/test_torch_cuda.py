"""The CUDA kernels against their plain PyTorch versions on the card.

Marked ``gpu``: they need a CUDA device and ``nvcc`` and skip without them
(the check happens in a fixture, never at import).  On a GPU machine, where
JAX (which ``tests/conftest.py`` imports) need not be installed:

    python -m pytest tests/test_torch_cuda.py -q --noconftest

Each kernel is built with ``--fmad=false`` and must equal its plain version
bit for bit, the tiled-domain modes (K6: ``member=`` of K1, K2, K4 and K5,
K2's ``overlay=``) at odd and even member tiles too; ``chip_smoke.py``
repeats these checks at the production shapes.
"""

import dataclasses

import numpy as np
import pytest
import torch

from esp32_fluid_simulation_tpu_torch import (SimConfig, Impulses,
                                              init_ensemble,
                                              make_ensemble_step,
                                              stack_impulses)
from esp32_fluid_simulation_tpu_torch.models.stable_fluids import (
    impulse_overlay)
from esp32_fluid_simulation_tpu_torch.ops.cuda.advect import (
    advect_kernel, advect_maccormack_kernel, advect_maccormack_reference,
    advect_reference)
from esp32_fluid_simulation_tpu_torch.ops.cuda.project import (
    project_fused, project_fused_reference)
from esp32_fluid_simulation_tpu_torch.ops.cuda.advect3d import (
    advect3d_kernel, advect3d_reference, advect3d_source_kernel,
    advect3d_source_reference)
from esp32_fluid_simulation_tpu_torch.ops.cuda.fd3d import (
    divergence3d, divergence3d_reference, subtract_gradient3d,
    subtract_gradient3d_reference)
from esp32_fluid_simulation_tpu_torch.ops.cuda.sor import (
    sor_solve_kernel, sor_solve_reference)
from esp32_fluid_simulation_tpu_torch.ops.cuda.sor3d import (
    sor3d_chunk, sor3d_chunk_reference, sor3d_solve, sor3d_reference)
from esp32_fluid_simulation_tpu_torch.render import render_smoke
from esp32_fluid_simulation_tpu_torch.render.cuda_smoke import (
    mip_plan, render_smoke_mip_kernel, render_smoke_mip_reference)
from esp32_fluid_simulation_tpu_torch.render.cuda_upscale import (
    render_rgb565_kernel, render_rgb565_reference)
from mip_cases import MIP_CASES, mip_case
import feed_cases

pytestmark = pytest.mark.gpu

SHAPE = (61, 81)
SHAPE3 = (9, 33, 130)
# (grid, member tile): a 2x3 grid of odd members and a 2x2 grid of even ones
TILINGS = {"odd": ((34, 63), (17, 21)), "even": ((64, 128), (32, 64))}


@pytest.fixture
def rng():
    return np.random.default_rng(1234)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


def _on(x, dev):
    return torch.from_numpy(np.asarray(x)).to(dev)


def _bits(t):
    return t.view(torch.int16) if t.element_size() == 2 else t


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_advect_kernel_bit_equal(cuda, rng, dtype):
    vel = _on((200 * rng.standard_normal((2,) + SHAPE)).astype(np.float32),
              cuda)
    before = advect_kernel.launches
    got = advect_kernel(vel, vel, 1 / 30, True, max_disp=12,
                        self_advect=True)
    assert advect_kernel.launches == before + 1
    assert torch.equal(got, advect_reference(vel, vel, 1 / 30, True, 12))
    dye = _on(rng.random((3,) + SHAPE, dtype=np.float32) * 2 - 0.5,
              cuda).to(dtype)
    for bswap in (True, False):
        c, f = advect_kernel(dye, vel, 1 / 30, False, clip01=True,
                             rgb565=True, bswap=bswap)
        rc, rf = advect_reference(dye, vel, 1 / 30, False, clip01=True,
                                  rgb565=True, bswap=bswap)
        assert torch.equal(_bits(c), _bits(rc))
        assert torch.equal(_bits(f), _bits(rf))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_advect_minmax_kernel_bit_equal(cuda, rng, dtype):
    vel = _on((60 * rng.standard_normal((2,) + SHAPE)).astype(np.float32),
              cuda)
    f = _on(rng.random((3,) + SHAPE, dtype=np.float32), cuda).to(dtype)
    for field in (f, f[0].contiguous()):
        got = advect_kernel(field, vel, 1 / 30, True, return_minmax=True)
        want = advect_reference(field, vel, 1 / 30, True,
                                return_minmax=True)
        for g, w in zip(got, want):
            assert torch.equal(_bits(g), _bits(w))


@pytest.mark.parametrize("dtype,channels,no_slip", [
    (torch.float32, 2, True), (torch.bfloat16, 3, False),
    (torch.float32, 1, True)])
def test_maccormack_kernel_bit_equal(cuda, rng, dtype, channels, no_slip):
    # sigma 200 cells/s: the CFL clamp binds on some cells
    vel = _on((200 * rng.standard_normal((2,) + SHAPE)).astype(np.float32),
              cuda)
    field = vel if channels == 2 else _on(
        rng.random((channels,) + SHAPE, dtype=np.float32) * 2 - 0.5,
        cuda).to(dtype)
    before = advect_maccormack_kernel.launches
    got = advect_maccormack_kernel(field, vel, 1 / 30, no_slip)
    assert advect_maccormack_kernel.launches == before + 1
    want = advect_maccormack_reference(field, vel, 1 / 30, no_slip)
    assert got.dtype == field.dtype
    assert torch.equal(_bits(got), _bits(want))


@pytest.mark.parametrize("velocity", ["full_reach", "nan", "zero"])
def test_maccormack_window_reach_bit_equal(cuda, rng, velocity):
    """K5's window route with the CFL clamp binding everywhere (the reach is
    max_disp + 1) and at rest (reach 1), against the plain version; with a
    NaN and an inf velocity cell (each counts as max_disp) against the
    two-launch route, which shares the kernel's clamp (the plain version,
    as JAX, has no answer for a NaN velocity)."""
    from esp32_fluid_simulation_tpu_torch.ops.cuda import advect
    scale = {"full_reach": 2000.0, "nan": 30.0, "zero": 0.0}[velocity]
    vel = (scale * rng.standard_normal((2,) + SHAPE)).astype(np.float32)
    if velocity == "nan":
        vel[0, 30, 40] = np.nan
        vel[1, 7, 3] = np.inf
    vel = _on(vel, cuda)
    for field, no_slip in (
            (_on(rng.random((2,) + SHAPE, dtype=np.float32), cuda), True),
            (_on(rng.random((3,) + SHAPE, dtype=np.float32),
                 cuda).to(torch.bfloat16), False)):
        before = advect_maccormack_kernel.launches
        got = advect_maccormack_kernel(field, vel, 1 / 30, no_slip)
        assert advect_maccormack_kernel.launches == before + 1
        if velocity == "nan":
            want = advect._launch_two(field, vel, 1 / 30, no_slip, 12, None)
        else:
            want = advect_maccormack_reference(field, vel, 1 / 30, no_slip)
        assert not torch.isnan(want).any()
        assert torch.equal(_bits(got), _bits(want))


def test_maccormack_two_launch_route_bit_equal(cuda, rng):
    """A max_disp whose worst-case window does not fit a block takes the
    two-launch route, counted on its own, bit-equal too (with and without
    members)."""
    md = 120
    vel = _on((3000 * rng.standard_normal((2,) + SHAPE)).astype(np.float32),
              cuda)
    dye = _on(rng.random((3,) + SHAPE, dtype=np.float32),
              cuda).to(torch.bfloat16)
    before = (advect_maccormack_kernel.launches,
              advect_maccormack_kernel.two_launch_calls)
    for field, no_slip in ((vel, True), (dye, False)):
        got = advect_maccormack_kernel(field, vel, 1 / 30, no_slip, md)
        want = advect_maccormack_reference(field, vel, 1 / 30, no_slip, md)
        assert torch.equal(_bits(got), _bits(want))
    shape, member = TILINGS["odd"]
    v = vel[:, :shape[0], :shape[1]].contiguous()
    got = advect_maccormack_kernel(v, v, 1 / 30, True, md, member=member)
    assert torch.equal(got, advect_maccormack_reference(
        v, v, 1 / 30, True, md, member=member))
    assert (advect_maccormack_kernel.launches,
            advect_maccormack_kernel.two_launch_calls) == (before[0],
                                                           before[1] + 3)
    # at max_disp 12 the window fits: the same call takes one launch
    advect_maccormack_kernel(dye, vel, 1 / 30, False, 12)
    assert (advect_maccormack_kernel.launches,
            advect_maccormack_kernel.two_launch_calls) == (before[0] + 1,
                                                           before[1] + 3)


@pytest.mark.parametrize("iters", [0, 1, 10])
def test_sor_kernel_bit_equal(cuda, rng, iters):
    for shape in (SHAPE, (130, 200)):
        d = _on(rng.standard_normal(shape).astype(np.float32), cuda)
        before = sor_solve_kernel.launches
        got = sor_solve_kernel(d, 0.7, iters, 1.96)
        assert sor_solve_kernel.launches == before + 1
        assert torch.equal(got, sor_solve_reference(d, 0.7, iters, 1.96))


@pytest.mark.parametrize("iters", [0, 1, 10, 20])
@pytest.mark.parametrize("shape", [(61, 81), (130, 200), (250, 310)])
def test_sor_kernel_routes_bit_equal(cuda, rng, shape, iters):
    """K4's one-launch window route (iters <= WINDOW_MAX_ITERS) and its
    launch sequence (above) on shapes that are not multiples of the tile,
    whole grid, with 2x2 member tiles and as the (0, 1) block of a 2x2
    cut with a halo of 2*iters."""
    from esp32_fluid_simulation_tpu_torch.ops.cuda.sor import (
        WINDOW_MAX_ITERS)
    h, w = shape
    d = _on(rng.standard_normal(shape).astype(np.float32), cuda)
    window = iters <= WINDOW_MAX_ITERS
    before = (sor_solve_kernel.window_launches,
              sor_solve_kernel.sequence_launches)
    member = (h // 2, w // 2) if h % 2 == 0 and w % 2 == 0 else None
    assert torch.equal(sor_solve_kernel(d, 0.7, iters, 1.96),
                       sor_solve_reference(d, 0.7, iters, 1.96))
    assert torch.equal(sor_solve_kernel(d, 0.7, iters, 1.96, member=member),
                       sor_solve_reference(d, 0.7, iters, 1.96, member))
    g, (bh, bw) = 2 * iters, (h // 2, w - w // 2)
    dpad = torch.nn.functional.pad(d, (g, g, g, g))[:bh + 2 * g,
                                                    w // 2:w + 2 * g]
    got = sor_solve_kernel(dpad.contiguous(), 0.7, iters, 1.96,
                           global_offset=(0, w // 2), global_shape=shape,
                           halo=g)
    assert torch.equal(got, sor_solve_kernel(d, 0.7, iters, 1.96)[
        :bh, w // 2:])
    assert (sor_solve_kernel.window_launches,
            sor_solve_kernel.sequence_launches) == (
                before[0] + 4 * window, before[1] + 4 * (not window))


def test_project_kernel_bit_equal(cuda, rng):
    cfg = SimConfig(shape=SHAPE)
    vel = _on(rng.normal(0, 40, (2,) + SHAPE).astype(np.float32), cuda)
    imp = Impulses.from_lists(
        cfg, [(20, 30), (20, 30), (40, 50), (99, -3)],
        [(90.0, -45.0), (33.0, 44.0), (-60.0, 120.0), (7.0, 8.0)],
        device=cuda)
    for impulses in (imp, None):
        v, p = project_fused(vel, 1.0, 10, 1.96, impulses=impulses)
        rv, rp = project_fused_reference(vel, 1.0, 10, 1.96, impulses)
        assert torch.equal(v, rv) and torch.equal(p, rp)


def _seam_impulses(shape, iters, dev, member=False):
    """Slots on the first strip and segment seams of K1's window route
    (``strip_plan`` at the blocks planned for the card), or with ``member``
    on the seams of its trapezoid route's tiles (``sor.window_tile``), and
    within a window's reach of them, a duplicate and an out-of-range
    position."""
    from esp32_fluid_simulation_tpu_torch.ops.cuda import project
    from esp32_fluid_simulation_tpu_torch.ops.cuda.sor import window_tile
    iters = min(iters, project.WINDOW_MAX_ITERS)
    if member:
        th, tw, _ = window_tile(2 * iters + 1)
    else:
        n_strips, n_segs = project.strip_plan(
            *shape, iters,
            project.strip_blocks(torch.device(dev), iters))
        th, tw = max(shape[0] // n_segs, 1), max(shape[1] // n_strips, 1)
    r = 2 * iters + 2
    return Impulses.from_lists(
        SimConfig(shape=shape, max_impulses=8),
        [(th, tw), (th - 1, tw - 1), (th + r - 1, 5), (th, tw),
         (3, tw + r - 1), (shape[0] + 50, -3)],
        [(90.0, -45.0), (33.0, 44.0), (-60.0, 120.0), (-20.0, 65.0),
         (7.0, 8.0), (5.0, 5.0)], device=dev)


@pytest.mark.parametrize("iters", [0, 1, 10, 15, 20])
@pytest.mark.parametrize("shape", [(61, 81), (130, 200), (250, 310),
                                   (4097, 4093)])
def test_project_kernel_routes_bit_equal(cuda, rng, shape, iters):
    """K1's one-launch window route (iters <= WINDOW_MAX_ITERS: the
    row-pipelined strips) and its launch sequence (above) on shapes that
    are not multiples of a strip or a segment, with impulses on the
    seams."""
    from esp32_fluid_simulation_tpu_torch.ops.cuda.project import (
        WINDOW_MAX_ITERS)
    vel = _on(rng.normal(0, 40, (2,) + shape).astype(np.float32), cuda)
    window = iters <= WINDOW_MAX_ITERS
    before = (project_fused.window_launches, project_fused.sequence_launches)
    for impulses in (_seam_impulses(shape, iters, cuda), None):
        v, p = project_fused(vel, 1.0, iters, 1.96, impulses=impulses)
        rv, rp = project_fused_reference(vel, 1.0, iters, 1.96, impulses)
        assert torch.equal(v, rv) and torch.equal(p, rp)
    assert (project_fused.window_launches,
            project_fused.sequence_launches) == (before[0] + 2 * window,
                                                 before[1] + 2 * (not window))


@pytest.mark.parametrize("iters", [0, 1, 10, 15, 20])
def test_project_member_window_bit_equal(cuda, rng, iters):
    """K1 ``member=`` with 48x40 members, whose walls cross the tiles of
    its one-launch trapezoid route (iters <= WINDOW_MAX_ITERS)."""
    from esp32_fluid_simulation_tpu_torch.ops.cuda.project import (
        WINDOW_MAX_ITERS)
    shape, member = (144, 200), (48, 40)
    vel = _on(rng.normal(0, 40, (2,) + shape).astype(np.float32), cuda)
    before = project_fused.trapezoid_launches
    for impulses in (_seam_impulses(shape, iters, cuda, member=True), None):
        v, p = project_fused(vel, 1.0, iters, 1.96, impulses=impulses,
                             member=member)
        rv, rp = project_fused_reference(vel, 1.0, iters, 1.96, impulses,
                                         member)
        assert torch.equal(v, rv) and torch.equal(p, rp)
    assert project_fused.trapezoid_launches == before + 2 * (
        iters <= WINDOW_MAX_ITERS)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_render_kernel_bit_equal(cuda, rng, dtype):
    c = rng.random((3,) + SHAPE, dtype=np.float32)
    c[:, ::7, ::5] = 1.0
    c[:, 1::9, ::3] = 0.0
    color = _on(c, cuda).to(dtype)
    for s in (1, 2, 3, 4, 5):
        for bswap in (True, False):
            for unit_range in (False, True):
                got = render_rgb565_kernel(color, s, bswap, unit_range)
                want = render_rgb565_reference(color, s, bswap, unit_range)
                assert torch.equal(_bits(got), _bits(want))


@pytest.mark.parametrize("vel_dtype", [torch.float32, torch.bfloat16])
def test_advect3d_kernel_bit_equal(cuda, rng, vel_dtype):
    # sigma 60 cells/s at max_disp=1: the CFL clamp binds on most cells
    vel = _on((60 * rng.standard_normal((3,) + SHAPE3)).astype(np.float32),
              cuda).to(vel_dtype)
    before = advect3d_kernel.launches
    for md in (1, 2):
        got = advect3d_kernel(vel, vel, 1 / 30, True, max_disp=md)
        want = advect3d_reference(vel, vel, 1 / 30, True, max_disp=md)
        assert torch.equal(_bits(got), _bits(want))
    pair = _on(rng.random((2,) + SHAPE3, dtype=np.float32),
               cuda).to(torch.bfloat16)
    got = advect3d_kernel(pair, vel, 1 / 30, False, max_disp=2)
    want = advect3d_reference(pair, vel, 1 / 30, False, max_disp=2)
    assert torch.equal(_bits(got), _bits(want))
    assert advect3d_kernel.launches == before + 3


def _bits32(t):
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


def _source_case(name, dev):
    """(cfg, density, temperature, velocity, mask) of one case of K7's
    scalar launch with the plume's source: at odd extents, a sphere that
    crosses the launch's 32x8 blocks (columns 28-38, rows 12-21); an
    arbitrary mask over the whole grid; densities above 1 before the
    clamp, NaN, +-inf and -0 in either scalar."""
    from esp32_fluid_simulation_tpu_torch.models.smoke3d import (
        SmokeConfig, source_tensor)
    g = torch.Generator().manual_seed(23)
    cfg = SmokeConfig(shape=SHAPE3, source_center=(0.5, 0.5, 0.25),
                      source_radius=0.6)
    # sigma 60 cells/s at max_disp=2: the CFL clamp binds on some cells
    vel = 60 * torch.randn((3,) + SHAPE3, generator=g)
    rho = 1.3 * torch.rand(SHAPE3, generator=g)
    temp = 2 * torch.randn(SHAPE3, generator=g)
    mask = source_tensor(cfg, "cpu")
    if name == "mask":
        mask = (3 * torch.rand(SHAPE3, generator=g) - 1).to(torch.bfloat16)
    if name == "specials":
        cfg = dataclasses.replace(cfg, source_density=9.0,
                                  source_temperature=-4.0)
        # -0 where whole samples read it, inside and outside the sphere
        rho[:, 16:, :] = -0.0
        temp[:, :14, 30:] = -0.0
        rho[2, 13, 30] = temp[5, 20, 33] = float("nan")
        rho[4, 15, 35] = temp[1, 3, 90] = float("inf")
        rho[7, 18, 31] = temp[3, 30, 120] = float("-inf")
    return (cfg, rho.to(dev, torch.bfloat16), temp.to(dev, torch.bfloat16),
            vel.to(dev), mask.to(dev))


@pytest.mark.parametrize("name", ["sphere", "mask", "specials"])
def test_advect3d_source_launch_bit_equal(cuda, name):
    """K7's scalar launch with the plume's source and buoyancy equals the
    launch without it followed by ``inject_and_buoy``'s eager ops on the
    card, and the plain version ``advect3d_source_reference``, bit for bit
    on the velocity (written in place) and both scalars; one launch."""
    from esp32_fluid_simulation_tpu_torch.models.smoke3d import (
        inject_and_buoy, plume_source)
    cfg, rho, temp, vel, mask = _source_case(name, cuda)
    dt, src = 1 / 30, plume_source(cfg, mask)
    before = (advect3d_kernel.launches, advect3d_kernel.source_launches)
    got_vel = vel.clone()
    got = advect3d_source_kernel(rho, temp, got_vel, dt, False, src, 2)
    assert (advect3d_kernel.launches, advect3d_kernel.source_launches) == (
        before[0] + 1, before[1] + 1)
    want_vel = vel.clone()
    scal = advect3d_kernel(torch.stack([rho, temp]), want_vel, dt, False, 2)
    want_vel, want_rho, want_temp = inject_and_buoy(want_vel, scal[0],
                                                    scal[1], mask, cfg)
    plain_vel = vel.clone()
    plain = advect3d_source_reference(rho, temp, plain_vel, dt, False, src,
                                      2)
    for a, b in ((got_vel, want_vel), (got[0], want_rho),
                 (got[1], want_temp), (got_vel, plain_vel),
                 (got, plain)):
        assert torch.equal(_bits32(a), _bits32(b))
    if name == "specials":
        neg0 = _bits32(torch.tensor(-0.0, device=cuda).bfloat16())
        assert (want_rho == 1).any() and want_rho.isnan().any()
        assert (_bits32(scal[0]) == neg0).any()
        assert not (_bits32(got[0]) == neg0).any()


def test_smoke_step_source_route_bit_equal_to_plain_step(cuda):
    """Three stirred ``smoke_step`` steps at 128^3 (K7 with the source
    epilogue, K8, K9) equal ``chip_smoke.py``'s ``plain_smoke_step`` (the
    kernels' plain versions, the source and buoyancy as eager ops) bit for
    bit; K7 twice a step, once with the source."""
    import importlib.util
    from pathlib import Path
    from esp32_fluid_simulation_tpu_torch import (SmokeConfig, SmokeState,
                                                  init_smoke,
                                                  make_smoke_step)
    from esp32_fluid_simulation_tpu_torch.models.smoke3d import (
        source_tensor)
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    chip = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip)
    cfg = SmokeConfig(shape=(128, 128, 128), advect_impl="pallas",
                      sor_impl="pallas")
    st = init_smoke(cfg, device=cuda)
    g = torch.Generator(device=cuda).manual_seed(31)
    st = st._replace(velocity=8 * torch.randn(st.velocity.shape,
                                              generator=g, device=cuda))
    ps = SmokeState(st.velocity.clone(), st.density, st.temperature, 0)
    step, src = make_smoke_step(cfg), source_tensor(cfg, cuda)
    before = (advect3d_kernel.launches, advect3d_kernel.source_launches)
    for t in range(3):
        pos = [(77, 64 + 30 * t, 64), (77, 40, 50 + 20 * t), (115, 64, 64)]
        vel = [(0.0, 30.0, -20.0), (5.0, -25.0, 15.0), (-40.0, 0.0, 10.0)]
        imp = Impulses.from_lists(cfg, pos, vel, device=cuda)
        st = step(st, imp)
        ps = chip.plain_smoke_step(ps, cfg, src, imp)
    assert (advect3d_kernel.launches, advect3d_kernel.source_launches) == (
        before[0] + 6, before[1] + 3)
    for name in ("velocity", "density", "temperature"):
        assert torch.equal(_bits32(getattr(st, name)),
                           _bits32(getattr(ps, name))), name
    assert float(st.density.float().max()) > 0.0


@pytest.mark.parametrize("vel_dtype", [torch.float32, torch.bfloat16])
def test_advect3d_block_self_advect_bit_equal(cuda, rng, vel_dtype):
    """K7 block's self-advect (the velocity read from the haloed field) at
    even and odd halos and row widths, against its plain version and the
    call with the owned velocity."""
    before = advect3d_kernel.block_launches
    for shape in ((5, 12, 128), SHAPE3):
        vel = _on((40 * rng.standard_normal((3,) + shape)).astype(
            np.float32), cuda).to(vel_dtype)
        off, bshape = (0, 0), (shape[1] // 2, shape[2] // 2)
        for k in (3, 4):
            kw = dict(max_disp=2, global_offset=off, global_shape=shape,
                      halo=k)
            vpad = _block_of(vel, off, bshape, k)
            got = advect3d_kernel(vpad, None, 1 / 30, True, **kw)
            assert torch.equal(_bits(got), _bits(advect3d_reference(
                vpad, None, 1 / 30, True, 2, _block3(off, k, shape[1:],
                                                     bshape))))
            assert torch.equal(_bits(got), _bits(advect3d_kernel(
                vpad, _block_of(vel, off, bshape, 0), 1 / 30, True, **kw)))
    assert advect3d_kernel.block_launches == before + 8


def _block3(off, g, gshape, bshape):
    from esp32_fluid_simulation_tpu_torch.ops.cuda.modes import Block
    return Block(off[0], off[1], *gshape, g, *bshape)


def test_fd3d_kernels_bit_equal(cuda, rng):
    vel = _on(rng.standard_normal((3,) + SHAPE3).astype(np.float32), cuda)
    p = _on(rng.standard_normal(SHAPE3).astype(np.float32), cuda)
    for dx in (1.0, 0.7):
        assert torch.equal(divergence3d(vel, dx),
                           divergence3d_reference(vel, dx))
        assert torch.equal(subtract_gradient3d(vel, p, dx),
                           subtract_gradient3d_reference(vel, p, dx))


@pytest.mark.parametrize("iters", [0, 1, 10])
def test_sor3d_kernel_bit_equal(cuda, rng, iters):
    d = _on(rng.standard_normal(SHAPE3).astype(np.float32), cuda)
    assert torch.equal(sor3d_solve(d, 1.0, iters, 1.5, chunk=3),
                       sor3d_reference(d, 1.0, iters, 1.5))


@pytest.mark.parametrize("shape", [
    (256, 256, 256), (37, 83, 150), (24, 61, 97), (12, 384, 512)])
def test_sor3d_kernel_bit_equal_at_plume_and_ragged_shapes(cuda, shape):
    """K9 at the plume's 256^3 and 10 iters, at H and W that no tile of the
    plan divides, at W % 4 != 0 (loads and stores cell by cell) and with
    every plane in one chunk, bit-equal to the plain version."""
    from esp32_fluid_simulation_tpu_torch.ops.cuda import sor3d
    gen = torch.Generator(device=cuda).manual_seed(sum(shape))
    d = torch.randn(shape, generator=gen, device=cuda)
    (th, tw), zc, depths = sor3d.pass_plan(shape, 20,
                                          sor3d.sm_count(cuda.index))
    assert depths == [5, 5, 5, 5]
    if shape[0] == 12:
        assert zc >= shape[0]
    if shape[1:] == (83, 150):
        assert 83 % th and 150 % tw
    assert torch.equal(sor3d_solve(d, 1.0, 10, 1.5),
                       sor3d_reference(d, 1.0, 10, 1.5))


@pytest.mark.parametrize("origin", [(0, -6, -6), (0, 122, 122)])
def test_sor3d_chunk_bit_equal_on_the_sharded_chains_shards(cuda, origin):
    """One chunk of the sharded 256^3 smoke's chain (3 sweeps on a shard's
    block haloed by 6, one pass of 6) on an edge shard and a far shard,
    bit-equal to the plain version."""
    gen = torch.Generator(device=cuda).manual_seed(origin[1] + 7)
    d = torch.randn((256, 140, 140), generator=gen, device=cuda)
    p = torch.randn((256, 140, 140), generator=gen, device=cuda)
    before = sor3d_chunk.launches
    got = sor3d_chunk(d, p, 1.0, 3, 1.5, global_offset=origin,
                      global_shape=(256, 256, 256))
    assert sor3d_chunk.launches == before + 1
    assert torch.equal(got, sor3d_chunk_reference(d, p, 1.0, 3, 1.5, origin,
                                                  (256, 256, 256)))


@pytest.mark.parametrize("tile, deepest, zc", [
    ((16, 32), 6, 3), ((8, 12), 1, 20), ((16, 32), 2, 1), ((13, 40), 6, 7),
    ((45, 20), 3, 20), ((8, 64), 5, 5), ((20, 52), 5, 20), ((20, 48), 6, 2)])
def test_sor3d_passes_do_not_depend_on_depth_or_tile(cuda, rng, monkeypatch,
                                                     tile, deepest, zc):
    """K9's z-marching passes at other pass depths, ragged tiles and chunks
    of planes: whole grid from zero and a chunk of a larger domain from a
    given p, both bit-equal to their plain versions."""
    from esp32_fluid_simulation_tpu_torch.ops.cuda import sor3d
    monkeypatch.setattr(sor3d, "pass_plan", lambda shape, levels, sms: (
        tile, zc, sor3d.pass_depths(levels, deepest)))
    d = _on(rng.standard_normal((20, 45, 70)).astype(np.float32), cuda)
    p = _on(rng.standard_normal((20, 45, 70)).astype(np.float32), cuda)
    assert torch.equal(sor3d_solve(d, 0.7, 7, 1.5),
                       sor3d_reference(d, 0.7, 7, 1.5))
    for sweeps in (1, 3, 4):
        kw = dict(global_offset=(0, -2 * sweeps, 9),
                  global_shape=(20, 80, 90))
        assert torch.equal(
            sor3d_chunk(d, p, 0.7, sweeps, 1.5, **kw),
            sor3d_chunk_reference(d, p, 0.7, sweeps, 1.5, kw["global_offset"],
                                  kw["global_shape"]))


def test_sor3d_pass_plan_follows_the_kernel(cuda):
    """``pass_threads`` is ``csrc/sor3d.cu``'s count of a block's threads,
    the plans fit it, and the kernel refuses a pass past the deepest, a
    tile width not a multiple of 4 and a block past
    ``SOR3D_MAX_THREADS``; the pass entry refuses them too."""
    from esp32_fluid_simulation_tpu_torch.ops.cuda import sor3d
    from esp32_fluid_simulation_tpu_torch.ops.cuda.build import load
    lib = load()
    for depth in range(sor3d.SOR3D_MAX_DEPTH + 1):
        for tile in ((8, 16), (20, 52), (20, 48), (33, 44), (13, 40)):
            want = sor3d.pass_threads(tile, depth)
            got = lib.value("fluid_sor3d_pass_threads", *tile, depth)
            assert got == (want if want <= sor3d.SOR3D_MAX_THREADS else 0)
    sms = sor3d.sm_count(cuda.index)
    for shape, levels in (((256, 256, 256), 20), ((256, 140, 140), 6)):
        tile, _, depths = sor3d.pass_plan(shape, levels, sms)
        assert lib.value("fluid_sor3d_pass_threads", *tile, max(depths)) > 0
    assert not lib.value("fluid_sor3d_pass_threads", 8, 16, 7)
    assert not lib.value("fluid_sor3d_pass_threads", 8, 18, 2)
    assert not lib.value("fluid_sor3d_pass_threads", 64, 64, 6)
    d = torch.zeros((4, 8, 8), device=cuda)
    with pytest.raises(RuntimeError, match="fluid_sor3d_pass failed"):
        load().call("fluid_sor3d_pass", d.data_ptr(), None, d.data_ptr(),
                    4, 8, 8, 0, 0, 0, 4, 8, 8, 1.0, 0, 7, 1.5, -0.5, 8, 8,
                    4, 1, None)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_smoke_mip_kernel_bit_equal(cuda, rng, dtype):
    rho = 1.2 * rng.random(SHAPE3, dtype=np.float32)
    rho[4, 7, 9] = np.nan        # the NaN rule: the column packs to 0
    rho = _on(rho, cuda).to(dtype)
    for bswap in (True, False):
        got = render_smoke_mip_kernel(rho, bswap=bswap)
        want = render_smoke_mip_reference(rho, bswap=bswap)
        assert torch.equal(_bits(got), _bits(want))
        assert int(_bits(got)[7, 9]) == 0


@pytest.mark.parametrize("case", list(MIP_CASES))
def test_smoke_mip_kernel_cases_bit_equal(cuda, case):
    """Every branch of K10 and its plan (``mip_cases.py``, as
    ``chip_smoke.py`` phase 1b): one launch a call, bit-equal."""
    vol, vmax = mip_case(case, cuda)
    assert mip_plan(vol).route == MIP_CASES[case][-1]
    for bswap in (True, False):
        n = render_smoke_mip_kernel.launches
        got = render_smoke_mip_kernel(vol, bswap=bswap, vmax=vmax)
        assert render_smoke_mip_kernel.launches == n + 1
        want = render_smoke_mip_reference(vol, bswap=bswap, vmax=vmax)
        assert torch.equal(_bits(got), _bits(want))


@pytest.mark.parametrize("view", ["transpose", "slice", "flat-offset"])
def test_render_smoke_views_through_the_kernel(cuda, rng, view):
    """``render_smoke`` of a view of the volume (a transpose, a slice at an
    aligned storage offset, one at a misaligned offset) runs K10 once and
    equals the plain version bit for bit."""
    shape = (12, 130, 136)
    base = _on(1.2 * rng.random(shape, dtype=np.float32),
               cuda).to(torch.bfloat16)
    vol = {"transpose": lambda: base.transpose(1, 2),
           "slice": lambda: base[1:],
           "flat-offset": lambda: base.view(-1)[1:1 + 11 * 130 * 136].view(
               11, 130, 136)}[view]()
    n = render_smoke_mip_kernel.launches
    got = render_smoke(vol)
    assert render_smoke_mip_kernel.launches == n + 1
    assert torch.equal(_bits(got), _bits(render_smoke_mip_reference(vol)))


def test_smoke_mip_refuses_a_misaligned_vector_plan(cuda):
    """The C entry refuses 16-byte loads from a misaligned base or with
    ``H*W`` off the vector width, which the plan would never ask for."""
    from esp32_fluid_simulation_tpu_torch.ops.cuda.build import load
    d = torch.zeros(4 * 16 * 24 + 1, dtype=torch.bfloat16, device=cuda)
    out = torch.empty((16, 24), dtype=torch.uint16, device=cuda)
    for base, h, w in ((d.data_ptr() + 2, 16, 24), (d.data_ptr(), 3, 5)):
        with pytest.raises(RuntimeError, match="fluid_smoke_mip failed"):
            load().call("fluid_smoke_mip", base, out.data_ptr(), 4, h, w, 1,
                        8, 1, 32, 4, 1.0, 1, None)


@pytest.mark.parametrize("tiling", ["odd", "even"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_advect_member_overlay_kernel_bit_equal(cuda, rng, tiling, dtype):
    shape, member = TILINGS[tiling]
    cfg = SimConfig(shape=shape, max_impulses=8)
    imp = Impulses.from_lists(cfg, [(5, 7), (20, 40), (5, 7), (30, 60)],
                              [(30.0, -12.0), (-8.0, 25.0), (99.0, 1.0),
                               (0.0, 0.0)], device=cuda)
    ov = impulse_overlay(imp, shape)
    # sigma 200 cells/s: the CFL clamp binds on some cells
    vel = _on((200 * rng.standard_normal((2,) + shape)).astype(np.float32),
              cuda)
    before = (advect_kernel.launches, advect_kernel.member_launches,
              advect_kernel.overlay_launches)
    for overlay in (None, ov):
        got = advect_kernel(vel, vel, 1 / 30, True, self_advect=True,
                            member=member, overlay=overlay)
        want = advect_reference(vel, vel, 1 / 30, True, member=member,
                                overlay=overlay)
        assert torch.equal(got, want)
    assert (advect_kernel.launches, advect_kernel.member_launches,
            advect_kernel.overlay_launches) == (
        before[0] + 2, before[1] + 2, before[2] + 1)
    dye = _on(rng.random((3,) + shape, dtype=np.float32) * 2 - 0.5,
              cuda).to(dtype)
    for bswap in (True, False):
        c, f = advect_kernel(dye, vel, 1 / 30, False, clip01=True,
                             rgb565=True, bswap=bswap, member=member)
        rc, rf = advect_reference(dye, vel, 1 / 30, False, clip01=True,
                                  rgb565=True, bswap=bswap, member=member)
        assert torch.equal(_bits(c), _bits(rc))
        assert torch.equal(_bits(f), _bits(rf))
    ov4 = torch.cat([ov[:2], ov[1:2], ov[2:]])       # [4, H, W]
    c = advect_kernel(dye, vel, 1 / 30, False, clip01=True, member=member,
                      overlay=ov4)
    rc = advect_reference(dye, vel, 1 / 30, False, clip01=True,
                          member=member, overlay=ov4)
    assert torch.equal(_bits(c), _bits(rc))
    for field in (dye, dye[0].contiguous()):
        got = advect_kernel(field, vel, 1 / 30, True, return_minmax=True,
                            member=member)
        want = advect_reference(field, vel, 1 / 30, True,
                                return_minmax=True, member=member)
        for g, w in zip(got, want):
            assert torch.equal(_bits(g), _bits(w))


@pytest.mark.parametrize("tiling", ["odd", "even"])
def test_project_sor_member_kernels_bit_equal(cuda, rng, tiling):
    shape, member = TILINGS[tiling]
    cfg = SimConfig(shape=shape)
    vel = _on(rng.normal(0, 40, (2,) + shape).astype(np.float32), cuda)
    imp = Impulses.from_lists(
        cfg, [(member[0], 5), (20, 30), (20, 30), (99, -3)],
        [(90.0, -45.0), (33.0, 44.0), (-60.0, 120.0), (7.0, 8.0)],
        device=cuda)
    before = (project_fused.member_launches, sor_solve_kernel.member_launches)
    for impulses in (imp, None):
        v, p = project_fused(vel, 1.0, 10, 1.96, impulses=impulses,
                             member=member)
        rv, rp = project_fused_reference(vel, 1.0, 10, 1.96, impulses,
                                         member)
        assert torch.equal(v, rv) and torch.equal(p, rp)
    d = _on(rng.standard_normal(shape).astype(np.float32), cuda)
    for iters in (0, 1, 10):
        assert torch.equal(sor_solve_kernel(d, 0.7, iters, 1.96,
                                            member=member),
                           sor_solve_reference(d, 0.7, iters, 1.96, member))
    assert (project_fused.member_launches,
            sor_solve_kernel.member_launches) == (before[0] + 2,
                                                  before[1] + 3)


@pytest.mark.parametrize("dtype,channels,no_slip", [
    (torch.float32, 2, True), (torch.bfloat16, 3, False)])
def test_maccormack_member_kernel_bit_equal(cuda, rng, dtype, channels,
                                            no_slip):
    shape, member = TILINGS["odd"]
    vel = _on((200 * rng.standard_normal((2,) + shape)).astype(np.float32),
              cuda)
    field = vel if channels == 2 else _on(
        rng.random((channels,) + shape, dtype=np.float32), cuda).to(dtype)
    before = advect_maccormack_kernel.member_launches
    got = advect_maccormack_kernel(field, vel, 1 / 30, no_slip,
                                   member=member)
    want = advect_maccormack_reference(field, vel, 1 / 30, no_slip,
                                       member=member)
    assert torch.equal(_bits(got), _bits(want))
    assert advect_maccormack_kernel.member_launches == before + 1


# member stacks: (members, member tile), tiled 2x2, 2x3 and 1x3
STACKS = {"2x2": (4, (32, 48)), "2x3": (6, (32, 32)), "1x3": (3, (64, 32))}


@pytest.mark.parametrize("layout", sorted(STACKS))
def test_stack_member_kernels_bit_equal(cuda, rng, layout):
    """K2 and K1 on a member stack (addressed in place) against their
    supergrid member modes on the card under the permute, bit for bit:
    K2's self-advect with and without the overlay, its dye in float32 and
    bfloat16 with the clip, K1's trapezoid at iters 0, 1, 10 and 15 with
    and without impulses; each a stack launch."""
    from esp32_fluid_simulation_tpu_torch.models.stable_fluids import (
        _from_members, _to_members)
    from esp32_fluid_simulation_tpu_torch.ops.cuda.advect import (
        member_overlay)
    from esp32_fluid_simulation_tpu_torch.ops.cuda.modes import member_grid
    n, m = STACKS[layout]
    gh, gw = member_grid(n)
    h, w = gh * m[0], gw * m[1]
    vel_s = _on((200 * rng.standard_normal((n, 2) + m)).astype(np.float32),
                cuda)
    vel = _from_members(vel_s, h, w)
    imps = stack_impulses([Impulses.from_lists(
        SimConfig(shape=m, max_impulses=2), [(k + 3, 0), (m[0] - 1, 9 + k)],
        [(50.0 + 30 * k, -40.0), (25.0, -60.0 + 10 * k)], device=cuda)
        for k in range(n)])
    ov = member_overlay(imps, gh, gw, *m)
    before = (advect_kernel.stack_launches, advect_kernel.member_launches,
              project_fused.stack_launches, project_fused.member_launches)
    for overlay in (None, ov):
        got = advect_kernel(vel_s, None, 1 / 30, True, self_advect=True,
                            member=m, overlay=overlay)
        want = advect_kernel(vel, vel, 1 / 30, True, self_advect=True,
                             member=m, overlay=overlay)
        assert torch.equal(got, _to_members(want, *m))
    for dtype in (torch.float32, torch.bfloat16):
        dye_s = _on(rng.random((n, 3) + m, dtype=np.float32) * 2 - 0.5,
                    cuda).to(dtype)
        got = advect_kernel(dye_s, vel_s, 1 / 30, False, clip01=True,
                            member=m)
        want = advect_kernel(_from_members(dye_s, h, w), vel, 1 / 30, False,
                             clip01=True, member=m)
        assert torch.equal(_bits(got), _bits(_to_members(want, *m)))
    vel_s = _on(rng.normal(0, 40, (n, 2) + m).astype(np.float32), cuda)
    vel = _from_members(vel_s, h, w)
    imp = Impulses.from_lists(
        SimConfig(shape=(h, w), max_impulses=4),
        [(3, 5), (m[0], w - 1), (h - 1, m[1] - 1)],
        [(30.0, -12.0), (-8.0, 25.0), (9.0, 1.0)], device=cuda)
    for iters in (0, 1, 10, 15):
        for impulses in (None, imp):
            v, p = project_fused(vel_s, 1.0, iters, 1.96, impulses=impulses,
                                 member=m)
            rv, rp = project_fused(vel, 1.0, iters, 1.96, impulses=impulses,
                                   member=m)
            assert torch.equal(v, _to_members(rv, *m))
            assert torch.equal(p, _to_members(rp[None], *m)[:, 0])
    assert (advect_kernel.stack_launches, advect_kernel.member_launches,
            project_fused.stack_launches, project_fused.member_launches) == (
        before[0] + 4, before[1] + 8, before[2] + 8, before[3] + 16)


def test_tiled_ensemble_step_kernel_route(cuda, rng):
    """Four 32x48 members through ``make_ensemble_step`` on the card (the
    kernel route on the member stack: the member overlay built by one
    launch, K2 member twice, once with the overlay, K1 member once, each a
    stack launch, no layout conversion) against the same step through the
    plain versions on the supergrid on the card, the overlay's
    included."""
    cfg = SimConfig(shape=(32, 48), sor_iters=4, max_impulses=2,
                    advect_impl="pallas")
    n = 4
    st = init_ensemble(cfg, n, device=cuda)
    imps = stack_impulses([Impulses.from_lists(
        cfg, [(8 + k, 9), (20, 4 + k)], [(50.0 + 30 * k, -40.0),
                                          (25.0, -60.0 + 10 * k)],
        device=cuda) for k in range(n)])
    from esp32_fluid_simulation_tpu_torch.ops.cuda.advect import (
        member_overlay, member_overlay_reference)
    from esp32_fluid_simulation_tpu_torch.models import ensemble as E
    before = (advect_kernel.member_launches, advect_kernel.overlay_launches,
              project_fused.member_launches, member_overlay.launches,
              advect_kernel.stack_launches, project_fused.stack_launches,
              E.layout_conversions())
    out = make_ensemble_step(cfg)(st, imps)
    assert (advect_kernel.member_launches, advect_kernel.overlay_launches,
            project_fused.member_launches, member_overlay.launches,
            advect_kernel.stack_launches, project_fused.stack_launches,
            E.layout_conversions()) == (
        before[0] + 2, before[1] + 1, before[2] + 1, before[3] + 1,
        before[4] + 2, before[5] + 1, before[6])
    from esp32_fluid_simulation_tpu_torch.models.stable_fluids import (
        _from_members, _to_members)
    cfg_super, gh, gw = E.tiled_ensemble_config(cfg, n)
    h, w = cfg_super.shape
    m = cfg.shape
    vel = _from_members(st.velocity, h, w)
    ov = member_overlay_reference(imps, gh, gw, *m)
    vel = advect_reference(vel, vel, cfg.dt, True, member=m, overlay=ov)
    vel, _ = project_fused_reference(vel, cfg.dx, cfg.sor_iters, cfg.omega,
                                     member=m)
    color = advect_reference(_from_members(st.color, h, w), vel, cfg.dt,
                             False, clip01=True, member=m)
    assert torch.equal(out.velocity, _to_members(vel, *m))
    assert torch.equal(out.color, _to_members(color, *m))


def _block_of(x, off, bshape, g):
    """The owned block at ``off`` with ``g`` ghosts, cut from the
    zero-padded grid (as the halo exchange builds it)."""
    pad = torch.nn.functional.pad(x, (g, g, g, g))
    return pad[..., off[0]:off[0] + bshape[0] + 2 * g,
               off[1]:off[1] + bshape[1] + 2 * g].contiguous()


BLOCK_GLOBAL, BLOCK = (130, 200), (65, 100)
BLOCK_OFFSETS = [(0, 0), (65, 100), (0, 100), (30, 50)]


@pytest.mark.parametrize("off", BLOCK_OFFSETS)
def test_block_kernels_bit_equal(cuda, rng, off):
    """K11: K2, K1 and K4 in block mode against their plain versions, and
    the crop of the whole-grid kernel, bit for bit."""
    kw = dict(global_offset=off, global_shape=BLOCK_GLOBAL)
    vel = _on((200 * rng.standard_normal((2,) + BLOCK_GLOBAL)).astype(
        np.float32), cuda)
    vown = vel[:, off[0]:off[0] + BLOCK[0], off[1]:off[1] + BLOCK[1]]
    vown = vown.contiguous()
    dye = _on(rng.random((3,) + BLOCK_GLOBAL, dtype=np.float32),
              cuda).to(torch.bfloat16)
    before = (advect_kernel.block_launches, project_fused.block_launches,
              sor_solve_kernel.block_launches)
    for field, no_slip, clip01, minmax in ((vel, True, False, True),
                                           (dye, False, True, False),
                                           (dye[0].contiguous(), False,
                                            False, True)):
        fpad = _block_of(field, off, BLOCK, 13)
        got = advect_kernel(fpad, vown, 1 / 30, no_slip, max_disp=12,
                            clip01=clip01, return_minmax=minmax, halo=13,
                            **kw)
        want = advect_reference(fpad, vown, 1 / 30, no_slip, 12,
                                clip01=clip01, return_minmax=minmax,
                                block=_blk(off, 13))
        whole = advect_kernel(field, vel, 1 / 30, no_slip, max_disp=12,
                              clip01=clip01, return_minmax=minmax)
        for g, w, full in zip(*((got, want, whole) if minmax else
                               ((got,), (want,), (whole,)))):
            assert torch.equal(_bits(g), _bits(w))
            assert torch.equal(_bits(g), _bits(
                full[..., off[0]:off[0] + BLOCK[0],
                     off[1]:off[1] + BLOCK[1]]))
    cfg = SimConfig(shape=BLOCK_GLOBAL)
    imp = Impulses.from_lists(cfg, [(20, 30), (20, 30), (70, 120),
                                    (200, -3)],
                              [(90.0, -45.0), (33.0, 44.0), (-60.0, 120.0),
                               (7.0, 8.0)], device=cuda)
    vpad = _block_of(vel, off, BLOCK, 22)
    for impulses in (imp, None):
        v, p = project_fused(vpad, 1.0, 10, 1.96, impulses=impulses,
                             halo=22, **kw)
        rv, rp = project_fused_reference(vpad, 1.0, 10, 1.96, impulses,
                                         block=_blk(off, 22))
        wv, wp = project_fused(vel, 1.0, 10, 1.96, impulses=impulses)
        assert torch.equal(v, rv) and torch.equal(p, rp)
        assert torch.equal(v, wv[:, off[0]:off[0] + BLOCK[0],
                                 off[1]:off[1] + BLOCK[1]])
    d = vel[0].contiguous()
    dpad = _block_of(d, off, BLOCK, 20)
    got = sor_solve_kernel(dpad, 0.7, 10, 1.96, halo=20, **kw)
    assert torch.equal(got, sor_solve_reference(dpad, 0.7, 10, 1.96,
                                                block=_blk(off, 20)))
    assert torch.equal(got, sor_solve_kernel(d, 0.7, 10, 1.96)[
        off[0]:off[0] + BLOCK[0], off[1]:off[1] + BLOCK[1]])
    assert (advect_kernel.block_launches, project_fused.block_launches,
            sor_solve_kernel.block_launches) == (before[0] + 3,
                                                 before[1] + 2,
                                                 before[2] + 1)


@pytest.mark.parametrize("iters,member", [(0, None), (1, None), (20, None),
                                          (10, (65, 40))])
@pytest.mark.parametrize("off", BLOCK_OFFSETS)
def test_block_project_iters_bit_equal(cuda, rng, off, iters, member):
    """K11 K1 at iters 0, 1 and 20 (the launch sequence) and with 65x40
    members, against its plain version and the crop of whole-grid K1."""
    kw = dict(global_offset=off, global_shape=BLOCK_GLOBAL)
    vel = _on((40 * rng.standard_normal((2,) + BLOCK_GLOBAL)).astype(
        np.float32), cuda)
    g = 2 * iters + 2
    vpad = _block_of(vel, off, BLOCK, g)
    for impulses in (_seam_impulses(BLOCK_GLOBAL, iters, cuda), None):
        v, p = project_fused(vpad, 1.0, iters, 1.96, impulses=impulses,
                             member=member, halo=g, **kw)
        rv, rp = project_fused_reference(vpad, 1.0, iters, 1.96, impulses,
                                         member, block=_blk(off, g))
        wv, _ = project_fused(vel, 1.0, iters, 1.96, impulses=impulses,
                              member=member)
        assert torch.equal(v, rv) and torch.equal(p, rp)
        assert torch.equal(v, wv[:, off[0]:off[0] + BLOCK[0],
                                 off[1]:off[1] + BLOCK[1]])


def _blk(off, g):
    from esp32_fluid_simulation_tpu_torch.ops.cuda.modes import Block
    return Block(off[0], off[1], *BLOCK_GLOBAL, g, *BLOCK)


BLOCK3_GLOBAL = (9,) + BLOCK_GLOBAL


@pytest.mark.parametrize("off", BLOCK_OFFSETS)
def test_block_kernels3d_bit_equal(cuda, rng, off):
    """K11 for K7 and K9: K7 in block mode against its plain version and
    the crop of whole-grid K7; one ``sor3d_chunk`` from zero and one that
    continues a whole-grid solve, against the plain version on every cell
    and whole-grid K9 on the owned cells, bit for bit."""
    md, k, sweeps = 2, 3, 3
    g = 2 * sweeps
    # sigma 40 cells/s: the CFL clamp at max_disp=2 binds on some cells
    vel = _on((40 * rng.standard_normal((3,) + BLOCK3_GLOBAL)).astype(
        np.float32), cuda)
    vown = _block_of(vel, off, BLOCK, 0)
    pair = _on(rng.random((2,) + BLOCK3_GLOBAL, dtype=np.float32),
               cuda).to(torch.bfloat16)
    before = (advect3d_kernel.block_launches, sor3d_chunk.launches)
    for field, no_slip in ((vel, True), (pair, False)):
        fpad = _block_of(field, off, BLOCK, k)
        got = advect3d_kernel(fpad, vown, 1 / 30, no_slip, max_disp=md,
                              global_offset=off, global_shape=BLOCK3_GLOBAL,
                              halo=k)
        assert torch.equal(_bits(got), _bits(advect3d_reference(
            fpad, vown, 1 / 30, no_slip, md, _blk(off, k))))
        whole = advect3d_kernel(field, vel, 1 / 30, no_slip, max_disp=md)
        assert torch.equal(_bits(got), _bits(_block_of(whole, off, BLOCK, 0)))
    # the self-advect reads the velocity from the haloed field
    vpad = _block_of(vel, off, BLOCK, k)
    got = advect3d_kernel(vpad, None, 1 / 30, True, max_disp=md,
                          global_offset=off, global_shape=BLOCK3_GLOBAL,
                          halo=k)
    assert torch.equal(got, advect3d_reference(vpad, None, 1 / 30, True, md,
                                               _blk(off, k)))
    assert torch.equal(got, advect3d_kernel(vpad, vown, 1 / 30, True,
                                            max_disp=md, global_offset=off,
                                            global_shape=BLOCK3_GLOBAL,
                                            halo=k))
    d = _on(rng.standard_normal(BLOCK3_GLOBAL).astype(np.float32), cuda)
    dpad = _block_of(d, off, BLOCK, g)
    origin = (0, off[0] - g, off[1] - g)
    for p0, total in ((torch.zeros_like(dpad), sweeps),
                      (_block_of(sor3d_solve(d, 0.7, sweeps, 1.5), off, BLOCK,
                                 g), 2 * sweeps)):
        got = sor3d_chunk(dpad, p0, 0.7, sweeps, 1.5, global_offset=origin,
                          global_shape=BLOCK3_GLOBAL)
        assert torch.equal(got, sor3d_chunk_reference(
            dpad, p0, 0.7, sweeps, 1.5, origin, BLOCK3_GLOBAL))
        assert torch.equal(got[:, g:g + BLOCK[0], g:g + BLOCK[1]], _block_of(
            sor3d_solve(d, 0.7, total, 1.5), off, BLOCK, 0))
    assert (advect3d_kernel.block_launches, sor3d_chunk.launches) == (
        before[0] + 4, before[1] + 2)


def test_sharded_smoke_kernel_step_on_one_card(cuda):
    """The sharded plume on a 2x2 mesh of one card equals the single-device
    kernel step bit for bit, with K7 in block mode twice (the velocity
    self-advect and the stacked scalars) and the K9 block chunk
    ceil(iters/chunk) times per shard and step."""
    from esp32_fluid_simulation_tpu_torch import (SmokeConfig, init_smoke,
                                                  make_smoke_step)
    from esp32_fluid_simulation_tpu_torch.parallel import (
        make_mesh, make_sharded_smoke_step, shard_smoke_state,
        unshard_smoke_state)
    cfg = SmokeConfig(shape=(16, 32, 48), advect_impl="pallas",
                      sor_impl="pallas")
    mesh = make_mesh([cuda] * 4, grid_shape=(2, 2))
    st = init_smoke(cfg, device=cuda)
    one, sharded = make_smoke_step(cfg), make_sharded_smoke_step(cfg, mesh)
    a, b = st, shard_smoke_state(st, cfg, mesh)
    before = (advect3d_kernel.block_launches, sor3d_chunk.launches)
    for _ in range(3):
        a, b = one(a), sharded(b)
    b = unshard_smoke_state(b, cuda)
    for name in ("velocity", "density", "temperature"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name
    chunks = -(-cfg.sor_iters // cfg.sor_chunk)
    assert (advect3d_kernel.block_launches, sor3d_chunk.launches) == (
        before[0] + 2 * 4 * 3, before[1] + 4 * chunks * 3)


@pytest.mark.parametrize("solver", ["fused_pallas", "sor_pallas"])
def test_sharded_kernel_step_on_one_card(cuda, solver):
    """The sharded step on a 2x2 mesh of one card (four blocks on cuda:0)
    equals the single-device kernel step bit for bit, with K1 (or K4) once
    and K2 twice per shard and step in block mode."""
    from esp32_fluid_simulation_tpu_torch import init_state, make_step
    from esp32_fluid_simulation_tpu_torch.io_host.touch import scripted_swirl
    from esp32_fluid_simulation_tpu_torch.parallel import (
        make_mesh, make_sharded_step, shard_state, unshard_state)
    cfg = SimConfig(shape=(128, 192), solver=solver, advect_impl="pallas",
                    color_dtype="bfloat16", sor_iters=6)
    mesh = make_mesh([cuda] * 4, grid_shape=(2, 2))
    st = init_state(cfg, device=cuda)
    one, sharded = make_step(cfg), make_sharded_step(cfg, mesh)
    a, b = st, shard_state(st, cfg, mesh)
    before = (advect_kernel.block_launches, project_fused.block_launches,
              sor_solve_kernel.block_launches)
    for t in range(3):
        imp = scripted_swirl(cfg, t, device=cuda)
        a, b = one(a, imp), sharded(b, imp)
    b = unshard_state(b, cuda)
    assert torch.equal(a.velocity, b.velocity)
    assert torch.equal(a.color, b.color)
    k1 = 12 if solver == "fused_pallas" else 0
    assert (advect_kernel.block_launches, project_fused.block_launches,
            sor_solve_kernel.block_launches) == (before[0] + 24,
                                                 before[1] + k1,
                                                 before[2] + 12 - k1)


# One call of each wrapper the launch path serves: (its inputs from a
# generator, as float32 arrays; the call)
LAUNCH_CASES = {
    "K1 project_fused": (
        lambda g: [200 * g.standard_normal((2,) + SHAPE)],
        lambda v: project_fused(v, 1.0, 10, 1.96)),
    "K2 advect_kernel": (
        lambda g: [g.random((3,) + SHAPE), 200 * g.standard_normal(
            (2,) + SHAPE)],
        lambda f, v: advect_kernel(f, v, 1 / 30, False, clip01=True)),
    "K3 render_rgb565_kernel": (
        lambda g: [g.random((3,) + SHAPE)],
        lambda c: render_rgb565_kernel(c, 3)),
    "K4 sor_solve_kernel": (
        lambda g: [g.standard_normal(SHAPE)], sor_solve_kernel),
    "K5 advect_maccormack_kernel": (
        lambda g: [g.random((3,) + SHAPE), 200 * g.standard_normal(
            (2,) + SHAPE)],
        lambda f, v: advect_maccormack_kernel(f, v, 1 / 30, False)),
    "K7 advect3d_kernel": (
        lambda g: [20 * g.standard_normal((3,) + SHAPE3)],
        lambda v: advect3d_kernel(v, None, 1 / 30, True)),
    "K7 advect3d_kernel source": (
        lambda g: [g.random((2,) + SHAPE3), 20 * g.standard_normal(
            (3,) + SHAPE3)],
        lambda s, v: _k7_with_source(s, v)),
    "K8 divergence3d": (
        lambda g: [g.standard_normal((3,) + SHAPE3)], divergence3d),
    "K8 subtract_gradient3d": (
        lambda g: [g.standard_normal((3,) + SHAPE3),
                   g.standard_normal(SHAPE3)], subtract_gradient3d),
    "K9 sor3d_solve": (lambda g: [g.standard_normal(SHAPE3)], sor3d_solve),
    "K10 render_smoke_mip_kernel": (
        lambda g: [g.random(SHAPE3)], render_smoke_mip_kernel),
}


def _k7_with_source(pair, vel):
    """K7's scalar launch with the plume's source on a sphere at SHAPE3
    (the mask built on the inputs' device and stream); returns the scalars
    and the velocity it wrote, a copy of ``vel``."""
    from esp32_fluid_simulation_tpu_torch.models.smoke3d import (
        SmokeConfig, plume_source, source_tensor)
    cfg = SmokeConfig(shape=SHAPE3, source_center=(0.5, 0.5, 0.25),
                      source_radius=0.6)
    vel, pair = vel.clone(), pair.to(torch.bfloat16)
    out = advect3d_source_kernel(
        pair[0], pair[1], vel, 1 / 30, False,
        plume_source(cfg, source_tensor(cfg, vel.device)), 2)
    return out, vel


def _outputs(got):
    return got if isinstance(got, tuple) else (got,)


@pytest.mark.parametrize("case", sorted(LAUNCH_CASES))
def test_wrapper_launches_on_the_current_stream(cuda, rng, case):
    """Under ``torch.cuda.stream(s)`` a wrapper's kernels run on ``s``: its
    inputs are written on ``s`` behind a ~25 ms sleep, so a kernel on any
    other stream would read them unwritten (zeros).  The result equals the
    default stream's bit for bit."""
    make, call = LAUNCH_CASES[case]
    inputs = [_on(a.astype(np.float32), cuda) for a in make(rng)]
    want = _outputs(call(*inputs))
    blank = [torch.zeros_like(t) for t in inputs]
    torch.cuda.synchronize()
    s = torch.cuda.Stream(cuda)
    with torch.cuda.stream(s):
        torch.cuda._sleep(50_000_000)
        for b, t in zip(blank, inputs):
            b.copy_(t)
        got = _outputs(call(*blank))
    s.synchronize()
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert torch.equal(_bits(g), _bits(w))


@pytest.mark.parametrize("case", sorted(LAUNCH_CASES))
def test_wrapper_launches_on_a_second_card(cuda, rng, case):
    """With cuda:0 current, a wrapper given tensors on cuda:1 runs its
    kernels there (the launch path makes that card current for the launch
    only), bit-equal to the same call on cuda:0."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs a second CUDA device")
    make, call = LAUNCH_CASES[case]
    arrays = [a.astype(np.float32) for a in make(rng)]
    second = torch.device("cuda", 1)
    want = _outputs(call(*[_on(a, cuda) for a in arrays]))
    got = _outputs(call(*[_on(a, second) for a in arrays]))
    torch.cuda.synchronize(second)
    assert torch.cuda.current_device() == cuda.index
    for g, w in zip(got, want):
        assert g.device == second
        assert torch.equal(_bits(g).cpu(), _bits(w).cpu())


# -- the feed: Impulses.from_lists through pinned staging -----------------


def _feed_cfg(dtype="float32", nd=2):
    return SimConfig(shape=feed_cases.SHAPES[nd], dtype=dtype)


@pytest.mark.parametrize("count", feed_cases.COUNTS)
@pytest.mark.parametrize("nd", [2, 3])
@pytest.mark.parametrize("dtype", feed_cases.DTYPES)
def test_staged_feed_is_the_pageable_batch(cuda, dtype, nd, count):
    """The card's batch equals the pageable route's bit for bit, its three
    fields views of one device copy; one call counts one staged upload."""
    cfg = _feed_cfg(dtype, nd)
    pos, vel = feed_cases.lists(nd, count)
    before = Impulses.staged_uploads
    got = Impulses.from_lists(cfg, pos, vel, device=cuda)
    assert Impulses.staged_uploads == before + 1
    feed_cases.assert_bit_equal(got, feed_cases.parent_batch(cfg, pos, vel,
                                                             cuda))
    base = got.pos.untyped_storage().data_ptr()
    assert all(t.untyped_storage().data_ptr() == base for t in got)


def test_staged_feed_never_synchronises(cuda):
    """200 feeds under ``set_sync_debug_mode("error")`` raise nothing; the
    pageable route raises there, so the mode is on."""
    cfg = _feed_cfg()
    pos, vel = feed_cases.lists(2, 8)
    Impulses.from_lists(cfg, pos, vel, device=cuda)
    torch.cuda.synchronize()
    before = Impulses.staged_uploads
    torch.cuda.set_sync_debug_mode("error")
    try:
        for t in range(200):
            Impulses.from_lists(cfg, pos[: t % 9], vel[: t % 9], device=cuda)
        with pytest.raises(RuntimeError):
            feed_cases.parent_batch(cfg, pos, vel, cuda)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert Impulses.staged_uploads == before + 200


def test_staged_feeds_behind_a_busy_card_land_whole(cuda):
    """64 distinct batches fed back to back behind a ~25 ms sleep on the
    stream (their copies still queued when the host is done) each land
    equal to the pageable route's: no pinned block is written again
    before its copy has landed."""
    cfg = _feed_cfg()
    cases = [feed_cases.lists(2, 16, seed=1000 + i) for i in range(64)]
    torch.cuda.synchronize()
    torch.cuda._sleep(50_000_000)
    got = [Impulses.from_lists(cfg, p, v, device=cuda) for p, v in cases]
    assert not torch.cuda.current_stream().query()
    torch.cuda.synchronize()
    for batch, (p, v) in zip(got, cases):
        feed_cases.assert_bit_equal(batch, feed_cases.parent_batch(cfg, p, v,
                                                                   cuda))


def _stir(t, nd, n):
    """Step t's stirring: eight pokes on a ring around the grid's centre."""
    ang = 0.15 * t + 2 * np.pi * np.arange(8) / 8
    pos = [((n // 2 + round(0.3 * n * np.cos(a)),
             n // 2 + round(0.3 * n * np.sin(a))) if nd == 2 else
            (int(0.6 * n), n // 2 + round(0.1 * n * np.cos(a)),
             n // 2 + round(0.1 * n * np.sin(a)))) for a in ang]
    vel = [((-60.0 * np.sin(a), 60.0 * np.cos(a)) if nd == 2 else
            (0.0, -45.0 * np.sin(a), 45.0 * np.cos(a))) for a in ang]
    return pos, vel


@pytest.mark.parametrize("entry", ["config0", "plume"])
def test_stirred_steps_fed_staged_equal_steps_fed_pageable(cuda, entry):
    """Three stirred steps of config 0 at 256^2 (K1, K2) and of the plume at
    64^3 (K7-K10, the drain), fed through pinned staging, equal the same
    steps fed through the pageable route, bit for bit."""
    import json
    from pathlib import Path
    from esp32_fluid_simulation_tpu_torch import (SmokeConfig, init_smoke,
                                                  init_state,
                                                  make_smoke_step)
    from esp32_fluid_simulation_tpu_torch.models.stable_fluids import (
        make_step_render)
    if entry == "config0":
        sim = json.loads((Path(__file__).resolve().parents[1] / "examples"
                          / "config0_4096_production.json").read_text())
        cfg = SimConfig(**dict(sim, shape=(256, 256), domain_tile=None))
        step_render, n, nd = make_step_render(cfg), 256, 2

        def run(st, imp):
            st, frame = step_render(st, imp)
            return st, (st.velocity, st.color, frame)
        states = [init_state(cfg, device=cuda) for _ in range(2)]
    else:
        cfg = SmokeConfig(shape=(64, 64, 64), advect_impl="pallas",
                          sor_impl="pallas")
        step, n, nd = make_smoke_step(cfg), 64, 3

        def run(st, imp):
            st = step(st, imp)
            return st, (st.velocity, st.density, st.temperature,
                        render_smoke(st.density))
        states = [init_smoke(cfg, device=cuda) for _ in range(2)]
    staged, pageable = states
    for t in range(3):
        pos, vel = _stir(t, nd, n)
        staged, got = run(staged, Impulses.from_lists(cfg, pos, vel,
                                                      device=cuda))
        pageable, want = run(pageable, feed_cases.parent_batch(cfg, pos, vel,
                                                               cuda))
    for g, w in zip(got, want):
        assert torch.equal(feed_cases.bits(g), feed_cases.bits(w))
    assert float(want[0].abs().max()) > 0.0
