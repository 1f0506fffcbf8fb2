#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port (``esp32_fluid_simulation_tpu_torch``) on
one NVIDIA GPU and check it.

    python3 chip_smoke.py

Needs one CUDA device, ``nvcc`` and the repository checkout around this
file; it exits non-zero on any failure and imports nothing of JAX.

1. Builds the kernels from ``esp32_fluid_simulation_tpu_torch/csrc/*.cu``
   (one ``nvcc`` per source, all at once) and holds each 2D kernel (K1
   projection, K2 advection with and without its corner extrema, K3 RGB565
   upscale, K4 SOR solve, K5 MacCormack advection) against its plain
   PyTorch version on the card, at small odd shapes and at the production
   shapes (K4 at 4096^2, K5 at config 3's 2048^2); bit-equality is expected
   (``--fmad=false``).
1b. The same for the 3D smoke kernels (K7 advection, K8 divergence and
   gradient subtract, K9 SOR, K10 MIP render) at (9, 33, 130) and 256^3.
2. The reference workload ``SimConfig()`` against the golden trajectory
   ``tests/golden/ref_61x81_4steps.npz`` (rtol 1e-4, atol 2e-4), on the
   composed path and on the kernel path.
3. The 2D main path: ``examples/config0_4096_production.json`` through
   ``make_step_render`` for 30 steps of ``scripted_swirl``, with the launch
   counters proving K1 ran once and K2 twice per step, checked against the
   same steps on the plain path on the card.
4. The same config at ``scaling=4``: ``make_step_render`` renders through
   K3, checked against the plain render.
6. The 24^3 multigrid smoke config for 5 steps against the golden
   ``tests/golden/path_smoke3d.npz`` (rtol 1e-4, atol 1e-4).
7. The 3D main path: the default ``SmokeConfig`` at 256^3 through
   ``make_smoke_step`` + ``render_smoke`` for 20 steps, with the launch
   counters proving K7 ran twice, K8 (each) and K9 once per step and K10
   once per frame; the plume checked and held against the same steps on
   the plain path on the card.
8. Config 3: ``examples/config3_2048_maccormack_multigrid.json`` through
   ``make_step_render`` for 20 steps (K5 forward = K5 backward = 2 per
   step, no K2 launch), bit-identical to the plain path on the card.
9. Config 0 with ``solver="sor_pallas"`` through ``make_step`` for 10
   steps at 4096^2 (K4 once and K2 twice per step, K1 never), bit-identical
   to the plain path.
10. Config 2: ``examples/config2_512_vorticity_ab.json`` through
   ``make_step_render`` for 20 steps (K2 twice and K3 once per step, the
   confinement and SOR eager), bit-identical to the plain path.
11. The 2D golden trajectories ``tests/golden/path_{maccormack,rk2,
   vorticity,multigrid}.npz`` (rtol 1e-4; atol 1e-4, 3e-4 for vorticity and
   multigrid, see ``GOLDEN_ATOL``), MacCormack also through K5.
12. ``step_with_metrics`` on config 0 for 5 steps (its state bit-equal to
   ``step_render``'s, the divergence reduced by the projection), and a 64^3
   smoke plume with vorticity confinement against the plain path.
5. Times (CUDA events), last: ms/step of the kernel and plain paths at
   4096^2, at 256^3, of config 3, of the ``sor_pallas`` step and of config
   2, and ms per call of each kernel and its plain version.

Each kernel's entry in the summary carries its bound: the larger of the
bytes it must move (each input read once, each output written once) over
3.35 TB/s and its float32 operations over 67 TFLOP/s, the H100 SXM's
published peaks.  The last line is ``{"ok": true, "device": {...}}``; the
line before it is the per-kernel JSON summary.
"""

from __future__ import annotations

import dataclasses
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
GOLDEN = ROOT / "tests" / "golden" / "ref_61x81_4steps.npz"
CONFIG0 = ROOT / "examples" / "config0_4096_production.json"
CONFIG2 = ROOT / "examples" / "config2_512_vorticity_ab.json"
CONFIG3 = ROOT / "examples" / "config3_2048_maccormack_multigrid.json"
SMOKE_GOLDEN = ROOT / "tests" / "golden" / "path_smoke3d.npz"
MAIN_STEPS = 30
RENDER_STEPS = 3
SMOKE_STEPS = 20
CONFIG3_STEPS = 20
SOR_STEPS = 10
CONFIG2_STEPS = 20
METRIC_STEPS = 5
SMALL = (61, 81)
PROD = (4096, 4096)
MC_PROD = (2048, 2048)
# The 2D path goldens (tools/gen_golden_paths.py): 48x64 (multigrid 49x65),
# 5 steps.  They come from the jitted JAX step, whose XLA fusions contract
# multiply-adds into FMAs; an eager step (JAX's own under jax.disable_jit,
# or this port) misses the vorticity and multigrid goldens by up to 2.2e-4
# beyond rtol 1e-4 / atol 1e-4 on one velocity cell, hence their atol.
PATH_GOLDENS = {
    "maccormack": dict(shape=(48, 64), advector="maccormack", sor_iters=6),
    "rk2": dict(shape=(48, 64), advector="rk2", sor_iters=6),
    "vorticity": dict(shape=(48, 64), vorticity_eps=2.0, sor_iters=6),
    "multigrid": dict(shape=(49, 65), solver="multigrid", omega=1.3),
}
GOLDEN_ATOL = {"vorticity": 3e-4, "multigrid": 3e-4}
SMALL3 = (9, 33, 130)
SMOKE = (256, 256, 256)
PEAK_BYTES_PER_S = 3.35e12     # H100 SXM HBM3
PEAK_F32_PER_S = 67e12         # H100 SXM float32 outside the tensor cores
PKG = "esp32_fluid_simulation_tpu_torch"
TPU = "esp32_fluid_simulation_tpu"
KERNELS = {
    # name: (source, replaced TPU kernel)
    "K1 project_fused": (f"{PKG}/csrc/project.cu",
                         f"{TPU}/ops/pallas/project.py:203"),
    "K2 advect_kernel": (f"{PKG}/csrc/advect.cu",
                         f"{TPU}/ops/pallas/advect.py:715"),
    "K3 render_rgb565_kernel": (f"{PKG}/csrc/upscale.cu",
                                f"{TPU}/render/pallas_upscale.py:171"),
    "K4 sor_solve_kernel": (f"{PKG}/csrc/sor.cu",
                            f"{TPU}/ops/pallas/sor.py:93"),
    "K5 advect_maccormack_kernel": (f"{PKG}/csrc/advect.cu",
                                    f"{TPU}/ops/pallas/advect.py:965"),
    "K7 advect3d_kernel": (f"{PKG}/csrc/advect3d.cu",
                           f"{TPU}/ops/pallas/advect3d.py:255"),
    "K8 divergence3d": (f"{PKG}/csrc/fd3d.cu",
                        f"{TPU}/ops/pallas/fd3d.py:138"),
    "K8 subtract_gradient3d": (f"{PKG}/csrc/fd3d.cu",
                               f"{TPU}/ops/pallas/fd3d.py:167"),
    "K9 sor3d_solve": (f"{PKG}/csrc/sor3d.cu",
                       f"{TPU}/ops/pallas/sor3d.py:265"),
    "K10 render_smoke_mip_kernel": (f"{PKG}/csrc/smoke_mip.cu",
                                    f"{TPU}/render/pallas_smoke.py:46"),
}


def card_line() -> str:
    smi = shutil.which("nvidia-smi")
    if smi is None:
        return "nvidia-smi: not found"
    res = subprocess.run([smi, "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return res.stdout.strip().splitlines()[0] if res.stdout.strip() else (
        f"nvidia-smi failed: {res.stderr.strip()}")


def compare(name, got, want):
    """Bit-equality of two results (frames as uint16, fields by value);
    returns max |diff| and raises if they differ."""
    if got.dtype == torch.uint16:
        g, w = got.view(torch.int16).int(), want.view(torch.int16).int()
    else:
        g, w = got.float(), want.float()
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{name}: {got.dtype}{tuple(got.shape)} vs "
                             f"{want.dtype}{tuple(want.shape)}")
    diff = (g - w).abs()
    max_abs = float(diff.max())
    equal = float((g == w).float().mean())
    print(f"  {name}: max|d|={max_abs:.3g} equal={100 * equal:.4f}%")
    if not torch.equal(g, w):
        raise AssertionError(f"{name}: kernel differs from its plain version "
                             f"(max |d| {max_abs}, {100 * equal:.4f}% equal)")
    return max_abs


def cuda_ms(fn, n, warmup=1):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def bound(nbytes, flops):
    """(ms, what bounds it): the least time the card could take for work
    that moves ``nbytes`` and does ``flops`` float32 operations."""
    t_bytes = 1e3 * nbytes / PEAK_BYTES_PER_S
    t_ops = 1e3 * flops / PEAK_F32_PER_S
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def phase1_kernels(dev):
    """Each kernel against its plain version, small and production shapes."""
    from esp32_fluid_simulation_tpu_torch import SimConfig, Impulses
    from esp32_fluid_simulation_tpu_torch.ops.cuda.advect import (
        advect_kernel, advect_maccormack_kernel, advect_maccormack_reference,
        advect_reference)
    from esp32_fluid_simulation_tpu_torch.ops.cuda.project import (
        project_fused, project_fused_reference)
    from esp32_fluid_simulation_tpu_torch.ops.cuda.sor import (
        sor_solve_kernel, sor_solve_reference)
    from esp32_fluid_simulation_tpu_torch.render.cuda_upscale import (
        render_rgb565_kernel, render_rgb565_reference)

    gen = torch.Generator(device=dev).manual_seed(1234)
    err = {k: 0.0 for k in KERNELS}
    dt = 1.0 / 30.0
    for shape in (SMALL, PROD):
        h, w = shape
        print(f"phase 1 kernels vs plain at {h}x{w}")
        # sigma 200 cells/s: |v|*dt > max_disp=12 on ~7% of the cells
        vel = 200.0 * torch.randn((2, h, w), generator=gen, device=dev)
        got = advect_kernel(vel, vel, dt, True, max_disp=12,
                            self_advect=True)
        want = advect_reference(vel, vel, dt, True, max_disp=12)
        err["K2 advect_kernel"] = max(err["K2 advect_kernel"], compare(
            "K2 self-advect f32 no_slip", got, want))
        vel = 60.0 * torch.randn((2, h, w), generator=gen, device=dev)
        dye = (2.0 * torch.rand((3, h, w), generator=gen, device=dev)
               - 0.5).to(torch.bfloat16)
        for bswap in (True, False):
            got_c, got_f = advect_kernel(dye, vel, dt, False, max_disp=12,
                                         clip01=True, rgb565=True,
                                         bswap=bswap)
            want_c, want_f = advect_reference(dye, vel, dt, False,
                                              max_disp=12, clip01=True,
                                              rgb565=True, bswap=bswap)
            e = max(compare(f"K2 dye bf16 clip01 bswap={bswap}", got_c,
                            want_c),
                    compare(f"K2 frame bswap={bswap}", got_f, want_f))
            err["K2 advect_kernel"] = max(err["K2 advect_kernel"], e)

        cfg = SimConfig(shape=shape)
        vel = 40.0 * torch.randn((2, h, w), generator=gen, device=dev)
        # a duplicated cell (the last active slot wins), an inactive slot
        # past the list, and an out-of-range position (clamped)
        imp = Impulses.from_lists(
            cfg, [(20, 30), (20, 30), (h // 2, w // 3), (h + 50, -3)],
            [(90.0, -45.0), (33.0, 44.0), (-60.0, 120.0), (7.0, 8.0)],
            device=dev)
        got_v, got_p = project_fused(vel, 1.0, 10, 1.96, impulses=imp)
        want_v, want_p = project_fused_reference(vel, 1.0, 10, 1.96,
                                                 impulses=imp)
        err["K1 project_fused"] = max(
            err["K1 project_fused"],
            compare("K1 velocity (impulses)", got_v, want_v),
            compare("K1 pressure (impulses)", got_p, want_p))

        vel = 200.0 * torch.randn((2, h, w), generator=gen, device=dev)
        for field, label in ((vel, "f32 2ch no_slip"),
                             (dye[0].contiguous(), "bf16 1ch")):
            got = advect_kernel(field, vel, dt, True, max_disp=12,
                                return_minmax=True)
            want = advect_reference(field, vel, dt, True, max_disp=12,
                                    return_minmax=True)
            for g, w_, part in zip(got, want, ("out", "cmin", "cmax")):
                err["K2 advect_kernel"] = max(err["K2 advect_kernel"],
                                              compare(f"K2 return_minmax "
                                                      f"{label} {part}",
                                                      g, w_))

        color = torch.rand((3, h, w), generator=gen, device=dev)
        color[:, ::7, ::5] = 1.0
        color[:, 1::9, ::3] = 0.0
        for dtype in (torch.float32, torch.bfloat16):
            c = color.to(dtype)
            for bswap in (True, False):
                for unit_range in (False, True):
                    got = render_rgb565_kernel(c, 4, bswap, unit_range)
                    want = render_rgb565_reference(c, 4, bswap, unit_range)
                    err["K3 render_rgb565_kernel"] = max(
                        err["K3 render_rgb565_kernel"],
                        compare(f"K3 s=4 {str(dtype)[6:]} bswap={bswap} "
                                f"unit_range={unit_range}", got, want))

    for shape in (SMALL, (130, 200), PROD):
        d = torch.randn(shape, generator=gen, device=dev)
        for iters, dx in ((10, 1.0), (1, 0.7)):
            err["K4 sor_solve_kernel"] = max(
                err["K4 sor_solve_kernel"],
                compare(f"K4 {shape[0]}x{shape[1]} iters={iters} dx={dx}",
                        sor_solve_kernel(d, dx, iters, 1.96),
                        sor_solve_reference(d, dx, iters, 1.96)))
    for shape in (SMALL, MC_PROD):
        h, w = shape
        print(f"phase 1 K5 vs plain at {h}x{w}")
        # sigma 200 cells/s: the CFL clamp binds on ~7% of the cells
        vel = 200.0 * torch.randn((2, h, w), generator=gen, device=dev)
        dye = torch.rand((3, h, w), generator=gen,
                         device=dev).to(torch.bfloat16)
        for field, no_slip, label in ((vel, True, "f32 2ch no_slip"),
                                      (dye, False, "bf16 3ch")):
            err["K5 advect_maccormack_kernel"] = max(
                err["K5 advect_maccormack_kernel"],
                compare(f"K5 {label}",
                        advect_maccormack_kernel(field, vel, dt, no_slip, 12),
                        advect_maccormack_reference(field, vel, dt, no_slip,
                                                    12)))
    return err


def phase1b_kernels3d(dev):
    """Each 3D smoke kernel against its plain version, at a small odd shape
    and at the plume's 256^3."""
    from esp32_fluid_simulation_tpu_torch.ops.cuda.advect3d import (
        advect3d_kernel, advect3d_reference)
    from esp32_fluid_simulation_tpu_torch.ops.cuda.fd3d import (
        divergence3d, divergence3d_reference, subtract_gradient3d,
        subtract_gradient3d_reference)
    from esp32_fluid_simulation_tpu_torch.ops.cuda.sor3d import (
        sor3d_solve, sor3d_reference)
    from esp32_fluid_simulation_tpu_torch.render.cuda_smoke import (
        render_smoke_mip_kernel, render_smoke_mip_reference)

    gen = torch.Generator(device=dev).manual_seed(4321)
    err = {}

    def check(name, label, got, want):
        err[name] = max(err.get(name, 0.0), compare(label, got, want))

    dt = 1.0 / 30.0
    for shape in (SMALL3, SMOKE):
        print(f"phase 1b kernels vs plain at {shape}")
        # sigma 40 cells/s: |v|*dt > max_disp=2 on ~13% of the components
        vel = 40.0 * torch.randn((3,) + shape, generator=gen, device=dev)
        check("K7 advect3d_kernel", "K7 self-advect f32 no_slip",
              advect3d_kernel(vel, vel, dt, True, 2),
              advect3d_reference(vel, vel, dt, True, 2))
        pair = torch.rand((2,) + shape, generator=gen,
                          device=dev).to(torch.bfloat16)
        check("K7 advect3d_kernel", "K7 bf16 density+temperature",
              advect3d_kernel(pair, vel, dt, False, 2),
              advect3d_reference(pair, vel, dt, False, 2))
        p = torch.randn(shape, generator=gen, device=dev)
        check("K8 divergence3d", "K8 divergence", divergence3d(vel, 1.0),
              divergence3d_reference(vel, 1.0))
        check("K8 subtract_gradient3d", "K8 gradient subtract",
              subtract_gradient3d(vel, p, 1.0),
              subtract_gradient3d_reference(vel, p, 1.0))
        for iters in (10, 1):
            check("K9 sor3d_solve", f"K9 iters={iters} chunk=3",
                  sor3d_solve(p, 1.0, iters, 1.5, chunk=3),
                  sor3d_reference(p, 1.0, iters, 1.5))
        rho = 1.2 * torch.rand(shape, generator=gen, device=dev)
        for dtype in (torch.float32, torch.bfloat16):
            for bswap in (True, False):
                check("K10 render_smoke_mip_kernel",
                      f"K10 {str(dtype)[6:]} bswap={bswap}",
                      render_smoke_mip_kernel(rho.to(dtype), bswap),
                      render_smoke_mip_reference(rho.to(dtype), bswap))
    return err


def phase2_golden(dev):
    from esp32_fluid_simulation_tpu_torch import (SimConfig, Impulses,
                                                  init_state, make_step)
    with np.load(GOLDEN) as z:
        want_v = np.moveaxis(z["velocity"], -1, 0)
        want_c = np.clip(np.moveaxis(z["color"], -1, 0), 0, 1)
    for kw in ({}, dict(solver="fused_pallas", advect_impl="pallas")):
        cfg = SimConfig(**kw)
        st = init_state(cfg, device=dev)
        fn = make_step(cfg)
        for t in range(4):
            sched = [((10 + t, 20), (120.0, -60.0)),
                     ((30, 40 + t), (-90.0, 150.0)),
                     ((45, 60), (50.0, 50.0))]
            st = fn(st, Impulses.from_lists(cfg, [p for p, _ in sched],
                                            [v for _, v in sched],
                                            device=dev))
        v = st.velocity.cpu().numpy()
        c = st.color.cpu().numpy()
        np.testing.assert_allclose(v, want_v, rtol=1e-4, atol=2e-4)
        np.testing.assert_allclose(c, want_c, rtol=1e-4, atol=2e-4)
        print(f"phase 2 golden 61x81 4 steps {kw or 'composed'}: "
              f"max|dv|={np.abs(v - want_v).max():.3g} "
              f"max|dc|={np.abs(c - want_c).max():.3g} "
              "(rtol 1e-4, atol 2e-4) ok")


def reset_counts():
    from esp32_fluid_simulation_tpu_torch.ops.cuda.advect import (
        advect_kernel, maccormack_backward, maccormack_forward)
    from esp32_fluid_simulation_tpu_torch.ops.cuda.sor import sor_solve_kernel
    from esp32_fluid_simulation_tpu_torch.ops.cuda.project import (
        project_fused)
    from esp32_fluid_simulation_tpu_torch.render.cuda_upscale import (
        render_rgb565_kernel)
    from esp32_fluid_simulation_tpu_torch.ops.cuda.advect3d import (
        advect3d_kernel)
    from esp32_fluid_simulation_tpu_torch.ops.cuda.fd3d import (
        divergence3d, subtract_gradient3d)
    from esp32_fluid_simulation_tpu_torch.ops.cuda.sor3d import sor3d_solve
    from esp32_fluid_simulation_tpu_torch.render.cuda_smoke import (
        render_smoke_mip_kernel)
    fns = {"K1 project_fused": project_fused,
           "K2 advect_kernel": advect_kernel,
           "K3 render_rgb565_kernel": render_rgb565_kernel,
           "K4 sor_solve_kernel": sor_solve_kernel,
           # K5's two launches: the forward pass counts as the kernel's
           "K5 advect_maccormack_kernel": maccormack_forward,
           "K5 backward": maccormack_backward,
           "K7 advect3d_kernel": advect3d_kernel,
           "K8 divergence3d": divergence3d,
           "K8 subtract_gradient3d": subtract_gradient3d,
           "K9 sor3d_solve": sor3d_solve,
           "K10 render_smoke_mip_kernel": render_smoke_mip_kernel}
    for fn in fns.values():
        fn.launches = 0
    return lambda: {k: fn.launches for k, fn in fns.items()}


def phase3_4_main_path(dev, cfg):
    """Returns the launch counts of the main path's run (phases 3 and 4)."""
    from esp32_fluid_simulation_tpu_torch import (SimState, init_state,
                                                  make_step_render)
    from esp32_fluid_simulation_tpu_torch.io_host.touch import scripted_swirl
    from esp32_fluid_simulation_tpu_torch.render.cuda_upscale import (
        render_rgb565_reference)

    state0 = init_state(cfg, device=dev)
    torch.cuda.synchronize()
    step_render = make_step_render(cfg)
    counts = reset_counts()
    st = state0
    for t in range(MAIN_STEPS):
        st, frame = step_render(st, scripted_swirl(cfg, t, device=dev))
    torch.cuda.synchronize()
    n = counts()
    if n["K1 project_fused"] != MAIN_STEPS or \
            n["K2 advect_kernel"] != 2 * MAIN_STEPS:
        raise AssertionError(f"phase 3: launch counts {n} for {MAIN_STEPS} "
                             "steps (want K1 = steps, K2 = 2 * steps)")
    if not (torch.isfinite(st.velocity).all()
            and torch.isfinite(st.color.float()).all()):
        raise AssertionError("phase 3: non-finite state")
    lo, hi = float(st.color.min()), float(st.color.max())
    if lo < 0.0 or hi > 1.0:
        raise AssertionError(f"phase 3: dye outside [0, 1]: [{lo}, {hi}]")
    if frame.dtype != torch.uint16 or tuple(frame.shape) != (4095, 4095):
        raise AssertionError(f"phase 3: frame {frame.dtype} "
                             f"{tuple(frame.shape)}")
    max_speed = float(st.velocity.norm(dim=0).max())
    print(f"phase 3 main path {cfg.shape[0]}x{cfg.shape[1]} "
          f"{MAIN_STEPS} steps: launches {n}; finite, dye in [{lo}, {hi}], "
          f"max |v| {max_speed:.4g}, frame uint16 {tuple(frame.shape)}")

    ps = SimState(state0.velocity.clone(), state0.color.clone(), 0)
    for t in range(MAIN_STEPS):
        ps, pframe = plain_step_render(ps, scripted_swirl(cfg, t, device=dev),
                                       cfg)
    dv = float((ps.velocity - st.velocity).abs().max())
    dc = float((ps.color.float() - st.color.float()).abs().max())
    frame_eq = float((pframe.view(torch.int16) == frame.view(torch.int16))
                     .float().mean())
    same = (torch.equal(ps.velocity, st.velocity)
            and torch.equal(ps.color, st.color) and frame_eq == 1.0)
    print(f"phase 3 plain path on the card: max|dv|={dv:.3g} "
          f"max|dc|={dc:.3g} frame equal={100 * frame_eq:.4f}% "
          f"bit-identical={same}")
    # stated tolerance: each kernel is bit-equal to its plain version, so
    # the trajectories must agree to the bit up to float32 noise
    torch.testing.assert_close(st.velocity, ps.velocity, rtol=1e-5,
                               atol=1e-5)
    torch.testing.assert_close(st.color.float(), ps.color.float(), rtol=0,
                               atol=2.0 ** -8)
    if frame_eq < 0.9999:
        raise AssertionError(f"phase 3: frames agree on {frame_eq:.6f}")

    cfg4 = dataclasses.replace(cfg, scaling=4)
    step_render4 = make_step_render(cfg4)
    for t in range(RENDER_STEPS):
        st, frame4 = step_render4(st, scripted_swirl(cfg4, MAIN_STEPS + t,
                                                     device=dev))
    torch.cuda.synchronize()
    n = counts()
    if n["K3 render_rgb565_kernel"] != RENDER_STEPS:
        raise AssertionError(f"phase 4: K3 launched "
                             f"{n['K3 render_rgb565_kernel']} times")
    want = render_rgb565_reference(st.color, 4, True, True)
    compare("phase 4 K3 frame at s=4 vs plain", frame4, want)
    print(f"phase 4 scaling=4: {RENDER_STEPS} step_render calls, frame "
          f"{tuple(frame4.shape)}, launches {n}")
    return {k: n[k] for k in list(KERNELS)[:3]}, state0


def plain_step(state, imp, cfg):
    """A 2D step of a kernel-advect config (K2 or K5; K1, K4 or an eager
    solver; optional confinement) through the kernels' plain versions (the
    same arithmetic in PyTorch ops), on any device."""
    from esp32_fluid_simulation_tpu_torch import SimState
    from esp32_fluid_simulation_tpu_torch.models.stable_fluids import (
        apply_impulses)
    from esp32_fluid_simulation_tpu_torch.ops.cuda.advect import (
        advect_maccormack_reference, advect_reference)
    from esp32_fluid_simulation_tpu_torch.ops.cuda.project import (
        project_fused_reference)
    from esp32_fluid_simulation_tpu_torch.ops.cuda.sor import (
        sor_solve_reference)
    from esp32_fluid_simulation_tpu_torch.ops.fd import (
        divergence, subtract_gradient, vorticity_confinement)
    from esp32_fluid_simulation_tpu_torch.ops.poisson import poisson_solve
    md, dt = cfg.advect_max_disp, cfg.dt
    if cfg.advector == "maccormack":
        def adv(f, v, no_slip, clip01=False):
            return advect_maccormack_reference(f, v, dt, no_slip, md)
    else:
        def adv(f, v, no_slip, clip01=False):
            return advect_reference(f, v, dt, no_slip, md, clip01=clip01)
    vel = apply_impulses(adv(state.velocity, state.velocity, True), imp)
    if cfg.vorticity_eps > 0.0:
        vel = vorticity_confinement(vel, cfg.vorticity_eps, dt, cfg.dx)
    if cfg.solver == "fused_pallas":
        vel, _ = project_fused_reference(vel, cfg.dx, cfg.sor_iters,
                                         cfg.omega)
    else:
        div = divergence(vel, cfg.dx)
        p = (sor_solve_reference(div, cfg.dx, cfg.sor_iters, cfg.omega)
             if cfg.solver == "sor_pallas" else poisson_solve(div, cfg))
        vel = subtract_gradient(vel, p, cfg.dx)
    color = adv(state.color, vel, False, clip01=cfg.clamps_dye)
    return SimState(velocity=vel, color=color, step=state.step + 1)


def plain_step_render(state, imp, cfg):
    """``plain_step`` and its frame through plain PyTorch ops (at s=1 the
    frame the K2 dye store packs, at s > 1 K3's)."""
    from esp32_fluid_simulation_tpu_torch.render.cuda_upscale import (
        render_rgb565_reference)
    st = plain_step(state, imp, cfg)
    return st, render_rgb565_reference(st.color, cfg.scaling)


def check_against_plain(phase, dev, cfg, state0, fn, steps, want_counts,
                        render):
    """Drive ``fn`` (the entry point) for ``steps`` steps of
    ``scripted_swirl`` with the counters reset just before; check the
    counts, the state, and bit-identity with the plain path on the card.
    Returns the counts and the last state."""
    from esp32_fluid_simulation_tpu_torch import SimState
    from esp32_fluid_simulation_tpu_torch.io_host.touch import scripted_swirl
    imps = [scripted_swirl(cfg, t, device=dev) for t in range(steps)]
    torch.cuda.synchronize()
    counts = reset_counts()
    st, frame = state0, None
    for imp in imps:
        if render:
            st, frame = fn(st, imp)
        else:
            st = fn(st, imp)
    torch.cuda.synchronize()
    n = counts()
    bad = {k: (n[k], v) for k, v in want_counts.items() if n[k] != v}
    if bad:
        raise AssertionError(f"phase {phase}: launch counts (got, want) "
                             f"{bad}; all {n}")
    if not (torch.isfinite(st.velocity).all()
            and torch.isfinite(st.color.float()).all()):
        raise AssertionError(f"phase {phase}: non-finite state")
    lo, hi = float(st.color.min()), float(st.color.max())
    if lo < -0.5 or hi > 1.5 or (cfg.clamps_dye and (lo < 0 or hi > 1)):
        raise AssertionError(f"phase {phase}: dye in [{lo}, {hi}]")
    ps = SimState(state0.velocity.clone(), state0.color.clone(), 0)
    for imp in imps:
        ps, pframe = plain_step_render(ps, imp, cfg)
    same = (torch.equal(ps.velocity, st.velocity)
            and torch.equal(ps.color, st.color))
    dv = float((ps.velocity - st.velocity).abs().max())
    dc = float((ps.color.float() - st.color.float()).abs().max())
    msg = (f"phase {phase} {cfg.shape[0]}x{cfg.shape[1]} {steps} steps: "
           f"launches {n}; dye in [{lo:.4g}, {hi:.4g}], max |v| "
           f"{float(st.velocity.norm(dim=0).max()):.4g}; plain path on the "
           f"card: max|dv|={dv:.3g} max|dc|={dc:.3g}")
    if render:
        same = same and torch.equal(pframe.view(torch.int16),
                                    frame.view(torch.int16))
        msg += f", frame {tuple(frame.shape)}"
    print(f"{msg} bit-identical={same}")
    # stated tolerance: each kernel is bit-equal to its plain version and
    # the eager ops are shared, so the two paths must agree to the bit
    if not same:
        raise AssertionError(f"phase {phase}: the kernel path differs from "
                             "the plain path")
    return n, st


def phase8_config3(dev):
    from esp32_fluid_simulation_tpu_torch import (SimConfig, init_state,
                                                  make_step_render)
    cfg = SimConfig.from_json(CONFIG3.read_text())
    s2 = 2 * CONFIG3_STEPS
    n, st = check_against_plain(
        8, dev, cfg, init_state(cfg, device=dev), make_step_render(cfg),
        CONFIG3_STEPS, {"K5 advect_maccormack_kernel": s2, "K5 backward": s2,
                        "K2 advect_kernel": 0, "K1 project_fused": 0}, True)
    return n["K5 advect_maccormack_kernel"], cfg, st


def phase9_sor_pallas(dev):
    from esp32_fluid_simulation_tpu_torch import (SimConfig, init_state,
                                                  make_step)
    cfg = dataclasses.replace(SimConfig.from_json(CONFIG0.read_text()),
                              solver="sor_pallas")
    n, st = check_against_plain(
        9, dev, cfg, init_state(cfg, device=dev), make_step(cfg), SOR_STEPS,
        {"K4 sor_solve_kernel": SOR_STEPS, "K2 advect_kernel": 2 * SOR_STEPS,
         "K1 project_fused": 0}, False)
    return n["K4 sor_solve_kernel"], cfg, st


def phase10_config2(dev):
    from esp32_fluid_simulation_tpu_torch import (SimConfig, init_state,
                                                  make_step_render)
    cfg = SimConfig.from_json(CONFIG2.read_text())
    _, st = check_against_plain(
        10, dev, cfg, init_state(cfg, device=dev), make_step_render(cfg),
        CONFIG2_STEPS, {"K2 advect_kernel": 2 * CONFIG2_STEPS,
                        "K3 render_rgb565_kernel": CONFIG2_STEPS,
                        "K1 project_fused": 0}, True)
    return cfg, st


def phase11_path_goldens(dev):
    from esp32_fluid_simulation_tpu_torch import (SimConfig, Impulses,
                                                  init_state, make_step)
    runs = [(name, kw, {}) for name, kw in PATH_GOLDENS.items()]
    runs.append(("maccormack", PATH_GOLDENS["maccormack"],
                 dict(advect_impl="pallas")))
    for name, kw, extra in runs:
        cfg = SimConfig(**kw, **extra)
        st = init_state(cfg, device=dev)
        fn = make_step(cfg)
        max_step = 0.0
        for t in range(5):
            max_step = max(max_step, float(st.velocity.abs().max()) * cfg.dt)
            st = fn(st, Impulses.from_lists(
                cfg, [(10 + t, 12), (30, 40 + t), (20, 55)],
                [(130.0, -70.0), (-80.0, 140.0), (60.0, 60.0)], device=dev))
        if extra and not max_step < cfg.advect_max_disp:
            raise AssertionError(f"phase 11: backtrace {max_step} cells "
                                 f"beyond max_disp {cfg.advect_max_disp}")
        atol = GOLDEN_ATOL.get(name, 1e-4)
        with np.load(ROOT / "tests" / "golden" / f"path_{name}.npz") as z:
            v = st.velocity.cpu().numpy()
            c = st.color.float().cpu().numpy()
            np.testing.assert_allclose(v, z["velocity"], rtol=1e-4,
                                       atol=atol)
            np.testing.assert_allclose(c, z["color"], rtol=1e-4, atol=1e-4)
            print(f"phase 11 golden path_{name} {extra or 'composed'}: "
                  f"max|dv|={np.abs(v - z['velocity']).max():.3g} "
                  f"max|dc|={np.abs(c - z['color']).max():.3g} (rtol 1e-4, "
                  f"atol {atol:g}; max backtrace {max_step:.3g} cells) ok")


def phase12_metrics(dev, cfg0, state0):
    from esp32_fluid_simulation_tpu_torch import (SmokeConfig, SmokeState,
                                                  init_smoke, make_smoke_step,
                                                  make_step_render,
                                                  make_step_with_metrics)
    from esp32_fluid_simulation_tpu_torch.io_host.touch import scripted_swirl
    from esp32_fluid_simulation_tpu_torch.models.smoke3d import (
        source_tensor)
    metrics_fn = make_step_with_metrics(cfg0)
    render_fn = make_step_render(cfg0)
    a = b = state0
    for t in range(METRIC_STEPS):
        imp = scripted_swirl(cfg0, t, device=dev)
        a, m = metrics_fn(a, imp)
        b, _ = render_fn(b, imp)
        if not float(m["div_post_max"]) < float(m["div_pre_max"]):
            raise AssertionError(f"phase 12: divergence not reduced: {m}")
        if not bool(m["finite"]):
            raise AssertionError(f"phase 12: non-finite state: {m}")
    torch.cuda.synchronize()
    same = (torch.equal(a.velocity, b.velocity)
            and torch.equal(a.color, b.color))
    print(f"phase 12 step_with_metrics at {cfg0.shape[0]}x{cfg0.shape[1]}, "
          "last step: "
          + ", ".join(f"{k} {float(v):.4g}" for k, v in m.items())
          + f"; state equal to step_render's: {same}")
    if not same:
        raise AssertionError("phase 12: the metrics step's state differs "
                             "from step_render's")

    # K7 advects (forced, as "auto" picks it at 64^3 on the card); the
    # divergence, solve and gradient are eager below 128^3
    scfg = SmokeConfig(shape=(64, 64, 64), vorticity_eps=2.0,
                       advect_impl="pallas")
    st = init_smoke(scfg, device=dev)
    ps = SmokeState(st.velocity.clone(), st.density.clone(),
                    st.temperature.clone(), 0)
    step = make_smoke_step(scfg)
    src = source_tensor(scfg, dev)
    for _ in range(METRIC_STEPS):
        st = step(st)
        ps = plain_smoke_step(ps, scfg, src)
    same = all(torch.equal(getattr(st, k), getattr(ps, k))
               for k in ("velocity", "density", "temperature"))
    dv = float((st.velocity - ps.velocity).abs().max())
    print(f"phase 12 smoke 64^3 vorticity_eps=2.0 {METRIC_STEPS} steps vs "
          f"plain path: max|dv|={dv:.3g} bit-identical={same}")
    if not same:
        raise AssertionError("phase 12: the smoke step with confinement "
                             "differs from the plain path")


def phase5_timing(dev, cfg, state0, card):
    from esp32_fluid_simulation_tpu_torch import make_step_render
    from esp32_fluid_simulation_tpu_torch.io_host.touch import scripted_swirl
    from esp32_fluid_simulation_tpu_torch.ops.cuda.advect import (
        advect_kernel, advect_reference)
    from esp32_fluid_simulation_tpu_torch.ops.cuda.project import (
        project_fused, project_fused_reference)
    from esp32_fluid_simulation_tpu_torch.render.cuda_upscale import (
        render_rgb565_kernel, render_rgb565_reference)

    imps = [scripted_swirl(cfg, t, device=dev) for t in range(8)]
    box = {"st": state0, "t": 0}

    def stepper(fn):
        def one():
            box["st"], _ = fn(box["st"], imps[box["t"] % 8])
            box["t"] += 1
        return one

    res = {}
    res["step_render s=1 kernel"] = cuda_ms(
        stepper(make_step_render(cfg)), 20, warmup=3)
    box["st"] = state0
    res["step_render s=1 plain"] = cuda_ms(
        stepper(lambda s, i: plain_step_render(s, i, cfg)), 5, warmup=1)
    cfg4 = dataclasses.replace(cfg, scaling=4)
    box["st"] = state0
    res["step_render s=4 kernel"] = cuda_ms(
        stepper(make_step_render(cfg4)), 10, warmup=2)

    vel = box["st"].velocity
    color = box["st"].color
    imp = imps[0]
    md, dt = cfg.advect_max_disp, cfg.dt
    per_kernel = {
        "K2 advect_kernel": (
            lambda: advect_kernel(vel, vel, dt, True, md, self_advect=True),
            lambda: advect_reference(vel, vel, dt, True, md)),
        "K2 advect_kernel dye": (
            lambda: advect_kernel(color, vel, dt, False, md, clip01=True,
                                  rgb565=True),
            lambda: advect_reference(color, vel, dt, False, md, clip01=True,
                                     rgb565=True)),
        "K1 project_fused": (
            lambda: project_fused(vel, cfg.dx, cfg.sor_iters, cfg.omega, imp),
            lambda: project_fused_reference(vel, cfg.dx, cfg.sor_iters,
                                            cfg.omega, imp)),
        "K3 render_rgb565_kernel": (
            lambda: render_rgb565_kernel(color, 4, True, True),
            lambda: render_rgb565_reference(color, 4, True, True)),
    }
    for name, (kern, plain) in per_kernel.items():
        # kernel, plain, plain, kernel: the two sides see the same card state
        k1 = cuda_ms(kern, 20, warmup=2)
        p1 = cuda_ms(plain, 3, warmup=1)
        p2 = cuda_ms(plain, 3, warmup=0)
        k2 = cuda_ms(kern, 20, warmup=0)
        res[name] = (k1 + k2) / 2
        res[name + " plain"] = (p1 + p2) / 2
    print(f"phase 5 timing at {cfg.shape[0]}x{cfg.shape[1]} on {card} "
          "(CUDA events, ms per call):")
    for k, v in res.items():
        print(f"  {k}: {v:.4f} ms")

    # per kernel over the calls of one step: (ms, plain ms, bytes, flops);
    # flops counted from each kernel's formula (see its source)
    h, w = cfg.shape
    n = h * w
    frame = (h - 1) * (w - 1)
    up = 16 * frame                               # s=4 output pixels
    return {
        "K1 project_fused": (
            res["K1 project_fused"], res["K1 project_fused plain"],
            2 * nbytes(vel) + 4 * n + nbytes(*imp),
            n * (13 + 8 * cfg.sor_iters)),
        "K2 advect_kernel": (
            res["K2 advect_kernel"] + res["K2 advect_kernel dye"],
            res["K2 advect_kernel plain"] + res["K2 advect_kernel dye plain"],
            3 * nbytes(vel) + 2 * nbytes(color) + 2 * frame, n * (49 + 60)),
        "K3 render_rgb565_kernel": (
            res["K3 render_rgb565_kernel"],
            res["K3 render_rgb565_kernel plain"],
            nbytes(color) + 2 * up, 24 * up),
    }


def time_pair(kern, plain, n_kern=20, n_plain=3):
    """(kernel ms, plain ms) per call: kernel, plain, plain, kernel, so the
    two sides see the same card state."""
    k1 = cuda_ms(kern, n_kern, warmup=2)
    p1 = cuda_ms(plain, n_plain, warmup=1)
    p2 = cuda_ms(plain, n_plain, warmup=0)
    k2 = cuda_ms(kern, n_kern, warmup=0)
    return (k1 + k2) / 2, (p1 + p2) / 2


def phase5_k4_k5_timing(dev, card, paths):
    """Times of the config 3, sor_pallas and config 2 steps (kernel and
    plain paths) and of K4 and K5; returns K4's and K5's work."""
    from esp32_fluid_simulation_tpu_torch import make_step, make_step_render
    from esp32_fluid_simulation_tpu_torch.io_host.touch import scripted_swirl
    from esp32_fluid_simulation_tpu_torch.ops.cuda.advect import (
        advect_maccormack_kernel, advect_maccormack_reference,
        maccormack_backward, maccormack_forward)
    from esp32_fluid_simulation_tpu_torch.ops.cuda.sor import (
        sor_solve_kernel, sor_solve_reference)
    from esp32_fluid_simulation_tpu_torch.ops.fd import (
        divergence, vorticity_confinement)
    from esp32_fluid_simulation_tpu_torch.ops.poisson import poisson_solve

    res = {}
    for label, (cfg, state, render) in paths.items():
        imps = [scripted_swirl(cfg, t, device=dev) for t in range(8)]
        box = {"st": state, "t": 0}

        def stepper(fn, render=render, box=box, imps=imps):
            def one():
                out = fn(box["st"], imps[box["t"] % 8])
                box["st"] = out[0] if render else out
                box["t"] += 1
            return one

        kern = (make_step_render if render else make_step)(cfg)

        def plain(s, i, cfg=cfg, render=render):
            return plain_step_render(s, i, cfg) if render else plain_step(
                s, i, cfg)

        res[f"{label} kernel"] = cuda_ms(stepper(kern), 10, warmup=2)
        box["st"] = state
        res[f"{label} plain"] = cuda_ms(stepper(plain), 3, warmup=1)

    # what the eager solvers take of the config 3 and config 2 steps
    cfg3, st3, _ = paths["config3 step_render"]
    cfg2, st2, _ = paths["config2 step_render"]
    d3 = divergence(st3.velocity, cfg3.dx)
    d2 = divergence(st2.velocity, cfg2.dx)
    res["config3 multigrid solve"] = cuda_ms(
        lambda: poisson_solve(d3, cfg3), 5, warmup=1)
    res["config2 SOR solve"] = cuda_ms(lambda: poisson_solve(d2, cfg2), 10,
                                       warmup=2)
    res["config2 vorticity_confinement"] = cuda_ms(
        lambda: vorticity_confinement(st2.velocity, cfg2.vorticity_eps,
                                      cfg2.dt, cfg2.dx), 10, warmup=2)

    cfg0, st0, _ = paths["sor_pallas step"]
    d = divergence(st0.velocity, cfg0.dx)
    it, om = cfg0.sor_iters, cfg0.omega
    res["K4"], res["K4 plain"] = time_pair(
        lambda: sor_solve_kernel(d, cfg0.dx, it, om),
        lambda: sor_solve_reference(d, cfg0.dx, it, om))

    vel, dye = st3.velocity, st3.color
    md, dt = cfg3.advect_max_disp, cfg3.dt
    for name, field, no_slip in (("K5 velocity", vel, True),
                                 ("K5 dye", dye, False)):
        res[name], res[name + " plain"] = time_pair(
            lambda: advect_maccormack_kernel(field, vel, dt, no_slip, md),
            lambda: advect_maccormack_reference(field, vel, dt, no_slip, md))
        fwd = maccormack_forward(field, vel, dt, no_slip, md)
        res[name + " forward"] = cuda_ms(
            lambda: maccormack_forward(field, vel, dt, no_slip, md), 20,
            warmup=2)
        res[name + " backward"] = cuda_ms(
            lambda: maccormack_backward(field, *fwd, vel, dt, no_slip, md),
            20, warmup=2)
    print(f"phase 5 timing of K4, K5 and their paths on {card} (CUDA "
          "events, ms per call):")
    for k, v in res.items():
        print(f"  {k}: {v:.4f} ms")

    n3 = vel[0].numel()
    n0 = d.numel()
    return {
        "K4 sor_solve_kernel": (res["K4"], res["K4 plain"],
                                2 * nbytes(d), n0 * (1 + 8 * it)),
        # the velocity's field is vel itself: read once
        "K5 advect_maccormack_kernel": (
            res["K5 velocity"] + res["K5 dye"],
            res["K5 velocity plain"] + res["K5 dye plain"],
            2 * nbytes(vel) + nbytes(vel) + 2 * nbytes(dye),
            n3 * ((40 + 2 * 25) + (40 + 3 * 25))),
    }


def phase6_smoke_golden(dev):
    from esp32_fluid_simulation_tpu_torch import (SmokeConfig, init_smoke,
                                                  make_smoke_step)
    cfg = SmokeConfig(shape=(24, 24, 24), solver="multigrid", sor_iters=4)
    st = init_smoke(cfg, device=dev)
    fn = make_smoke_step(cfg)
    for _ in range(5):
        st = fn(st)
    diffs = []
    with np.load(SMOKE_GOLDEN) as z:
        for name in ("velocity", "density", "temperature"):
            got = getattr(st, name).float().cpu().numpy()
            np.testing.assert_allclose(got, z[name], rtol=1e-4, atol=1e-4)
            diffs.append(f"max|d{name[0]}|={np.abs(got - z[name]).max():.3g}")
    print(f"phase 6 smoke golden 24^3 multigrid 5 steps: {' '.join(diffs)} "
          "(rtol 1e-4, atol 1e-4) ok")


def plain_smoke_step(state, cfg, src):
    """The plume step through the kernels' plain versions (the same
    arithmetic in PyTorch ops), on any device."""
    from esp32_fluid_simulation_tpu_torch import SmokeState
    from esp32_fluid_simulation_tpu_torch.models.smoke3d import (
        inject_and_buoy)
    from esp32_fluid_simulation_tpu_torch.ops.cuda.advect3d import (
        advect3d_reference)
    from esp32_fluid_simulation_tpu_torch.ops.cuda.fd3d import (
        divergence3d_reference, subtract_gradient3d_reference)
    from esp32_fluid_simulation_tpu_torch.ops.cuda.sor3d import (
        sor3d_reference)
    from esp32_fluid_simulation_tpu_torch.ops.fd import vorticity_confinement
    md, dt = cfg.advect_max_disp, cfg.dt
    vel = advect3d_reference(state.velocity, state.velocity, dt, True, md)
    scal = advect3d_reference(torch.stack([state.density,
                                           state.temperature]), vel, dt,
                              False, md)
    vel, rho, temp = inject_and_buoy(vel, scal[0], scal[1], src, cfg)
    if cfg.vorticity_eps > 0:
        vel = vorticity_confinement(vel, cfg.vorticity_eps, dt, cfg.dx)
    p = sor3d_reference(divergence3d_reference(vel, cfg.dx), cfg.dx,
                        cfg.sor_iters, cfg.omega)
    vel = subtract_gradient3d_reference(vel, p, cfg.dx)
    return SmokeState(velocity=vel, density=rho, temperature=temp,
                      step=state.step + 1)


def phase7_smoke_main_path(dev, cfg):
    """Returns the launch counts of the plume's run and its last state."""
    from esp32_fluid_simulation_tpu_torch import (SmokeState, init_smoke,
                                                  make_smoke_step,
                                                  render_smoke)
    from esp32_fluid_simulation_tpu_torch.models.smoke3d import (
        source_tensor)
    from esp32_fluid_simulation_tpu_torch.render.cuda_smoke import (
        render_smoke_mip_reference)

    state0 = init_smoke(cfg, device=dev)
    step = make_smoke_step(cfg)
    torch.cuda.synchronize()
    counts = reset_counts()
    st = state0
    for _ in range(SMOKE_STEPS):
        st = step(st)
        frame = render_smoke(st.density)
    torch.cuda.synchronize()
    n = counts()
    want = {"K7 advect3d_kernel": 2 * SMOKE_STEPS,
            "K8 divergence3d": SMOKE_STEPS,
            "K8 subtract_gradient3d": SMOKE_STEPS,
            "K9 sor3d_solve": SMOKE_STEPS,
            "K10 render_smoke_mip_kernel": SMOKE_STEPS}
    if any(n[k] != v for k, v in want.items()):
        raise AssertionError(f"phase 7: launch counts {n} for {SMOKE_STEPS} "
                             f"steps (want {want})")
    for name in ("velocity", "density", "temperature"):
        if not torch.isfinite(getattr(st, name).float()).all():
            raise AssertionError(f"phase 7: non-finite {name}")
    rho = st.density.float()
    lo, hi = float(rho.min()), float(rho.max())
    if lo < 0.0 or hi > 1.0 or hi < 0.05:
        raise AssertionError(f"phase 7: density in [{lo}, {hi}]")
    d = cfg.shape[0]
    src_top = int(cfg.source_center[0] * d
                  - cfg.source_radius * min(cfg.shape)) - 2
    above = float(rho[:src_top].sum())
    w_up = float((st.velocity[0] * rho).sum())
    if not above > 0.0 or not w_up < 0.0:
        raise AssertionError(f"phase 7: no rising plume (smoke above the "
                             f"source {above}, sum v0*rho {w_up})")
    if frame.dtype != torch.uint16 or tuple(frame.shape) != cfg.shape[1:]:
        raise AssertionError(f"phase 7: frame {frame.dtype} "
                             f"{tuple(frame.shape)}")
    print(f"phase 7 smoke main path {cfg.shape} {SMOKE_STEPS} steps + "
          f"renders: launches {want}; finite, density in [{lo}, {hi}], "
          f"smoke above the source {above:.4g}, sum v0*rho {w_up:.4g} (< 0: "
          f"rising), frame uint16 {tuple(frame.shape)}")

    src = source_tensor(cfg, dev)
    ps = SmokeState(state0.velocity.clone(), state0.density.clone(),
                    state0.temperature.clone(), 0)
    for _ in range(SMOKE_STEPS):
        ps = plain_smoke_step(ps, cfg, src)
    pframe = render_smoke_mip_reference(ps.density)
    dv = float((ps.velocity - st.velocity).abs().max())
    dr = float((ps.density.float() - rho).abs().max())
    frame_eq = float((pframe.view(torch.int16) == frame.view(torch.int16))
                     .float().mean())
    same = (torch.equal(ps.velocity, st.velocity)
            and torch.equal(ps.density, st.density)
            and torch.equal(ps.temperature, st.temperature))
    print(f"phase 7 plain path on the card: max|dv|={dv:.3g} "
          f"max|drho|={dr:.3g} frame equal={100 * frame_eq:.4f}% "
          f"bit-identical={same}")
    # stated tolerance: each kernel is bit-equal to its plain version, so
    # the trajectories must agree to the bit up to float32 noise
    torch.testing.assert_close(st.velocity, ps.velocity, rtol=1e-5,
                               atol=1e-5)
    for a, b in ((st.density, ps.density),
                 (st.temperature, ps.temperature)):
        torch.testing.assert_close(a.float(), b.float(), rtol=0,
                                   atol=2.0 ** -8)
    if frame_eq < 0.9999:
        raise AssertionError(f"phase 7: frames agree on {frame_eq:.6f}")
    return {k: n[k] for k in want}, st


def phase5_smoke_timing(dev, cfg, state, card):
    from esp32_fluid_simulation_tpu_torch import make_smoke_step, render_smoke
    from esp32_fluid_simulation_tpu_torch.models.smoke3d import (
        source_tensor)
    from esp32_fluid_simulation_tpu_torch.ops.cuda.advect3d import (
        advect3d_kernel, advect3d_reference)
    from esp32_fluid_simulation_tpu_torch.ops.cuda.fd3d import (
        divergence3d, divergence3d_reference, subtract_gradient3d,
        subtract_gradient3d_reference)
    from esp32_fluid_simulation_tpu_torch.ops.cuda.sor3d import (
        sor3d_solve, sor3d_reference)
    from esp32_fluid_simulation_tpu_torch.render.cuda_smoke import (
        render_smoke_mip_kernel, render_smoke_mip_reference)

    src = source_tensor(cfg, dev)
    box = {"st": state}

    def stepper(fn):
        def one():
            box["st"] = fn(box["st"])
        return one

    res = {}
    res["smoke step kernel"] = cuda_ms(stepper(make_smoke_step(cfg)), 20,
                                       warmup=3)
    box["st"] = state
    res["smoke step plain"] = cuda_ms(
        stepper(lambda s: plain_smoke_step(s, cfg, src)), 3, warmup=1)

    vel, rho = state.velocity, state.density
    pair = torch.stack([state.density, state.temperature])
    md, dt, dx = cfg.advect_max_disp, cfg.dt, cfg.dx
    div = divergence3d(vel, dx)
    p = sor3d_solve(div, dx, cfg.sor_iters, cfg.omega)
    it, om = cfg.sor_iters, cfg.omega
    per_kernel = {
        "K7 velocity": (lambda: advect3d_kernel(vel, vel, dt, True, md),
                        lambda: advect3d_reference(vel, vel, dt, True, md)),
        "K7 scalars": (lambda: advect3d_kernel(pair, vel, dt, False, md),
                       lambda: advect3d_reference(pair, vel, dt, False, md)),
        "K8 divergence3d": (lambda: divergence3d(vel, dx),
                            lambda: divergence3d_reference(vel, dx)),
        "K8 subtract_gradient3d": (
            lambda: subtract_gradient3d(vel, p, dx),
            lambda: subtract_gradient3d_reference(vel, p, dx)),
        "K9 sor3d_solve": (lambda: sor3d_solve(div, dx, it, om),
                           lambda: sor3d_reference(div, dx, it, om)),
        "K10 render_smoke_mip_kernel": (
            lambda: render_smoke_mip_kernel(rho),
            lambda: render_smoke_mip_reference(rho)),
    }
    for name, (kern, plain) in per_kernel.items():
        # kernel, plain, plain, kernel: the two sides see the same card state
        k1 = cuda_ms(kern, 20, warmup=2)
        p1 = cuda_ms(plain, 3, warmup=1)
        p2 = cuda_ms(plain, 3, warmup=0)
        k2 = cuda_ms(kern, 20, warmup=0)
        res[name] = (k1 + k2) / 2
        res[name + " plain"] = (p1 + p2) / 2
    res["render_smoke mip"] = cuda_ms(lambda: render_smoke(rho), 20,
                                      warmup=2)
    print(f"phase 5 timing at {cfg.shape} on {card} (CUDA events, ms per "
          "call):")
    for k, v in res.items():
        print(f"  {k}: {v:.4f} ms")

    n = vel[0].numel()
    d, h, w = cfg.shape
    return {
        "K7 advect3d_kernel": (
            res["K7 velocity"] + res["K7 scalars"],
            res["K7 velocity plain"] + res["K7 scalars plain"],
            3 * nbytes(vel) + 2 * nbytes(pair), n * ((34 + 3 * 19 + 17)
                                                     + (34 + 2 * 19))),
        "K8 divergence3d": (res["K8 divergence3d"],
                            res["K8 divergence3d plain"],
                            nbytes(vel, div), 9 * n),
        "K8 subtract_gradient3d": (res["K8 subtract_gradient3d"],
                                   res["K8 subtract_gradient3d plain"],
                                   2 * nbytes(vel) + nbytes(p), 9 * n),
        "K9 sor3d_solve": (res["K9 sor3d_solve"], res["K9 sor3d_solve plain"],
                           nbytes(div, p), 11 * n * it),
        "K10 render_smoke_mip_kernel": (
            res["K10 render_smoke_mip_kernel"],
            res["K10 render_smoke_mip_kernel plain"],
            nbytes(rho) + 2 * h * w, n + 12 * h * w),
    }


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available()"
                         " is false); this check runs only on a GPU")
    from esp32_fluid_simulation_tpu_torch import SimConfig, SmokeConfig
    from esp32_fluid_simulation_tpu_torch.ops.cuda import build

    dev = torch.device("cuda", 0)
    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    lib = build.load()
    print(f"kernels built in {time.perf_counter() - t0:.2f} s "
          f"(nvcc {lib.build_seconds:.2f} s) -> {lib.path.name}")
    for line in lib.log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")

    err = phase1_kernels(dev)
    err.update(phase1b_kernels3d(dev))
    phase2_golden(dev)
    cfg = SimConfig.from_json(CONFIG0.read_text())
    counts, state0 = phase3_4_main_path(dev, cfg)
    phase6_smoke_golden(dev)
    scfg = SmokeConfig(shape=SMOKE)
    counts3, smoke = phase7_smoke_main_path(dev, scfg)
    counts.update(counts3)
    counts["K5 advect_maccormack_kernel"], cfg3, st3 = phase8_config3(dev)
    counts["K4 sor_solve_kernel"], cfg_sor, st_sor = phase9_sor_pallas(dev)
    cfg2, st2 = phase10_config2(dev)
    phase11_path_goldens(dev)
    phase12_metrics(dev, cfg, state0)
    work = phase5_timing(dev, cfg, state0, card)
    work.update(phase5_smoke_timing(dev, scfg, smoke, card))
    work.update(phase5_k4_k5_timing(dev, card, {
        "config3 step_render": (cfg3, st3, True),
        "sor_pallas step": (cfg_sor, st_sor, False),
        "config2 step_render": (cfg2, st2, True)}))

    for name, n in counts.items():
        if n == 0:
            raise AssertionError(f"{name} never launched on its main path")
    summary = {"kernels": []}
    for name, (src, rep) in KERNELS.items():
        ms, plain_ms, moved, flops = work[name]
        bound_ms, bound_by = bound(moved, flops)
        summary["kernels"].append({
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": counts[name], "max_abs_err": err[name], "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None})
    print(card)
    print(json.dumps(summary))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
