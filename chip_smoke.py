#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port (``esp32_fluid_simulation_tpu_torch``) on
one NVIDIA GPU and check it.

    python3 chip_smoke.py

Needs one CUDA device, ``nvcc`` and the repository checkout around this
file; it exits non-zero on any failure and imports nothing of JAX.

1. Builds the kernels from ``esp32_fluid_simulation_tpu_torch/csrc/*.cu``
   and holds each (K1 projection, K2 advection, K3 RGB565 upscale) against
   its plain PyTorch version on the card, at a small odd shape and at the
   production shapes; bit-equality is expected (``--fmad=false``).
2. The reference workload ``SimConfig()`` against the golden trajectory
   ``tests/golden/ref_61x81_4steps.npz`` (rtol 1e-4, atol 2e-4), on the
   composed path and on the kernel path.
3. The main path: ``examples/config0_4096_production.json`` through
   ``make_step_render`` for 30 steps of ``scripted_swirl``, with the launch
   counters proving K1 ran once and K2 twice per step, checked against the
   same steps on the plain path on the card.
4. The same config at ``scaling=4``: ``make_step_render`` renders through
   K3, checked against the plain render.
5. Times (CUDA events): ms/step of the kernel and plain paths at 4096^2,
   and ms per call of each kernel and its plain version.

The last line is ``{"ok": true, "device": {...}}``; the line before it is
the per-kernel JSON summary.
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
MAIN_STEPS = 30
RENDER_STEPS = 3
SMALL = (61, 81)
PROD = (4096, 4096)
PKG = "esp32_fluid_simulation_tpu_torch"
KERNELS = {
    # name: (source, replaced TPU kernel)
    "K1 project_fused": (f"{PKG}/csrc/project.cu",
                         "esp32_fluid_simulation_tpu/ops/pallas/project.py:203"),
    "K2 advect_kernel": (f"{PKG}/csrc/advect.cu",
                         "esp32_fluid_simulation_tpu/ops/pallas/advect.py:715"),
    "K3 render_rgb565_kernel": (
        f"{PKG}/csrc/upscale.cu",
        "esp32_fluid_simulation_tpu/render/pallas_upscale.py:171"),
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


def phase1_kernels(dev):
    """Each kernel against its plain version, small and production shapes."""
    from esp32_fluid_simulation_tpu_torch import SimConfig, Impulses
    from esp32_fluid_simulation_tpu_torch.ops.cuda.advect import (
        advect_kernel, advect_reference)
    from esp32_fluid_simulation_tpu_torch.ops.cuda.project import (
        project_fused, project_fused_reference)
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


def plain_step_render(state, imp, cfg):
    """The production step + s=1 frame through the kernels' plain versions
    (the same arithmetic in PyTorch ops), on any device."""
    from esp32_fluid_simulation_tpu_torch import SimState
    from esp32_fluid_simulation_tpu_torch.ops.cuda.advect import (
        advect_reference)
    from esp32_fluid_simulation_tpu_torch.ops.cuda.project import (
        project_fused_reference)
    md = cfg.advect_max_disp
    vel = advect_reference(state.velocity, state.velocity, cfg.dt, True,
                           max_disp=md)
    vel, _ = project_fused_reference(vel, cfg.dx, cfg.sor_iters, cfg.omega,
                                     impulses=imp)
    color, frame = advect_reference(state.color, vel, cfg.dt, False,
                                    max_disp=md, clip01=True, rgb565=True)
    return SimState(velocity=vel, color=color, step=state.step + 1), frame


def reset_counts():
    from esp32_fluid_simulation_tpu_torch.ops.cuda.advect import advect_kernel
    from esp32_fluid_simulation_tpu_torch.ops.cuda.project import (
        project_fused)
    from esp32_fluid_simulation_tpu_torch.render.cuda_upscale import (
        render_rgb565_kernel)
    fns = {"K1 project_fused": project_fused,
           "K2 advect_kernel": advect_kernel,
           "K3 render_rgb565_kernel": render_rgb565_kernel}
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
    return n, state0


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
    return res


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available()"
                         " is false); this check runs only on a GPU")
    from esp32_fluid_simulation_tpu_torch import SimConfig
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
    phase2_golden(dev)
    cfg = SimConfig.from_json(CONFIG0.read_text())
    counts, state0 = phase3_4_main_path(dev, cfg)
    times = phase5_timing(dev, cfg, state0, card)

    for name, n in counts.items():
        if n == 0:
            raise AssertionError(f"{name} never launched on the main path")
    summary = {"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": counts[name], "max_abs_err": err[name],
         "ms": times[name], "plain_ms": times[name + " plain"]}
        for name, (src, rep) in KERNELS.items()]}
    print(card)
    print(json.dumps(summary))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
