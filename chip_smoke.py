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
   (``--fmad=false``).  K5 on its one-launch window route also at full
   reach (the CFL clamp binding everywhere), with a NaN and an inf
   velocity cell (against the two-launch route: the plain version has no
   answer for a NaN velocity), and on its two-launch route at a max_disp
   whose window does not fit a block.  K1 and K4 also at 130x200 and 4097x4093, at iters
   0, 1, 10 (their one-launch window routes) and 20 (their launch-sequence
   routes), K1 with impulses on the seams of its tiles and in a neighbour
   tile's ring;
   K3 at s = 1 to 5 (s = 4 its own instance), f32 and bf16, ``bswap`` and
   ``unit_range`` both ways.
1b. The same for the 3D smoke kernels (K7 advection, also its scalar
   launch with the plume's source and buoyancy, K8 divergence and
   gradient subtract, K9 SOR at iters 0, 1 and 10, K10 MIP render) at
   (9, 33, 130) and 256^3, K10 also at each volume of
   ``tests/mip_cases.py`` (every branch of its launch plan: short depths,
   ``H*W`` off the vector width, storage offsets, NaN, signed zeros,
   ``vmax``), one wrapper launch a call.
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
   counters proving K7 ran twice (once with the source and buoyancy), K8
   (each) and K9 once per step and K10 once per frame; the plume checked
   and held bit for bit to the same steps on the plain path on the card
   (the source and buoyancy there as eager ops after K7's plain
   version).
8. Config 3: ``examples/config3_2048_maccormack_multigrid.json`` through
   ``make_step_render`` for 20 steps (K5 = 2 one-launch calls per step,
   no two-launch call, no K2 launch), bit-identical to the plain path on
   the card.
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
13. The tiled-domain modes (K6: ``member=`` of K1, K2, K4 and K5, K2's
   ``overlay=``) against their plain versions on a 2x3 grid of odd 17x21
   members, a 2x2 grid of 32x64 members, a 3x5 grid of 48x40 members (their
   walls cross K1's tiles) and config 4's 4096^2 supergrid of 256^2
   members (K1 and K4 at iters 0, 1, 10 and 20 on the small ones), and K1
   (iters 0, 1, 10, 15; 10 at 4096^2) and K2 (self-advect with the overlay,
   the f32 and bf16 dye) on each grid's member stack against their
   supergrid member modes under the permute; bit-equality is expected.
14. Config 4 (``examples/config4_ensemble_256.json``, 256 members of 256^2
   on one 4096^2 supergrid): 10 steps through ``make_ensemble_step`` (launch
   counters: K2 member = 2*steps, K2 overlay = steps, the member overlay
   kernel = steps, K1 member = steps, all on the member stack: stack
   launches K2 = 2*steps, K1 = steps, and no layout conversion), each
   step's member overlay kernel against its plain version bit for bit, the
   plain path built on that plain overlay, the same steps with the state
   laid out on the supergrid and back around the supergrid member modes
   (``supergrid_route``), the same schedule through
   ``make_ensemble_multi_step``, and 10 steps of
   the tiled ``make_step_render``, each bit-identical to the plain path on
   the card; member 0 also equals the member stepped alone through
   ``make_step`` on the non-member kernels, bit for bit.
15. Block mode (K11) of K1, K2 and K4 against the plain versions: every
   block of 130x200 cut 2x2, and the (0, 0) and (4096, 4096) blocks of
   8192^2 cut into 4096^2 blocks (K2 on the f32 velocity with
   ``return_minmax`` and on the bf16 dye with the clip, K1 with and without
   impulses, K4, at iters 10; K1 also at iters 0, 1 and 20 and with 65x40
   members, K4 at iters 0, 1 and 20 with a halo of 2*iters and of 2*iters +
   3, on 130x200); bit-equality is expected.
15b. Block mode (K11) of K7 and K9 against the plain versions: every
   block of (9, 130, 200) cut 2x2 and the (0, 0) block of 256^3 cut 2x2
   (K7 on the f32 velocity with no-slip, its self-advect (the velocity
   read from the haloed field) and on bf16 scalars, also against the crop
   of whole-grid K7; K9 chunks of 3 sweeps (one pass), 1 and 4
   (two passes) from zero and from a given pressure); bit-equality is
   expected.
16. The sharded main path: ``examples/config5_8192_sharded.json`` with
   config 0's kernel settings (``fused_pallas``, ``advect_impl="pallas"``)
   on a 2x2 mesh of the one card (four 4096^2 blocks on cuda:0): 10 steps
   of ``make_sharded_step`` (launch counters: K1 block = 4*steps, K2 block =
   8*steps), bit-identical to the single-device ``make_step`` at 8192^2 and
   to the plain path; then config 5 as written (eager SOR and advection)
   for 2 steps against the single-device eager step.
17. The other sharded routes on the card, each on a 2x2 mesh:
   ``sor_pallas`` at 4096^2 (K4 block = 4*steps), MacCormack with kernel
   advection at 2048^2 (K2 block with ``return_minmax``), bit-identical to
   the single-device step; ``make_sharded_step_with_metrics``; the sharded
   render (every pixel equal); config 4 through
   ``make_sharded_ensemble_step``, each shard's members bit-identical to
   them stepped alone through ``make_ensemble_step`` (the whole ensemble
   differs off shard (0, 0), where the coordinates are shard-local; the
   difference is printed).
18. Config 5's 3D half: the default 256^3 ``SmokeConfig`` with
   ``advect_impl="pallas"``, ``sor_impl="pallas"`` on the 2x2 mesh of the
   card (four 256x128x128 blocks): 10 steps of ``make_sharded_smoke_step``
   (launch counters: K7 block = 2*4*steps (the velocity self-advect and
   the stacked density + temperature), K9 block = 4*ceil(10/3)*steps,
   no whole-grid K8 or K9), against the single-device ``make_smoke_step``
   and the plain path; then the default ``"auto"`` plume (eager route)
   for 2 steps against the single-device eager step at the bf16 bounds.
19. The 3D dye bed at (64, 1024, 1024) on the 2x2 mesh: 3 steps of
   ``make_sharded_step`` with ``advect_impl="pallas"``, ``solver=
   "sor_pallas"`` (K7 block = 2*4*steps, K9 block = 16*steps) against the
   sharded eager route (rtol 1e-4, atol 1e-4); the K9 block chain on the
   divergence of its state against ``sor_solve`` of the gathered
   divergence and whole-grid K9.
20. The headless runner at config 0: ``run.main`` for 20 steps with a
   checkpoint every 10, then ``--resume`` for 10 more (the resumed state,
   its bf16 dye through the checkpoint, bit-equal to 30 uninterrupted
   ``make_step`` steps; the ``--frame`` PPM equal to ``render_rgb8`` of the
   final dye), ``--metrics`` for 10 steps (each row finite, the divergence
   not raised by the projection), and ``make_guarded_step`` on a
   NaN-salted state (reset to the fresh state) and on a finite one (kept,
   equal to ``make_step``'s); launch counters: K1 = steps, K2 = 2*steps.
21. ``SimPipeline`` at config 0: 60 frames at fps=1000 with two drags
   pushed before ``run`` (drained at frame 0), every frame delivered and
   bit-equal to a serial ``make_step_render`` replay; K1 = frames, K2 =
   2*frames.
22. ``serve`` at config 0 with ``stream_decim=4`` on a free port: /stats
   steps advance, /drag answers 204, two /frame (after a drag each)
   differ; K1 = steps, K2 = 2*steps.
23. The demo (``esp32_fluid_simulation_tpu_torch.demo``) at its own small
   sizes: the 2D bed, ``--pipeline`` and ``--smoke3d`` write their frames.
   Phases 20-22 print their loop's rate (run.main steps/s, the
   pipeline's frames/s, the server's sim_fps) beside the CUDA-event time
   of the same entry point chained, with the card's name and power limit;
   their K1 and K2 launches count in those kernels' rows.
24. Config 5 at 8192^2 with phase 16's kernel settings across two
   processes on the card (``parallel/dcn.py``'s ``run_dcn_dryrun``, gloo,
   each process owning one row of two 4096^2 blocks, the strips that cross
   processes staged through pinned host buffers): 5 steps, each process's
   blocks bit-equal to ``make_step`` at 8192^2; the children's K11 K1/K2
   block launches (2*steps and 4*steps each) count in those rows; their
   ms/step (CUDA events, the slower rank's) beside the single-process 2x2
   mesh's.
5. Times (CUDA events), last: ms/step of the kernel and plain paths at
   4096^2, at 256^3, of config 3, of the ``sor_pallas`` step, of config 2
   and of config 4 (whole-ensemble step beside ``supergrid_route``'s in
   turns, member-steps/s, the rollout's step, the tiled ``step_render``,
   and the step's split into kernels on the member stack and on the
   supergrid, overlay build and layout permutes), and ms per call of each
   kernel and mode and
   its plain version; K1's and K4's device launches per call on both
   routes, K5's per call, and K9's per pass (a profiler count: 1 on the
   window routes in every mode, K5's included, 1 per pass for K9 and
   ``sor3d_chunk``), K5's two-launch route beside its window route,
   K1's and K4's
   sequence routes at iters 10 beside their window routes, K1's window
   route at five tile sizes, and K9 and the sharded chain's chunk at
   other pass depths and tiles (each checked against its plain version);
   the sharded step at
   8192^2 beside the single-device step, its split (K1 block x4, K2 block
   x8, the halo exchanges) and each block mode beside its whole-grid
   kernel at 4096^2; the sharded 256^3
   smoke step beside the single-device one, its split (K7 block x8, the
   K9 block chain, the exchanges, the eager ops), and the 3D dye-bed step
   on both routes; last, after every other profiler trace (a short trace
   taken after an early one in the process was seen to miss device
   events), K10's device launches per call at each phase 1b volume (one
   trace) and its device times at 256^3 (one trace: cold with L2 dirty
   and clean, warm, bf16 and f32, and inside the ``make_smoke_step`` +
   ``render_smoke`` chain, which the summary's K10 entry carries), the
   chain's ms per step + frame and the wrapper's host us per call.
25. After phase 5: ``utils.profiling.chain_time`` of config 0's
   ``make_step_render``, first cold (a fresh factory, the allocator's
   cache emptied), beside the CUDA-event time of the same chain, each
   reading within ``CHAIN_RTOL`` of it, and
   ``utils.roofline.speed_of_light(cfg0, "h100")``; one ``trace`` of 3
   config 0 steps, whose Chrome trace must hold K1's and K2's device
   kernels by name (K1 once and K2 twice a step).

Each kernel's entry in the summary carries its bound: the larger of the
bytes it must move (each input read once, each output written once) over
3.35 TB/s and its float32 operations over 67 TFLOP/s, the H100 SXM's
published peaks (``utils.roofline.GPU_SPECS["h100"]``).  The last line is ``{"ok": true, "device": {...}}``; the
line before it is the per-kernel JSON summary.
"""

from __future__ import annotations

import dataclasses
import itertools
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
CONFIG4 = ROOT / "examples" / "config4_ensemble_256.json"
CONFIG5 = ROOT / "examples" / "config5_8192_sharded.json"
SMOKE_GOLDEN = ROOT / "tests" / "golden" / "path_smoke3d.npz"
MAIN_STEPS = 30
RENDER_STEPS = 3
SMOKE_STEPS = 20
CONFIG3_STEPS = 20
SOR_STEPS = 10
CONFIG2_STEPS = 20
METRIC_STEPS = 5
ENSEMBLE_STEPS = 10
ENSEMBLE_N = 256
SHARDED_STEPS = 10
SHARDED_EAGER_STEPS = 2
ROUTE_STEPS = 3
MESH_2X2 = (2, 2)
SWIRL_SPEED = 300.0            # scripted_swirl's default poke, cells/s
# phase 15's (grid, block, block origins): every block of 130x200 cut 2x2,
# and the corner and far blocks of 8192^2 cut into 4096^2 blocks
BLOCK_CASES = (((130, 200), (65, 100), ((0, 0), (0, 100), (65, 0), (65, 100))),
               ((8192, 8192), (4096, 4096), ((0, 0), (4096, 4096))))
# (grid, member tile): odd members, even members, config 4's supergrid
TILINGS = (((34, 63), (17, 21)), ((64, 128), (32, 64)),
           ((144, 200), (48, 40)), ((4096, 4096), (256, 256)))
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
# phase 15b's (grid, block, block origins): every block of (9, 130, 200)
# cut 2x2, and the corner block of 256^3 cut 2x2
BLOCK3_CASES = (((9, 130, 200), (65, 100),
                 ((0, 0), (0, 100), (65, 0), (65, 100))),
                (SMOKE, (128, 128), ((0, 0),)))
SHARDED_SMOKE_STEPS = 10
DYEBED3 = (64, 1024, 1024)     # 1.6 GB of state (f32 velocity and dye)
DYEBED3_STEPS = 3
K10_CALLS = 20                 # K10 calls a profiler trace of phase 5
# phases 20-22: the host side at config 0
RUN_STEPS = 20                 # run.main's first run ...
RUN_CKPT_EVERY = 10            # ... checkpointing every 10 steps and at the end
RESUME_STEPS = 10              # --resume of the last checkpoint
RUN_METRIC_STEPS = 10          # --metrics, a row a step
RUN_TIME_STEPS = (10, 510)     # timed runs of two lengths, differenced
PIPE_FRAMES = 60
# (i, j, vi, vj), pushed before SimPipeline.run: drained at frame 0
PIPE_DRAGS = ((2048, 1024, 200.0, -150.0), (1024, 3000, -120.0, 90.0))
SERVE_DECIM = 4                # the server streams a 1024^2 mean-pooled view
SERVE_MIN_STEPS = 64           # two sim_fps readings (every 32 steps)
# /drag bodies' (from, to) in screen fractions, one before each /frame
SERVE_DRAGS = (([0.4, 0.5], [0.6, 0.5]), ([0.3, 0.2], [0.3, 0.4]))
DCN_STEPS = 5                  # phase 24: config 5 across two processes
DCN_TIMEOUT = 300.0
CHAIN_STEPS = 20               # phase 25: chain_time's chain
TRACE_STEPS = 3                # phase 25: the steps of its trace
SCRATCH_BYTES = 256 << 20      # written before each cold K10 call: 5x L2
# phase 25: each chain_time reading, the cold one (a fresh factory, the
# allocator's cache emptied) too, within this share of the CUDA-event time
CHAIN_RTOL = 0.10
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
    # K6, the tiled-domain modes on config 4's path (K4's and K5's member=
    # have no caller on any path: their checks count in K4's and K5's rows)
    "K6 K2 advect_kernel member": (f"{PKG}/csrc/advect.cu",
                                   f"{TPU}/ops/pallas/advect.py:112"),
    "K6 K2 advect_kernel overlay": (f"{PKG}/csrc/advect.cu",
                                    f"{TPU}/ops/pallas/advect.py:601"),
    "K6 K1 project_fused member": (f"{PKG}/csrc/project.cu",
                                   f"{TPU}/ops/pallas/project.py:121"),
    # K11, block mode: K1 and K2 on the sharded main path, K4 on the
    # sharded sor_pallas route
    "K11 K1 project_fused block": (f"{PKG}/csrc/project.cu",
                                   f"{TPU}/ops/pallas/project.py:212"),
    "K11 K2 advect_kernel block": (f"{PKG}/csrc/advect.cu",
                                   f"{TPU}/ops/pallas/advect.py:741"),
    "K11 K4 sor_solve_kernel block": (f"{PKG}/csrc/sor.cu",
                                      f"{TPU}/ops/pallas/sor.py:101"),
    # K11 for the 3D kernels, on the sharded smoke's main path (phase 18)
    "K11 K7 advect3d_kernel block": (f"{PKG}/csrc/advect3d.cu",
                                     f"{TPU}/ops/pallas/advect3d.py:255"),
    "K11 K9 sor3d_chunk block": (f"{PKG}/csrc/sor3d.cu",
                                 f"{TPU}/ops/pallas/sor3d.py:246"),
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
    that moves ``nbytes`` and does ``flops`` float32 operations, at the
    H100's peaks in ``utils.roofline.GPU_SPECS``."""
    from esp32_fluid_simulation_tpu_torch.utils.roofline import GPU_SPECS

    spec = GPU_SPECS["h100"]
    t_bytes = nbytes / (spec.hbm_gbps * 1e6)
    t_ops = flops / (spec.f32_tflops * 1e9)
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def phase1_kernels(dev):
    """Each kernel against its plain version, small and production shapes."""
    from esp32_fluid_simulation_tpu_torch import SimConfig, Impulses
    from esp32_fluid_simulation_tpu_torch.ops.cuda import advect
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
            for s, bswap, unit_range in itertools.product(
                    (1, 2, 3, 4, 5), (True, False), (False, True)):
                got = render_rgb565_kernel(c, s, bswap, unit_range)
                want = render_rgb565_reference(c, s, bswap, unit_range)
                err["K3 render_rgb565_kernel"] = max(
                    err["K3 render_rgb565_kernel"],
                    compare(f"K3 s={s} {str(dtype)[6:]} bswap={bswap} "
                            f"unit_range={unit_range}", got, want))
                del got, want

    err["K1 project_fused"] = max(err["K1 project_fused"],
                                  k1_windows(dev, gen))
    err["K4 sor_solve_kernel"] = k4_routes(dev, gen)
    for shape in (SMALL, MC_PROD):
        h, w = shape
        print(f"phase 1 K5 vs plain at {h}x{w}")
        # sigma 200 cells/s: the CFL clamp binds on ~7% of the cells
        vel = 200.0 * torch.randn((2, h, w), generator=gen, device=dev)
        dye = torch.rand((3, h, w), generator=gen,
                         device=dev).to(torch.bfloat16)
        # the window route at full reach (the CFL clamp binds everywhere:
        # sigma 2000 cells/s) and with a NaN and an inf velocity cell (each
        # counts as max_disp)
        fast = 2000.0 * torch.randn((2, h, w), generator=gen, device=dev)
        odd = vel.clone()
        odd[0, h // 2, w // 3] = float("nan")
        odd[1, 7, w - 5] = float("inf")
        f32 = torch.rand((2, h, w), generator=gen, device=dev)
        # the plain version, as JAX, has no answer for a NaN velocity: the
        # NaN cases hold the window route to the two-launch route, which
        # shares the kernel's clamp
        cases = [(vel, vel, True, "f32 2ch no_slip"),
                 (dye, vel, False, "bf16 3ch"),
                 (f32, fast, True, "f32 2ch no_slip full reach"),
                 (dye, fast, False, "bf16 3ch full reach"),
                 (f32, odd, True, "f32 2ch no_slip NaN velocity"),
                 (dye, odd, False, "bf16 3ch NaN velocity")]
        n0 = advect_maccormack_kernel.launches
        for field, v, no_slip, label in cases:
            want = (advect._launch_two(field, v, dt, no_slip, 12, None)
                    if v is odd else
                    advect_maccormack_reference(field, v, dt, no_slip, 12))
            if torch.isnan(want).any():
                raise AssertionError(f"phase 1: K5 {label}: NaN in the "
                                     "route compared with")
            err["K5 advect_maccormack_kernel"] = max(
                err["K5 advect_maccormack_kernel"],
                compare(f"K5 {label}",
                        advect_maccormack_kernel(field, v, dt, no_slip, 12),
                        want))
        if advect_maccormack_kernel.launches - n0 != len(cases):
            raise AssertionError("phase 1: K5 at max_disp 12 left the window "
                                 "route")
        # the two-launch route: a max_disp whose worst-case window does not
        # fit a block's shared memory
        md = 120
        n0 = advect_maccormack_kernel.two_launch_calls
        for field, no_slip, label in ((vel, True, "f32 2ch no_slip"),
                                      (dye, False, "bf16 3ch")):
            err["K5 advect_maccormack_kernel"] = max(
                err["K5 advect_maccormack_kernel"],
                compare(f"K5 two-launch route max_disp {md} {label}",
                        advect_maccormack_kernel(field, fast, dt, no_slip,
                                                 md),
                        advect_maccormack_reference(field, fast, dt, no_slip,
                                                    md)))
        if advect_maccormack_kernel.two_launch_calls - n0 != 2:
            raise AssertionError(f"phase 1: K5 at max_disp {md} did not take "
                                 "the two-launch route")
    return err


def seam_impulses(shape, iters, dev):
    """Impulse slots on the first strip and segment seams of K1's window
    route (``strip_plan`` at the blocks planned for the card) and within a
    window's reach of them (2*iters + 2 cells), a duplicate cell (the last
    active slot wins) and an out-of-range position."""
    from esp32_fluid_simulation_tpu_torch import SimConfig, Impulses
    from esp32_fluid_simulation_tpu_torch.ops.cuda import project
    it = min(iters, project.WINDOW_MAX_ITERS)
    n_strips, n_segs = project.strip_plan(
        *shape, it, project.strip_blocks(torch.device(dev), it))
    th, tw = max(shape[0] // n_segs, 1), max(shape[1] // n_strips, 1)
    r = 2 * iters + 2
    return Impulses.from_lists(
        SimConfig(shape=shape, max_impulses=8),
        [(th, tw), (th - 1, tw - 1), (th + r - 1, 5), (th, tw),
         (3, tw + r - 1), (2 * th, 2 * tw + 1), (shape[0] + 50, -3)],
        [(90.0, -45.0), (33.0, 44.0), (-60.0, 120.0), (-20.0, 65.0),
         (7.0, 8.0), (25.0, -15.0), (5.0, 5.0)], device=dev)


def k1_windows(dev, gen):
    """K1 whole-grid against its plain version on shapes that are not
    multiples of a strip or a segment, at iters 0, 1, 10, 15 (window route)
    and 20 (sequence route), with and without seam impulses; returns the
    largest difference."""
    from esp32_fluid_simulation_tpu_torch.ops.cuda.project import (
        WINDOW_MAX_ITERS, project_fused, project_fused_reference)
    if WINDOW_MAX_ITERS >= 20:
        raise AssertionError("phase 1: iters 20 no longer takes K1's "
                             "sequence route")
    err = 0.0
    for shape in (SMALL, (130, 200), (4097, 4093), PROD):
        print(f"phase 1 K1 routes vs plain at {shape[0]}x{shape[1]}")
        vel = 40.0 * torch.randn((2,) + shape, generator=gen, device=dev)
        for iters in (0, 1, 10, 15, 20):
            for imp in (seam_impulses(shape, iters, dev), None):
                label = (f"K1 {shape[0]}x{shape[1]} iters={iters} "
                         f"{'seam impulses' if imp is not None else 'none'}")
                got = project_fused(vel, 1.0, iters, 1.96, impulses=imp)
                want = project_fused_reference(vel, 1.0, iters, 1.96, imp)
                err = max(err, compare(label + " velocity", got[0], want[0]),
                          compare(label + " pressure", got[1], want[1]))
        del vel, got, want
    return err


def k4_routes(dev, gen):
    """K4 whole-grid against its plain version on shapes that are not
    multiples of its tile, at iters 0, 1, 10 (window route) and 20
    (sequence route), each route's launch counted; returns the largest
    difference."""
    from esp32_fluid_simulation_tpu_torch.ops.cuda.sor import (
        WINDOW_MAX_ITERS, sor_solve_kernel, sor_solve_reference)
    if WINDOW_MAX_ITERS >= 20:
        raise AssertionError("phase 1: iters 20 no longer takes K4's "
                             "sequence route")
    err = 0.0
    for shape in (SMALL, (130, 200), (4097, 4093), PROD):
        d = torch.randn(shape, generator=gen, device=dev)
        for iters, dx in ((10, 1.0), (1, 0.7), (0, 1.0), (20, 1.0)):
            window = iters <= WINDOW_MAX_ITERS
            before = (sor_solve_kernel.window_launches,
                      sor_solve_kernel.sequence_launches)
            got = sor_solve_kernel(d, dx, iters, 1.96)
            if (sor_solve_kernel.window_launches - before[0],
                    sor_solve_kernel.sequence_launches - before[1]) != (
                        (1, 0) if window else (0, 1)):
                raise AssertionError(f"phase 1: K4 at iters {iters} took "
                                     "the wrong route")
            err = max(err, compare(
                f"K4 {shape[0]}x{shape[1]} iters={iters} dx={dx} "
                f"({'window' if window else 'sequence'} route)", got,
                sor_solve_reference(d, dx, iters, 1.96)))
        del d, got
    return err


def phase1b_kernels3d(dev):
    """Each 3D smoke kernel against its plain version, at a small odd shape
    and at the plume's 256^3, K10 also at every branch of its plan.
    Returns the largest difference per summary row and K10's calls
    (volume, vmax), whose device launches phase 5 counts."""
    from esp32_fluid_simulation_tpu_torch import SmokeConfig
    from esp32_fluid_simulation_tpu_torch.models.smoke3d import (
        inject_and_buoy, plume_source, source_tensor)
    from esp32_fluid_simulation_tpu_torch.ops.cuda.advect3d import (
        advect3d_kernel, advect3d_reference, advect3d_source_kernel)
    from esp32_fluid_simulation_tpu_torch.ops.cuda.fd3d import (
        divergence3d, divergence3d_reference, subtract_gradient3d,
        subtract_gradient3d_reference)
    from esp32_fluid_simulation_tpu_torch.ops.cuda.sor3d import (
        sor3d_solve, sor3d_reference)
    from esp32_fluid_simulation_tpu_torch.render.cuda_smoke import (
        render_smoke_mip_kernel, render_smoke_mip_reference)

    gen = torch.Generator(device=dev).manual_seed(4321)
    err = {}
    k10_calls = []

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
        # the scalar launch with the plume's source on the default sphere,
        # against the plain launch and inject_and_buoy's eager ops
        scfg = SmokeConfig(shape=shape)
        mask = source_tensor(scfg, dev)
        got_vel, want_vel = vel.clone(), vel.clone()
        got = advect3d_source_kernel(pair[0], pair[1], got_vel, dt, False,
                                     plume_source(scfg, mask), 2)
        want_vel, rho_w, temp_w = inject_and_buoy(
            want_vel, *advect3d_reference(pair, want_vel, dt, False, 2),
            mask, scfg)
        check("K7 advect3d_kernel", "K7 scalars + source: velocity",
              got_vel, want_vel)
        check("K7 advect3d_kernel", "K7 scalars + source: scalars", got,
              torch.stack([rho_w, temp_w]))
        p = torch.randn(shape, generator=gen, device=dev)
        check("K8 divergence3d", "K8 divergence", divergence3d(vel, 1.0),
              divergence3d_reference(vel, 1.0))
        check("K8 subtract_gradient3d", "K8 gradient subtract",
              subtract_gradient3d(vel, p, 1.0),
              subtract_gradient3d_reference(vel, p, 1.0))
        for iters in (10, 1, 0):
            check("K9 sor3d_solve", f"K9 iters={iters} chunk=3",
                  sor3d_solve(p, 1.0, iters, 1.5, chunk=3),
                  sor3d_reference(p, 1.0, iters, 1.5))
        rho = 1.2 * torch.rand(shape, generator=gen, device=dev)
        for dtype in (torch.float32, torch.bfloat16):
            x = rho.to(dtype)
            for bswap in (True, False):
                check("K10 render_smoke_mip_kernel",
                      f"K10 {str(dtype)[6:]} bswap={bswap}",
                      render_smoke_mip_kernel(x, bswap),
                      render_smoke_mip_reference(x, bswap))
            k10_calls.append((x, 1.0))
    cases = mip_cases()
    print("phase 1b K10 at every branch of its plan (tests/mip_cases.py)")
    for name, (*_, route) in cases.MIP_CASES.items():
        vol, vmax = cases.mip_case(name, dev)
        for bswap in (True, False):
            n = render_smoke_mip_kernel.launches
            got = render_smoke_mip_kernel(vol, bswap, vmax)
            if render_smoke_mip_kernel.launches != n + 1:
                raise AssertionError(f"phase 1b: K10 {name} launched "
                                     f"{render_smoke_mip_kernel.launches - n}"
                                     " times")
            check("K10 render_smoke_mip_kernel",
                  f"K10 {name} ({route}) bswap={bswap}", got,
                  render_smoke_mip_reference(vol, bswap, vmax))
        k10_calls.append((vol, vmax))
    return err, k10_calls


def mip_cases():
    """``tests/mip_cases.py``: the volumes K10 is held on, shared with the
    tests (it imports nothing of JAX)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "mip_cases", ROOT / "tests" / "mip_cases.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


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
    """Set every launch counter to 0; returns a function that reads them."""
    from esp32_fluid_simulation_tpu_torch.ops.cuda.advect import (
        advect_kernel, advect_maccormack_kernel, member_overlay)
    from esp32_fluid_simulation_tpu_torch.ops.cuda.sor import sor_solve_kernel
    from esp32_fluid_simulation_tpu_torch.ops.cuda.project import (
        project_fused)
    from esp32_fluid_simulation_tpu_torch.render.cuda_upscale import (
        render_rgb565_kernel)
    from esp32_fluid_simulation_tpu_torch.ops.cuda.advect3d import (
        advect3d_kernel)
    from esp32_fluid_simulation_tpu_torch.ops.cuda.fd3d import (
        divergence3d, subtract_gradient3d)
    from esp32_fluid_simulation_tpu_torch.ops.cuda.sor3d import (
        sor3d_chunk, sor3d_solve)
    from esp32_fluid_simulation_tpu_torch.render.cuda_smoke import (
        render_smoke_mip_kernel)
    counters = {
        "K1 project_fused": (project_fused, "launches"),
        "K2 advect_kernel": (advect_kernel, "launches"),
        "K3 render_rgb565_kernel": (render_rgb565_kernel, "launches"),
        "K4 sor_solve_kernel": (sor_solve_kernel, "launches"),
        # K5's window route, one launch per call; its two-launch route
        # (a max_disp whose window does not fit a block) counted apart
        "K5 advect_maccormack_kernel": (advect_maccormack_kernel,
                                        "launches"),
        "K5 two-launch route": (advect_maccormack_kernel,
                                "two_launch_calls"),
        "K7 advect3d_kernel": (advect3d_kernel, "launches"),
        # K7's scalar launches with the plume's source and buoyancy
        "K7 source launches": (advect3d_kernel, "source_launches"),
        "K8 divergence3d": (divergence3d, "launches"),
        "K8 subtract_gradient3d": (subtract_gradient3d, "launches"),
        "K9 sor3d_solve": (sor3d_solve, "launches"),
        "K10 render_smoke_mip_kernel": (render_smoke_mip_kernel, "launches"),
        # the tiled-domain modes (K6), counted beside their kernels' own
        "K6 K2 advect_kernel member": (advect_kernel, "member_launches"),
        "K6 K2 advect_kernel overlay": (advect_kernel, "overlay_launches"),
        # an ensemble's member impulses as K2's overlay, one launch a step
        "K6 K2 member overlay": (member_overlay, "launches"),
        "K6 K1 project_fused member": (project_fused, "member_launches"),
        # the member modes on a member stack, counted in the rows above too
        "K6 K2 stack": (advect_kernel, "stack_launches"),
        "K6 K1 stack": (project_fused, "stack_launches"),
        "K6 K4 member": (sor_solve_kernel, "member_launches"),
        "K6 K5 member": (advect_maccormack_kernel, "member_launches"),
        # block mode (K11)
        "K11 K1 project_fused block": (project_fused, "block_launches"),
        "K11 K2 advect_kernel block": (advect_kernel, "block_launches"),
        "K11 K4 sor_solve_kernel block": (sor_solve_kernel,
                                          "block_launches"),
        "K11 K7 advect3d_kernel block": (advect3d_kernel, "block_launches"),
        "K11 K9 sor3d_chunk block": (sor3d_chunk, "launches"),
        # K1's two routes, counted beside its modes
        "K1 window route": (project_fused, "window_launches"),
        "K1 sequence route": (project_fused, "sequence_launches"),
    }
    for fn, attr in counters.values():
        setattr(fn, attr, 0)
    return lambda: {k: getattr(fn, attr)
                    for k, (fn, attr) in counters.items()}


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
            n["K1 window route"] != MAIN_STEPS or \
            n["K2 advect_kernel"] != 2 * MAIN_STEPS:
        raise AssertionError(f"phase 3: launch counts {n} for {MAIN_STEPS} "
                             "steps (want K1 = K1's window route = steps, "
                             "K2 = 2 * steps)")
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
        CONFIG3_STEPS, {"K5 advect_maccormack_kernel": s2,
                        "K5 two-launch route": 0, "K2 advect_kernel": 0,
                        "K1 project_fused": 0}, True)
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


def phase13_k6_kernels(dev):
    """The tiled-domain modes (K6) against their plain versions, at odd and
    even member tiles and at config 4's supergrid.  Returns the largest
    difference per summary row."""
    from esp32_fluid_simulation_tpu_torch import SimConfig, Impulses
    from esp32_fluid_simulation_tpu_torch.models.stable_fluids import (
        _to_members, impulse_overlay)
    from esp32_fluid_simulation_tpu_torch.ops.cuda.advect import (
        advect_kernel, advect_maccormack_kernel, advect_maccormack_reference,
        advect_reference)
    from esp32_fluid_simulation_tpu_torch.ops.cuda.project import (
        project_fused, project_fused_reference)
    from esp32_fluid_simulation_tpu_torch.ops.cuda.sor import (
        sor_solve_kernel, sor_solve_reference)

    gen = torch.Generator(device=dev).manual_seed(2468)
    err = {}

    def check(name, label, got, want):
        err[name] = max(err.get(name, 0.0), compare(label, got, want))

    dt = 1.0 / 30.0
    for shape, member in TILINGS:
        h, w = shape
        print(f"phase 13 K6 modes vs plain at {h}x{w}, members "
              f"{member[0]}x{member[1]}")
        cfg = SimConfig(shape=shape, max_impulses=8)
        # a duplicated cell (the last active slot wins), a zero-velocity
        # write, a cell on a member wall and an out-of-range position
        imp = Impulses.from_lists(
            cfg, [(5, 7), (h // 3, w // 2), (5, 7), (member[0], 9),
                  (h + 50, -3)],
            [(30.0, -12.0), (-8.0, 25.0), (99.0, 1.0), (0.0, 0.0),
             (7.0, 8.0)], device=dev)
        ov = impulse_overlay(imp, shape)
        # sigma 200 cells/s: |v|*dt > max_disp=12 on ~7% of the cells
        vel = 200.0 * torch.randn((2, h, w), generator=gen, device=dev)
        check("K6 K2 advect_kernel member", "K2 member self-advect f32",
              advect_kernel(vel, vel, dt, True, 12, self_advect=True,
                            member=member),
              advect_reference(vel, vel, dt, True, 12, member=member))
        check("K6 K2 advect_kernel overlay",
              "K2 member+overlay self-advect f32",
              advect_kernel(vel, vel, dt, True, 12, self_advect=True,
                            member=member, overlay=ov),
              advect_reference(vel, vel, dt, True, 12, member=member,
                               overlay=ov))
        check("K6 K2 advect_kernel overlay", "K2 overlay (no member) f32",
              advect_kernel(vel, vel, dt, True, 12, self_advect=True,
                            overlay=ov),
              advect_reference(vel, vel, dt, True, 12, overlay=ov))
        vel = 60.0 * torch.randn((2, h, w), generator=gen, device=dev)
        dye = 2.0 * torch.rand((3, h, w), generator=gen, device=dev) - 0.5
        for dtype in (torch.float32, torch.bfloat16):
            c = dye.to(dtype)
            got_c, got_f = advect_kernel(c, vel, dt, False, 12, clip01=True,
                                         rgb565=True, member=member)
            want_c, want_f = advect_reference(c, vel, dt, False, 12,
                                              clip01=True, rgb565=True,
                                              member=member)
            label = f"K2 member dye {str(dtype)[6:]} clip01"
            check("K6 K2 advect_kernel member", label, got_c, want_c)
            check("K6 K2 advect_kernel member", label + " frame", got_f,
                  want_f)
            ov4 = torch.cat([ov[:2], ov[1:2], ov[2:]])    # [4, H, W]
            check("K6 K2 advect_kernel overlay",
                  f"K2 member+overlay dye {str(dtype)[6:]}",
                  advect_kernel(c, vel, dt, False, 12, clip01=True,
                                member=member, overlay=ov4),
                  advect_reference(c, vel, dt, False, 12, clip01=True,
                                   member=member, overlay=ov4))
        got = advect_kernel(vel, vel, dt, True, 12, return_minmax=True,
                            member=member)
        want = advect_reference(vel, vel, dt, True, 12, return_minmax=True,
                                member=member)
        for g, w_, part in zip(got, want, ("out", "cmin", "cmax")):
            check("K6 K2 advect_kernel member", f"K2 member minmax {part}",
                  g, w_)

        vel = 40.0 * torch.randn((2, h, w), generator=gen, device=dev)
        for iters in ((10,) if h * w > 1 << 20 else (0, 1, 10, 20)):
            for impulses in (imp, None):
                label = (f"iters={iters} " + ("impulses" if impulses
                                              is not None else "none"))
                got_v, got_p = project_fused(vel, 1.0, iters, 1.96,
                                             impulses=impulses,
                                             member=member)
                want_v, want_p = project_fused_reference(
                    vel, 1.0, iters, 1.96, impulses, member)
                check("K6 K1 project_fused member", f"K1 member velocity "
                      f"({label})", got_v, want_v)
                check("K6 K1 project_fused member", f"K1 member pressure "
                      f"({label})", got_p, want_p)
        # the member stack (the supergrid's members row-major, as
        # modes.member_grid tiles them), addressed in place, against the
        # supergrid member mode under the permute
        for iters in ((10,) if h * w > 1 << 20 else (0, 1, 10, 15)):
            got_v, got_p = project_fused(_to_members(vel, *member), 1.0,
                                         iters, 1.96, member=member)
            want_v, want_p = project_fused(vel, 1.0, iters, 1.96,
                                           member=member)
            check("K6 K1 project_fused member", f"K1 stack velocity "
                  f"iters={iters}", got_v, _to_members(want_v, *member))
            check("K6 K1 project_fused member", f"K1 stack pressure "
                  f"iters={iters}", got_p,
                  _to_members(want_p[None], *member)[:, 0])
        vel = 200.0 * torch.randn((2, h, w), generator=gen, device=dev)
        vs = _to_members(vel, *member)
        check("K6 K2 advect_kernel overlay", "K2 stack+overlay self-advect",
              advect_kernel(vs, None, dt, True, 12, self_advect=True,
                            member=member, overlay=ov),
              _to_members(advect_kernel(vel, vel, dt, True, 12,
                                        self_advect=True, member=member,
                                        overlay=ov), *member))
        for dtype in (torch.float32, torch.bfloat16):
            c = dye.to(dtype)
            check("K6 K2 advect_kernel member",
                  f"K2 stack dye {str(dtype)[6:]} clip01",
                  advect_kernel(_to_members(c, *member), vs, dt, False, 12,
                                clip01=True, member=member),
                  _to_members(advect_kernel(c, vel, dt, False, 12,
                                            clip01=True, member=member),
                              *member))
        d = torch.randn(shape, generator=gen, device=dev)
        for iters, dx in ((10, 1.0), (1, 0.7)) + (
                () if h * w > 1 << 20 else ((0, 1.0), (20, 1.0))):
            check("K4 sor_solve_kernel", f"K4 member iters={iters} dx={dx}",
                  sor_solve_kernel(d, dx, iters, 1.96, member=member),
                  sor_solve_reference(d, dx, iters, 1.96, member))
        vel = 200.0 * torch.randn((2, h, w), generator=gen, device=dev)
        dye_bf16 = torch.rand((3, h, w), generator=gen,
                              device=dev).to(torch.bfloat16)
        for field, no_slip, label in ((vel, True, "f32 2ch no_slip"),
                                      (dye_bf16, False, "bf16 3ch")):
            check("K5 advect_maccormack_kernel", f"K5 member {label}",
                  advect_maccormack_kernel(field, vel, dt, no_slip, 12,
                                           member=member),
                  advect_maccormack_reference(field, vel, dt, no_slip, 12,
                                              member=member))
    return err


def config4_schedule(member_cfg, n, steps, dev):
    """Per-step batched member impulses: member m's ``scripted_swirl`` at
    step ``7*m + t``, built on the host and copied once per step."""
    from esp32_fluid_simulation_tpu_torch import Impulses, stack_impulses
    from esp32_fluid_simulation_tpu_torch.io_host.touch import scripted_swirl
    return [Impulses(*(x.to(dev) for x in stack_impulses(
        [scripted_swirl(member_cfg, 7 * m + t, device="cpu")
         for m in range(n)]))) for t in range(steps)]


def plain_tiled_step(state, cfg_super, overlay, rgb565=False):
    """``_step_tiled``'s kernel path through the plain versions: K2 with
    ``member=`` and the overlay, K1 with ``member=``, K2 with ``member=`` on
    the dye (and its frame)."""
    from esp32_fluid_simulation_tpu_torch import SimState
    from esp32_fluid_simulation_tpu_torch.ops.cuda.advect import (
        advect_reference)
    from esp32_fluid_simulation_tpu_torch.ops.cuda.project import (
        project_fused_reference)
    m, md, dt = cfg_super.domain_tile, cfg_super.advect_max_disp, cfg_super.dt
    vel = advect_reference(state.velocity, state.velocity, dt, True, md,
                           member=m, overlay=overlay)
    vel, _ = project_fused_reference(vel, cfg_super.dx, cfg_super.sor_iters,
                                     cfg_super.omega, member=m)
    out = advect_reference(state.color, vel, dt, False, md, clip01=True,
                           rgb565=rgb565, member=m)
    color, frame = out if rgb565 else (out, None)
    st = SimState(velocity=vel, color=color, step=state.step + 1)
    return (st, frame) if rgb565 else st


def supergrid_route(member_cfg, cfg_super, gh, gw):
    """The ensemble step with the member stack laid out on the supergrid
    and back around the kernels' supergrid member modes (the route before
    the kernels addressed the stack in place; still the route above K1's
    trapezoid)."""
    from esp32_fluid_simulation_tpu_torch.models.ensemble import (
        _from_super, _step_super, _to_super)

    def step(state, imps):
        return _from_super(_step_super(_to_super(state, cfg_super), imps,
                                       cfg_super, gh, gw), member_cfg)
    return step


def phase14_config4(dev):
    """Config 4 through the ensemble entry points and the tiled
    ``step_render``; returns the launch counts of the ensemble run, the
    member config, the ensemble's first state and schedule."""
    from esp32_fluid_simulation_tpu_torch import (
        Impulses, SimConfig, SimState, init_ensemble, init_state,
        make_ensemble_step,
        make_ensemble_multi_step, make_step, make_step_render,
        stack_schedule, tiled_ensemble_config)
    from esp32_fluid_simulation_tpu_torch.io_host.touch import scripted_swirl
    from esp32_fluid_simulation_tpu_torch.models.ensemble import (
        layout_conversions)
    from esp32_fluid_simulation_tpu_torch.models.stable_fluids import (
        _from_members, _to_members, impulse_overlay)
    from esp32_fluid_simulation_tpu_torch.ops.cuda.advect import (
        member_overlay, member_overlay_reference)

    member_cfg = SimConfig.from_json(CONFIG4.read_text())
    n, steps = ENSEMBLE_N, ENSEMBLE_STEPS
    cfg_super, gh, gw = tiled_ensemble_config(member_cfg, n)
    h, w = cfg_super.shape
    mh, mw = member_cfg.shape
    state0 = init_ensemble(member_cfg, n, device=dev)
    sched = config4_schedule(member_cfg, n, steps, dev)
    ens_step = make_ensemble_step(member_cfg)
    torch.cuda.synchronize()
    counts = reset_counts()
    layouts = layout_conversions()
    st = state0
    for imps in sched:
        st = ens_step(st, imps)
    torch.cuda.synchronize()
    nc = counts()
    nc["layouts"] = layout_conversions() - layouts
    want = {"K2 advect_kernel": 2 * steps, "K1 project_fused": steps,
            "K6 K2 advect_kernel member": 2 * steps,
            "K6 K2 advect_kernel overlay": steps,
            "K6 K2 member overlay": steps,
            "K6 K1 project_fused member": steps, "K1 window route": steps,
            "K6 K2 stack": 2 * steps, "K6 K1 stack": steps, "layouts": 0,
            "K1 sequence route": 0, "K3 render_rgb565_kernel": 0,
            "K4 sor_solve_kernel": 0, "K5 advect_maccormack_kernel": 0}
    bad = {k: (nc[k], v) for k, v in want.items() if nc[k] != v}
    if bad:
        raise AssertionError(f"phase 14: launch counts (got, want) {bad}")
    if tuple(st.velocity.shape) != (n, 2, mh, mw) or st.step != steps:
        raise AssertionError(f"phase 14: state {tuple(st.velocity.shape)} "
                             f"at step {st.step}")
    if not (torch.isfinite(st.velocity).all()
            and torch.isfinite(st.color).all()):
        raise AssertionError("phase 14: non-finite ensemble state")
    lo, hi = float(st.color.min()), float(st.color.max())
    if lo < 0.0 or hi > 1.0:
        raise AssertionError(f"phase 14: dye outside [0, 1]: [{lo}, {hi}]")
    if torch.equal(st.velocity[0], st.velocity[1]):
        raise AssertionError("phase 14: members 0 and 1 did not diverge")
    print(f"phase 14 config 4: {n} members of {mh}x{mw} on a {h}x{w} "
          f"supergrid, {steps} make_ensemble_step steps: launches "
          f"{ {k: nc[k] for k in want} }; finite, dye in [{lo}, {hi}], "
          f"max |v| {float(st.velocity.norm(dim=1).max()):.4g}")

    # the member overlay kernel against its plain version, each step's
    ov_same = all(torch.equal(member_overlay(imps, gh, gw, mh, mw),
                              member_overlay_reference(imps, gh, gw, mh, mw))
                  for imps in sched)
    print(f"phase 14 member overlay kernel vs plain on the card, {steps} "
          f"schedules of {n} members: bit-identical={ov_same}")
    if not ov_same:
        raise AssertionError("phase 14: the member overlay kernel differs "
                             "from its plain version")

    # the same steps through the plain versions on the card
    ps = SimState(_from_members(state0.velocity, h, w),
                  _from_members(state0.color, h, w), 0)
    for imps in sched:
        ps = plain_tiled_step(ps, cfg_super, member_overlay_reference(
            imps, gh, gw, mh, mw))
    same = (torch.equal(_to_members(ps.velocity, mh, mw), st.velocity)
            and torch.equal(_to_members(ps.color, mh, mw), st.color))
    print(f"phase 14 ensemble vs plain path on the card: bit-identical="
          f"{same}")
    if not same:
        raise AssertionError("phase 14: the ensemble step differs from the "
                             "plain path")

    # the same steps with the state laid out on the supergrid and back
    # around the kernels: bit-equal, and its 2 conversions a step
    layouts = layout_conversions()
    ps = state0
    super_step = supergrid_route(member_cfg, cfg_super, gh, gw)
    for imps in sched:
        ps = super_step(ps, imps)
    torch.cuda.synchronize()
    conversions = layout_conversions() - layouts
    same = (torch.equal(ps.velocity, st.velocity)
            and torch.equal(ps.color, st.color) and ps.step == st.step)
    print(f"phase 14 the member stack addressed in place vs laid out on the "
          f"supergrid and back ({conversions} conversions in {steps} "
          f"steps): bit-identical={same}")
    if not same or conversions != 2 * steps:
        raise AssertionError("phase 14: the ensemble step on the member "
                             "stack differs from the supergrid route")

    run = make_ensemble_multi_step(member_cfg)(state0, stack_schedule(sched))
    same = (torch.equal(run.velocity, st.velocity)
            and torch.equal(run.color, st.color) and run.step == steps)
    print(f"phase 14 make_ensemble_multi_step over the {steps}-step schedule "
          f"equals stepping: {same}")
    if not same:
        raise AssertionError("phase 14: the rollout differs from stepping")

    # member 0 sits at the supergrid's origin: alone on the non-member
    # kernels it steps bit for bit as in the ensemble
    alone_cfg = dataclasses.replace(member_cfg, solver="fused_pallas",
                                    advect_impl="pallas")
    alone = SimState(state0.velocity[0].clone(), state0.color[0].clone(), 0)
    alone_step = make_step(alone_cfg)
    for imps in sched:
        alone = alone_step(alone, Impulses(*(x[0] for x in imps)))
    same = (torch.equal(alone.velocity, st.velocity[0])
            and torch.equal(alone.color, st.color[0]))
    print(f"phase 14 member 0 stepped alone through make_step equals the "
          f"ensemble's: {same}")
    if not same:
        raise AssertionError("phase 14: member 0 differs from its run alone")

    # the tiled step_render on the supergrid config
    state_s = init_state(cfg_super, device=dev)
    render = make_step_render(cfg_super)
    imps_s = [scripted_swirl(cfg_super, t, device=dev) for t in range(steps)]
    torch.cuda.synchronize()
    counts = reset_counts()
    ss = state_s
    for imp in imps_s:
        ss, frame = render(ss, imp)
    torch.cuda.synchronize()
    nr = counts()
    want_r = {"K6 K2 advect_kernel member": 2 * steps,
              "K6 K2 advect_kernel overlay": steps,
              "K6 K1 project_fused member": steps,
              "K6 K2 stack": 0, "K6 K1 stack": 0,
              "K3 render_rgb565_kernel": 0}
    bad = {k: (nr[k], v) for k, v in want_r.items() if nr[k] != v}
    if bad:
        raise AssertionError(f"phase 14 step_render: launch counts (got, "
                             f"want) {bad}")
    if frame.dtype != torch.uint16 or tuple(frame.shape) != (h - 1, w - 1):
        raise AssertionError(f"phase 14: frame {frame.dtype} "
                             f"{tuple(frame.shape)}")
    ps = SimState(state_s.velocity.clone(), state_s.color.clone(), 0)
    for imp in imps_s:
        ps, pframe = plain_tiled_step(ps, cfg_super,
                                      impulse_overlay(imp, (h, w)),
                                      rgb565=True)
    same = (torch.equal(ps.velocity, ss.velocity)
            and torch.equal(ps.color, ss.color)
            and torch.equal(pframe.view(torch.int16), frame.view(torch.int16)))
    print(f"phase 14 tiled step_render {h}x{w} {steps} steps: launches "
          f"{ {k: nr[k] for k in want_r} }, frame {tuple(frame.shape)}; "
          f"plain path on the card bit-identical={same}")
    if not same:
        raise AssertionError("phase 14: the tiled step_render differs from "
                             "the plain path")
    return ({k: nc[k] for k in list(KERNELS) if k.startswith("K6")},
            member_cfg, state0, sched)


def phase5_config4_timing(dev, card, member_cfg, state0, sched):
    """Times of config 4: the whole-ensemble step beside the same step laid
    out on the supergrid and back (``supergrid_route``), the rollout's
    step, the tiled step_render, the step's split, and each K6 mode (K4's
    and K5's too) against its plain version, K1's and K2's on the member
    stack and on the supergrid; returns the K6 rows' work (the member
    stack's, the ensemble's path)."""
    from esp32_fluid_simulation_tpu_torch import (
        init_state, make_ensemble_multi_step, make_ensemble_step,
        make_step_render, stack_schedule, tiled_ensemble_config)
    from esp32_fluid_simulation_tpu_torch.io_host.touch import scripted_swirl
    from esp32_fluid_simulation_tpu_torch.models.stable_fluids import (
        _from_members, _to_members)
    from esp32_fluid_simulation_tpu_torch.ops.cuda.advect import (
        advect_kernel, advect_maccormack_kernel, advect_maccormack_reference,
        advect_reference, member_overlay, member_overlay_reference)
    from esp32_fluid_simulation_tpu_torch.ops.cuda.project import (
        project_fused, project_fused_reference)
    from esp32_fluid_simulation_tpu_torch.ops.cuda.sor import (
        sor_solve_kernel, sor_solve_reference)
    from esp32_fluid_simulation_tpu_torch.ops.fd import divergence

    n, steps = ENSEMBLE_N, len(sched)
    cfg_super, gh, gw = tiled_ensemble_config(member_cfg, n)
    h, w = cfg_super.shape
    m = member_cfg.shape
    res = {}
    box = {"st": state0, "t": 0}

    def ens_one():
        box["st"] = ens_step(box["st"], sched[box["t"] % steps])
        box["t"] += 1

    ens_step = make_ensemble_step(member_cfg)
    sbox = {"st": state0, "t": 0}
    super_step = supergrid_route(member_cfg, cfg_super, gh, gw)

    def super_one():
        sbox["st"] = super_step(sbox["st"], sched[sbox["t"] % steps])
        sbox["t"] += 1

    # in turns: stack, supergrid, supergrid, stack
    res["ensemble step"] = cuda_ms(ens_one, 10, warmup=2)
    res["ensemble step, supergrid route"] = cuda_ms(super_one, 10, warmup=2)
    res["ensemble step, supergrid route (2nd)"] = cuda_ms(super_one, 10)
    res["ensemble step (2nd)"] = cuda_ms(ens_one, 10)
    rollout = make_ensemble_multi_step(member_cfg)
    schedule = stack_schedule(sched)
    res["ensemble rollout step"] = cuda_ms(
        lambda: rollout(state0, schedule), 2, warmup=1) / steps
    render = make_step_render(cfg_super)
    imps_s = [scripted_swirl(cfg_super, t, device=dev) for t in range(8)]
    rbox = {"st": init_state(cfg_super, device=dev), "t": 0}

    def render_one():
        rbox["st"], _ = render(rbox["st"], imps_s[rbox["t"] % 8])
        rbox["t"] += 1

    res["tiled step_render"] = cuda_ms(render_one, 10, warmup=2)

    # the step's parts at the state the chain reached
    st = box["st"]
    imps = sched[0]
    vel = _from_members(st.velocity, h, w)
    color = _from_members(st.color, h, w)
    ov = member_overlay(imps, gh, gw, *m)
    md, dt = cfg_super.advect_max_disp, cfg_super.dt
    res["to supergrid (velocity + dye)"] = cuda_ms(
        lambda: (_from_members(st.velocity, h, w),
                 _from_members(st.color, h, w)), 10, warmup=2)
    res["from supergrid (velocity + dye)"] = cuda_ms(
        lambda: (_to_members(vel, *m), _to_members(color, *m)), 10, warmup=2)
    res["overlay build"], res["overlay build plain"] = time_pair(
        lambda: member_overlay(imps, gh, gw, *m),
        lambda: member_overlay_reference(imps, gh, gw, *m))
    res["K2 member+overlay"], res["K2 member+overlay plain"] = time_pair(
        lambda: advect_kernel(vel, vel, dt, True, md, self_advect=True,
                              member=m, overlay=ov),
        lambda: advect_reference(vel, vel, dt, True, md, member=m,
                                 overlay=ov))
    res["K2 member dye"], res["K2 member dye plain"] = time_pair(
        lambda: advect_kernel(color, vel, dt, False, md, clip01=True,
                              member=m),
        lambda: advect_reference(color, vel, dt, False, md, clip01=True,
                                 member=m))
    it, om, dx = cfg_super.sor_iters, cfg_super.omega, cfg_super.dx
    res["K1 member"], res["K1 member plain"] = time_pair(
        lambda: project_fused(vel, dx, it, om, member=m),
        lambda: project_fused_reference(vel, dx, it, om, member=m))
    # the same launches on the member stack, the ensemble's path
    vs, cs = st.velocity, st.color
    res["K2 stack+overlay"] = cuda_ms(
        lambda: advect_kernel(vs, None, dt, True, md, self_advect=True,
                              member=m, overlay=ov), 20, warmup=2)
    res["K2 stack dye"] = cuda_ms(
        lambda: advect_kernel(cs, vs, dt, False, md, clip01=True, member=m),
        20, warmup=2)
    res["K1 stack"] = cuda_ms(
        lambda: project_fused(vs, dx, it, om, member=m), 20, warmup=2)
    # K4's and K5's member= have no caller on any path: timed at config 4's
    # shapes for the kernel table only
    d = divergence(vel, dx)
    res["K4 member"], res["K4 member plain"] = time_pair(
        lambda: sor_solve_kernel(d, dx, it, om, member=m),
        lambda: sor_solve_reference(d, dx, it, om, member=m))
    for name, field, no_slip in (("K5 member velocity", vel, True),
                                 ("K5 member dye", color, False)):
        res[name], res[name + " plain"] = time_pair(
            lambda: advect_maccormack_kernel(field, vel, dt, no_slip, md,
                                             member=m),
            lambda: advect_maccormack_reference(field, vel, dt, no_slip, md,
                                                member=m))
        launches_per_call(f"K6 {name}", lambda: advect_maccormack_kernel(
            field, vel, dt, no_slip, md, member=m), 1)
    print(f"phase 5 timing of config 4 ({n} members of {m[0]}x{m[1]}, "
          f"{h}x{w} supergrid) on {card} (CUDA events, ms per call):")
    for k, v in res.items():
        print(f"  {k}: {v:.4f} ms")
    print(f"  member-steps/s: {1e3 * n / res['ensemble step']:.1f} "
          f"(ensemble step), {1e3 * n / res['ensemble rollout step']:.1f} "
          "(rollout)")

    cells = h * w
    # the kernel reads the overlay's flag channel at every cell and its
    # value channels only where the flag is set: this run's flagged cells
    flag = ov[-1]
    flagged = int((flag > 0).sum())
    ov_bytes = nbytes(flag) + (ov.shape[0] - 1) * flag.element_size() * flagged
    self_bytes = 2 * nbytes(vel) + ov_bytes             # ~20 B per cell
    dye_bytes = 2 * nbytes(color) + nbytes(vel)         # 32 B per cell
    # K4's and K5's member modes have no row of their own: their bounds at
    # config 4's shapes, for the kernel table (K5: the velocity is read once)
    k4_bound, _ = bound(2 * nbytes(d), cells * (1 + 8 * it))
    k5_bound, _ = bound(3 * nbytes(vel) + 2 * nbytes(color),
                        cells * ((40 + 2 * 25) + (40 + 3 * 25)))
    print(f"  bounds: K4 member {k4_bound:.4f} ms, K5 member velocity + dye "
          f"{k5_bound:.4f} ms; overlay flagged cells {flagged}")
    return {
        "K6 K2 advect_kernel member": (
            res["K2 stack+overlay"] + res["K2 stack dye"],
            res["K2 member+overlay plain"] + res["K2 member dye plain"],
            self_bytes + dye_bytes, cells * (49 + 60)),
        "K6 K2 advect_kernel overlay": (
            res["K2 stack+overlay"], res["K2 member+overlay plain"],
            self_bytes, cells * 49),
        "K6 K1 project_fused member": (
            res["K1 stack"], res["K1 member plain"],
            2 * nbytes(vel) + 4 * cells, cells * (13 + 8 * it)),
    }


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
    res.update(k1_design(vel, cfg, imp))
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


def device_kernels(fn):
    """Names of the device kernels one call of ``fn`` launches, from a
    profiler trace; None if the trace holds no device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    # the program's spans (spans.py) show on the device's timeline too, as
    # user annotations, and launch nothing
    names = [e.name for e in prof.events()
             if e.device_type == DeviceType.CUDA
             and not e.name.startswith(("Memcpy", "Memset"))
             and not getattr(e, "is_user_annotation", False)
             and not e.name.startswith("fluid.")]
    return names or None


def k1_design(vel, cfg, imp):
    """K1 at config 0's shapes: its device launches per call on both
    routes (a profiler count; the window route must launch once), its
    sequence route at iters 10 beside its window route, and the window
    route planned for other numbers of blocks (each checked against the
    plain version)."""
    from esp32_fluid_simulation_tpu_torch.ops.cuda import project
    it, om, dx = cfg.sor_iters, cfg.omega, cfg.dx
    res = {}

    def call(iters=it):
        return project.project_fused(vel, dx, iters, om, imp)

    seq_iters = project.WINDOW_MAX_ITERS + 1
    launches_per_call(f"K1 window route (iters {it})", call, 1)
    launches_per_call(f"K1 sequence route (iters {seq_iters})",
                      lambda: call(seq_iters), 2 * seq_iters + 2)
    limit = project.WINDOW_MAX_ITERS
    try:
        project.WINDOW_MAX_ITERS = -1
        res["K1 sequence route at iters 10"] = cuda_ms(call, 10, warmup=2)
    finally:
        project.WINDOW_MAX_ITERS = limit
    want_v, want_p = project.project_fused_reference(vel, dx, it, om, imp)
    planned = project.strip_blocks(vel.device, it)
    key = (vel.device.index, it <= 10)
    try:
        for blocks in (planned // 2, planned, 2 * planned):
            project.strip_blocks.cache[key] = blocks
            plan = project.strip_plan(*vel.shape[1:], it, blocks)
            got_v, got_p = call()
            if not (torch.equal(got_v, want_v) and torch.equal(got_p,
                                                               want_p)):
                raise AssertionError(f"phase 5: K1 planned for {blocks} "
                                     "blocks differs from its plain version")
            res[f"K1 window route, {plan[0]} strips x {plan[1]} segments"] \
                = cuda_ms(call, 20, warmup=2)
    finally:
        project.strip_blocks.cache[key] = planned
    return res


def launches_per_call(label, fn, want):
    """Print the device kernels one call of ``fn`` launches (a profiler
    count) and fail unless there are ``want``; None if the trace holds no
    device activity."""
    names = device_kernels(fn)
    if names is None:
        print(f"phase 5 {label}: device launches per call not measured (no "
              "device activity in the profiler trace)")
        return None
    print(f"phase 5 {label}: {len(names)} device launches per call "
          f"({sorted(set(names))})")
    if len(names) != want:
        raise AssertionError(f"phase 5: {label} launched {len(names)} "
                             f"kernels, not {want}")
    return len(names)


def sor_design(dev, card):
    """K4 and K9 at their main paths' shapes: device launches per call on
    every route and mode (a profiler count), K4's sequence route beside its
    window route, and K9's pass at other depths and tiles, whole grid and
    the sharded chain's chunk (each checked against its plain version)."""
    from esp32_fluid_simulation_tpu_torch.ops.cuda import sor, sor3d
    gen = torch.Generator(device=dev).manual_seed(97531)
    res = {}
    it, om = 10, 1.96
    d = torch.randn(PROD, generator=gen, device=dev)
    dpad = torch.nn.functional.pad(d, (2 * it,) * 4)
    block = dict(global_offset=(0, 0), global_shape=(8192, 8192),
                 halo=2 * it)
    seq = sor.WINDOW_MAX_ITERS + 1
    for label, fn, want in (
            ("K4 window route", lambda: sor.sor_solve_kernel(d, 1.0, it, om),
             1),
            ("K6 K4 member window route", lambda: sor.sor_solve_kernel(
                d, 1.0, it, om, member=(256, 256)), 1),
            ("K11 K4 block window route", lambda: sor.sor_solve_kernel(
                dpad, 1.0, it, om, **block), 1),
            (f"K4 sequence route (iters {seq})", lambda: sor.sor_solve_kernel(
                d, 1.0, seq, om), 2 * seq + 1)):
        launches_per_call(label, fn, want)
    limit = sor.WINDOW_MAX_ITERS
    try:
        sor.WINDOW_MAX_ITERS = -1
        res["K4 sequence route at iters 10"] = cuda_ms(
            lambda: sor.sor_solve_kernel(d, 1.0, it, om), 10, warmup=2)
    finally:
        sor.WINDOW_MAX_ITERS = limit
    res["K4 window route at iters 10"] = cuda_ms(
        lambda: sor.sor_solve_kernel(d, 1.0, it, om), 10, warmup=2)
    del d, dpad

    # K9: the smoke's solve and one shard's chunk of the sharded chain
    # (256 x 128 x 128 owned, a ring of 2*3 cells)
    d3 = torch.randn(SMOKE, generator=gen, device=dev)
    it3, om3, sweeps = 10, 1.5, 3
    g = 2 * sweeps
    blk = torch.randn((SMOKE[0], 128 + 2 * g, 128 + 2 * g), generator=gen,
                      device=dev)
    p0 = torch.randn(blk.shape, generator=gen, device=dev)
    chunk = dict(global_offset=(0, -g, -g), global_shape=SMOKE)
    want3 = sor3d.sor3d_reference(d3, 1.0, it3, om3)
    want_c = sor3d.sor3d_chunk_reference(blk, p0, 1.0, sweeps, om3,
                                         (0, -g, -g), SMOKE)
    sms = sor3d.sm_count(d3.device.index)
    plan3 = sor3d.pass_plan(SMOKE, 2 * it3, sms)
    plan_c = sor3d.pass_plan(tuple(blk.shape), 2 * sweeps, sms)
    for label, fn, want in (
            (f"K9 sor3d_solve (iters {it3}, plan {plan3})",
             lambda: sor3d.sor3d_solve(d3, 1.0, it3, om3), len(plan3[2])),
            (f"K11 K9 sor3d_chunk ({sweeps} sweeps, plan {plan_c})",
             lambda: sor3d.sor3d_chunk(blk, p0, 1.0, sweeps, om3, **chunk),
             len(plan_c[2])),
            ("K11 K9 sor3d_chunk (4 sweeps)",
             lambda: sor3d.sor3d_chunk(blk, p0, 1.0, 4, om3, **chunk),
             len(sor3d.pass_plan(tuple(blk.shape), 8, sms)[2]))):
        launches_per_call(label, fn, want)
    if len(plan_c[2]) != 1:
        raise AssertionError("phase 5: the sharded chain's chunk is no "
                             "longer one pass")
    saved = sor3d.pass_plan
    try:
        # the plan's own choice first, then other tiles, chunks of planes
        # and depths
        for tile, zc, deepest in (
                (None, None, 6), ((32, 32), 128, 6), ((20, 52), 64, 6),
                ((20, 52), 128, 4), ((24, 44), 128, 6), ((16, 32), 256, 6),
                ((20, 48), 32, 6), ((28, 32), 52, 6), ((16, 48), 64, 6)):
            if tile is None:
                sor3d.pass_plan = saved
                label = "the plan's tiles"
            else:
                def forced(shape, levels, sms, t=tile, z=zc, dp=deepest):
                    """The tile, planes and depths asked for, where a
                    block of them fits; else the plan's own."""
                    depths = sor3d.pass_depths(levels, dp)
                    if (sor3d.pass_threads(t, max(depths))
                            > sor3d.SOR3D_MAX_THREADS):
                        return saved(shape, levels, sms)
                    return t, z, depths

                sor3d.pass_plan = forced
                label = f"tile {tile[0]}x{tile[1]}, {zc} planes, depth <= " \
                        f"{deepest}"

            def solve():
                return sor3d.sor3d_solve(d3, 1.0, it3, om3)

            def chunked():
                return sor3d.sor3d_chunk(blk, p0, 1.0, sweeps, om3, **chunk)

            if not (torch.equal(solve(), want3)
                    and torch.equal(chunked(), want_c)):
                raise AssertionError(f"phase 5: K9 at {label} differs from "
                                     "its plain version")
            res[f"K9 at 256^3 "
                f"({sor3d.pass_plan(SMOKE, 2 * it3, sms)}), {label}"] = \
                cuda_ms(solve, 10, warmup=2)
            res[f"K9 chunk x4 (one shard's block x4, "
                f"{sor3d.pass_plan(tuple(blk.shape), 2 * sweeps, sms)}), "
                f"{label}"] = 4 * cuda_ms(chunked, 10, warmup=2)
    finally:
        sor3d.pass_plan = saved
    print(f"phase 5 K4 and K9 design on {card} (CUDA events, ms per call):")
    for k, v in res.items():
        print(f"  {k}: {v:.4f} ms")


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
    from esp32_fluid_simulation_tpu_torch.ops.cuda import advect
    from esp32_fluid_simulation_tpu_torch.ops.cuda.advect import (
        advect_maccormack_kernel, advect_maccormack_reference,
        maccormack_reach)
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
    calls = (("K5 velocity", vel, True), ("K5 dye", dye, False))
    for name, field, no_slip in calls:
        res[name], res[name + " plain"] = time_pair(
            lambda: advect_maccormack_kernel(field, vel, dt, no_slip, md),
            lambda: advect_maccormack_reference(field, vel, dt, no_slip, md))
        # the two-launch route (the parent's design) at the same shapes
        res[name + " two-launch route"] = cuda_ms(
            lambda: advect._launch_two(field, vel, dt, no_slip, md, None),
            20, warmup=2)
        launches_per_call(f"K5 {name[3:]} at config 3",
                          lambda: advect_maccormack_kernel(field, vel, dt,
                                                           no_slip, md), 1)
    # each tile's reach per axis (maccormack_reach of its velocities)
    th, tw = 32, 32   # csrc/advect.cu's tile
    h, w = vel.shape[1:]
    tiles = vel.reshape(2, h // th, th, w // tw, tw).permute(1, 3, 0, 2, 4)
    reach = torch.tensor([maccormack_reach(t, dt, md)
                          for t in tiles.reshape(-1, 2, th, tw).cpu()],
                         dtype=torch.float32)
    print(f"phase 5 K5 at config 3: reach per axis over the {len(reach)} "
          f"tiles of {th}x{tw}: mean {reach.mean(0).tolist()}, max "
          f"{reach.amax(0).tolist()} (max_disp {md})")
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


def plain_smoke_step(state, cfg, src, impulses=None):
    """The plume step through the kernels' plain versions (the same
    arithmetic in PyTorch ops) and the source and buoyancy as eager ops,
    draining ``impulses`` as ``smoke_step`` does, on any device."""
    from esp32_fluid_simulation_tpu_torch import SmokeState
    from esp32_fluid_simulation_tpu_torch.models.smoke3d import (
        inject_and_buoy)
    from esp32_fluid_simulation_tpu_torch.models.stable_fluids import (
        apply_impulses_)
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
    if impulses is not None:
        vel = apply_impulses_(vel, impulses)
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
    if any(n[k] != v for k, v in want.items()) or (
            n["K7 source launches"] != SMOKE_STEPS):
        raise AssertionError(f"phase 7: launch counts {n} for {SMOKE_STEPS} "
                             f"steps (want {want}, K7 source launches "
                             f"{SMOKE_STEPS})")
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
          f"renders: launches {want}, K7 with the source "
          f"{n['K7 source launches']}; finite, density in [{lo}, {hi}], "
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
    # each kernel, K7's source epilogue included, is bit-equal to its plain
    # version, so the trajectories and frames agree to the bit
    if not same or frame_eq != 1.0:
        raise AssertionError(f"phase 7: the kernel path differs from the "
                             f"plain path (max|dv| {dv}, max|drho| {dr}, "
                             f"frames agree on {frame_eq:.6f})")
    return {k: n[k] for k in want}, st


def phase5_smoke_timing(dev, cfg, state, card):
    from esp32_fluid_simulation_tpu_torch import make_smoke_step, render_smoke
    from esp32_fluid_simulation_tpu_torch.models.smoke3d import (
        plume_source, source_tensor)
    from esp32_fluid_simulation_tpu_torch.ops.cuda.advect3d import (
        advect3d_kernel, advect3d_reference, advect3d_source_kernel,
        advect3d_source_reference)
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
    # the step's scalar launch: the source and buoyancy as its epilogue,
    # the force written into a copy of the velocity (the plain version
    # stacks the pair and runs inject_and_buoy's eager ops)
    source = plume_source(cfg, src)
    vsrc = vel.clone()
    div = divergence3d(vel, dx)
    p = sor3d_solve(div, dx, cfg.sor_iters, cfg.omega)
    it, om = cfg.sor_iters, cfg.omega
    per_kernel = {
        "K7 velocity": (lambda: advect3d_kernel(vel, vel, dt, True, md),
                        lambda: advect3d_reference(vel, vel, dt, True, md)),
        "K7 scalars": (
            lambda: advect3d_source_kernel(pair[0], pair[1], vsrc, dt, False,
                                           source, md),
            lambda: advect3d_source_reference(pair[0], pair[1], vsrc, dt,
                                              False, source, md)),
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
    # the epilogue's bytes: axis 0 of the velocity stored, the mask read
    epilogue = nbytes(vel[0], src)
    return {
        "K7 advect3d_kernel": (
            res["K7 velocity"] + res["K7 scalars"],
            res["K7 velocity plain"] + res["K7 scalars plain"],
            3 * nbytes(vel) + 2 * nbytes(pair) + epilogue,
            n * ((34 + 3 * 19 + 17) + (34 + 2 * 19 + 13))),
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


def k10_times(dev, cfg, state, calls=K10_CALLS):
    """K10 at ``cfg.shape``: its device time (profiler) cold (a scratch of
    ``SCRATCH_BYTES`` written before each call: the volume comes from
    device memory, and L2 holds dirty lines, as after the step's kernels),
    cold with L2 clean (the scratch read before each call), and warm
    (calls back to back: it may sit in L2), bf16 and f32, and inside the
    main path, a chain of ``make_smoke_step`` + ``render_smoke`` from
    ``state``, ``calls`` calls each, all in one profiler trace; that
    chain's ms per step + frame (CUDA events); the wrapper's host us per
    call (1000 enqueues timed by the host's clock, one synchronise at the
    end).  A device time is None when the trace does not hold every K10
    launch."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from esp32_fluid_simulation_tpu_torch import make_smoke_step, render_smoke
    from esp32_fluid_simulation_tpu_torch.render.cuda_smoke import (
        render_smoke_mip_kernel)
    scratch = torch.zeros(SCRATCH_BYTES // 4, device=dev)
    runs = {}
    for dtype in (torch.bfloat16, torch.float32):
        rho = state.density.to(dtype)
        name = str(dtype)[6:]
        runs[f"K10 cold {name}, device us"] = (
            lambda rho=rho: (scratch.fill_(1.0),
                             render_smoke_mip_kernel(rho)))
        runs[f"K10 cold {name} L2 clean, device us"] = (
            lambda rho=rho: (torch.amax(scratch),
                             render_smoke_mip_kernel(rho)))
        runs[f"K10 warm {name}, device us"] = (
            lambda rho=rho: render_smoke_mip_kernel(rho))
    step = make_smoke_step(cfg)
    box = {"st": state}

    def frame():
        box["st"] = step(box["st"])
        render_smoke(box["st"].density)

    runs["K10 in step + frame, device us"] = frame
    for fn in runs.values():
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for fn in runs.values():
            for _ in range(calls):
                fn()
        torch.cuda.synchronize()
    us = [e.time_range.elapsed_us() for e in sorted(
        (e for e in prof.events() if e.device_type == DeviceType.CUDA
         and "smoke_mip" in e.name), key=lambda e: e.time_range.start)]
    whole = len(us) == calls * len(runs)
    if not whole:
        print(f"  K10 device times not measured: the trace holds {len(us)} "
              f"of its {calls * len(runs)} launches")
    res = {label: sum(us[k * calls:(k + 1) * calls]) / calls if whole
           else None for k, label in enumerate(runs)}
    del scratch
    res["smoke step + frame, ms"] = cuda_ms(frame, calls, warmup=2)
    rho = state.density
    render_smoke_mip_kernel(rho)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(1000):
        render_smoke_mip_kernel(rho)
    torch.cuda.synchronize()
    res["K10 host us per call (1000 enqueues)"] = (time.perf_counter()
                                                   - t0) * 1e3
    return res


def phase5_k10(dev, cfg, state, card, k10_calls):
    """K10's device launches per call at every phase 1b shape (one trace)
    and its device times (``k10_times``); returns the main path's device
    time in ms, or None."""
    from esp32_fluid_simulation_tpu_torch.render.cuda_smoke import (
        render_smoke_mip_kernel)
    names = device_kernels(lambda: [render_smoke_mip_kernel(x, True, vmax)
                                    for x, vmax in k10_calls])
    if names is None:
        print("phase 5 K10 device launches per call: not measured (no "
              "device activity in the profiler trace)")
    elif len(names) != len(k10_calls) or not all("smoke_mip" in n
                                                  for n in names):
        raise AssertionError(f"phase 5: {len(k10_calls)} K10 calls "
                             f"launched {len(names)} device kernels "
                             f"({sorted(set(names))})")
    else:
        print(f"phase 5 K10: 1 device launch per call at each of the "
              f"{len(k10_calls)} shapes of phase 1b")
    k10 = k10_times(dev, cfg, state)
    print(f"phase 5 K10 at {cfg.shape} on {card} (device times from the "
          "profiler, the chain's by CUDA events, the host's by its clock):")
    for k, v in k10.items():
        print(f"  {k}: " + ("not measured" if v is None else f"{v:.4f}"))
    main_us = k10["K10 in step + frame, device us"]
    return None if main_us is None else main_us / 1e3


def haloed(x, off, bshape, g):
    """The ``bshape`` block at ``off`` with ``g`` ghost cells per side, cut
    from the zero-padded field (what the halo exchange builds there)."""
    pad = torch.nn.functional.pad(x, (g, g, g, g))
    return pad[..., off[0]:off[0] + bshape[0] + 2 * g,
               off[1]:off[1] + bshape[1] + 2 * g].contiguous()


def phase15_block_kernels(dev):
    """K11: block mode of K1, K2 and K4 against the plain versions, on
    every 65x100 block of 130x200 and on two 4096^2 blocks of 8192^2.
    Returns the largest difference per summary row."""
    from esp32_fluid_simulation_tpu_torch import SimConfig, Impulses
    from esp32_fluid_simulation_tpu_torch.ops.cuda.advect import (
        advect_kernel, advect_reference)
    from esp32_fluid_simulation_tpu_torch.ops.cuda.modes import check_block
    from esp32_fluid_simulation_tpu_torch.ops.cuda.project import (
        project_fused, project_fused_reference)
    from esp32_fluid_simulation_tpu_torch.ops.cuda.sor import (
        sor_solve_kernel, sor_solve_reference)

    gen = torch.Generator(device=dev).manual_seed(1357)
    err = {}

    def check(name, label, got, want):
        err[name] = max(err.get(name, 0.0), compare(label, got, want))

    dt, md, it = 1.0 / 30.0, 12, 10
    for gshape, bshape, offsets in BLOCK_CASES:
        h, w = gshape
        print(f"phase 15 K11 block modes vs plain at {h}x{w}, blocks "
              f"{bshape[0]}x{bshape[1]}")
        # sigma 200 cells/s: |v|*dt > max_disp=12 on ~7% of the cells
        vel = 200.0 * torch.randn((2, h, w), generator=gen, device=dev)
        dye = (2.0 * torch.rand((3, h, w), generator=gen, device=dev)
               - 0.5).to(torch.bfloat16)
        d = torch.randn(gshape, generator=gen, device=dev)
        # a duplicated cell, an out-of-range position and one on the first
        # block's edge
        imp = Impulses.from_lists(
            SimConfig(shape=gshape),
            [(20, 30), (20, 30), (h // 2, w // 3), (h + 50, -3),
             (bshape[0], bshape[1] - 1)],
            [(90.0, -45.0), (33.0, 44.0), (-60.0, 120.0), (7.0, 8.0),
             (-20.0, 65.0)], device=dev)
        for off in offsets:
            kw = dict(global_offset=off, global_shape=gshape)

            def cut(x, g):
                """(haloed block, its modes.Block)."""
                return haloed(x, off, bshape, g), check_block(
                    "phase 15", off, gshape, g,
                    (bshape[0] + 2 * g, bshape[1] + 2 * g), 0, "")

            vown = haloed(vel, off, bshape, 0)
            for field, no_slip, clip01, minmax, label in (
                    (vel, True, False, True, "f32 velocity no_slip minmax"),
                    (dye, False, True, False, "bf16 dye clip01"),
                    (dye[0].contiguous(), False, False, True,
                     "bf16 1ch minmax")):
                fpad, blk = cut(field, md + 1)
                got = advect_kernel(fpad, vown, dt, no_slip, max_disp=md,
                                    clip01=clip01, return_minmax=minmax,
                                    halo=md + 1, **kw)
                want = advect_reference(fpad, vown, dt, no_slip, md,
                                        clip01=clip01, return_minmax=minmax,
                                        block=blk)
                if not minmax:
                    got, want = (got,), (want,)
                for g_, w_ in zip(got, want):
                    check("K11 K2 advect_kernel block",
                          f"K2 block {label} at {off}", g_, w_)
            # iters 0, 1 and 20 (the sequence route) and 65x40 members on
            # the small grid only
            small = h * w < 1 << 20
            for iters, member in ((it, None),) + (
                    ((0, None), (1, None), (20, None), (it, (65, 40)))
                    if small else ()):
                vpad, blk = cut(vel, 2 * iters + 2)
                for impulses in (imp, None):
                    label = (f"iters={iters} member={member} " + (
                        "impulses" if impulses is not None else "none"))
                    got = project_fused(vpad, 1.0, iters, 1.96,
                                        impulses=impulses, member=member,
                                        halo=2 * iters + 2, **kw)
                    want = project_fused_reference(vpad, 1.0, iters, 1.96,
                                                   impulses, member,
                                                   block=blk)
                    for g_, w_, part in zip(got, want,
                                            ("velocity", "pressure")):
                        check("K11 K1 project_fused block",
                              f"K1 block {part} ({label}) at {off}", g_, w_)
            for iters in ((it,) if h * w > 1 << 20 else (0, 1, it, 20)):
                # the halo: exactly 2*iters, and wider
                for g in {2 * iters, 2 * iters + 3}:
                    dpad, blk = cut(d, g)
                    check("K11 K4 sor_solve_kernel block",
                          f"K4 block iters={iters} halo={g} at {off}",
                          sor_solve_kernel(dpad, 1.0, iters, 1.96, halo=g,
                                           **kw),
                          sor_solve_reference(dpad, 1.0, iters, 1.96,
                                              block=blk))
        del vel, dye, d
    return err


def sharded_run(fn, state, imps):
    """``fn`` over ``imps`` from ``state``, the launch counters reset just
    before and read just after; returns (state, counts)."""
    torch.cuda.synchronize()
    counts = reset_counts()
    for imp in imps:
        state = fn(state, imp)
    torch.cuda.synchronize()
    return state, counts()


def check_counts(phase, n, want):
    bad = {k: (n[k], v) for k, v in want.items() if n[k] != v}
    if bad:
        raise AssertionError(f"phase {phase}: launch counts (got, want) "
                             f"{bad}")


def same_state(phase, label, got, want):
    """Print how far two states are apart; True when bit-identical."""
    dv = float((got.velocity - want.velocity).abs().max())
    dc = float((got.color.float() - want.color.float()).abs().max())
    eq = float((got.color == want.color).float().mean())
    same = (torch.equal(got.velocity, want.velocity)
            and torch.equal(got.color, want.color))
    print(f"phase {phase} {label}: max|dv|={dv:.3g} max|dc|={dc:.3g} dye "
          f"equal={100 * eq:.4f}% bit-identical={same}")
    return same


def stepped(fn, state, imps):
    for imp in imps:
        state = fn(state, imp)
    return state


def phase16_sharded_main_path(dev):
    """Config 5 at 8192^2 with config 0's kernel settings on a 2x2 mesh of
    the card.  Returns the K11 counts of the run, the config, the mesh,
    the first state and the sharded state after the run."""
    from esp32_fluid_simulation_tpu_torch import (SimConfig, SimState,
                                                  init_state, make_step)
    from esp32_fluid_simulation_tpu_torch.io_host.touch import scripted_swirl
    from esp32_fluid_simulation_tpu_torch.parallel import (
        make_mesh, make_sharded_step, shard_state, unshard_state)

    cfg5 = SimConfig.from_json(CONFIG5.read_text())
    cfg = dataclasses.replace(cfg5, solver="fused_pallas",
                              advect_impl="pallas")
    mesh = make_mesh([dev] * 4, grid_shape=MESH_2X2)
    steps = SHARDED_STEPS
    state0 = init_state(cfg, device=dev)
    imps = [scripted_swirl(cfg, t, device=dev) for t in range(steps)]
    sh, n = sharded_run(make_sharded_step(cfg, mesh),
                        shard_state(state0, cfg, mesh), imps)
    k11 = {k: n[k] for k in ("K11 K1 project_fused block",
                             "K11 K2 advect_kernel block")}
    check_counts(16, n, {"K11 K1 project_fused block": 4 * steps,
                         "K11 K2 advect_kernel block": 8 * steps,
                         "K1 project_fused": 4 * steps,
                         "K1 window route": 4 * steps,
                         "K1 sequence route": 0,
                         "K2 advect_kernel": 8 * steps,
                         "K11 K4 sor_solve_kernel block": 0,
                         "K5 advect_maccormack_kernel": 0})
    st = unshard_state(sh, dev)
    if not (torch.isfinite(st.velocity).all()
            and torch.isfinite(st.color.float()).all()):
        raise AssertionError("phase 16: non-finite state")
    lo, hi = float(st.color.min()), float(st.color.max())
    if lo < 0.0 or hi > 1.0 or st.step != steps:
        raise AssertionError(f"phase 16: dye in [{lo}, {hi}] at step "
                             f"{st.step}")
    print(f"phase 16 sharded main path {cfg.shape[0]}x{cfg.shape[1]} on a "
          f"{MESH_2X2[0]}x{MESH_2X2[1]} mesh of {dev}, {steps} steps of "
          f"make_sharded_step: launches {k11}; finite, dye in [{lo}, {hi}],"
          f" max |v| {float(st.velocity.norm(dim=0).max()):.4g}")
    ok = same_state(16, "vs the single-device make_step", st,
                    stepped(make_step(cfg), state0, imps))
    ps = SimState(state0.velocity.clone(), state0.color.clone(), 0)
    ok = same_state(16, "vs the plain path on the card", st, stepped(
        lambda s, i: plain_step(s, i, cfg), ps, imps)) and ok
    if not ok:
        raise AssertionError("phase 16: the sharded kernel route differs "
                             "from the single-device step")
    del st

    # config 5 as written: advect_impl "auto" is the eager route in the
    # sharded step; the single-device eager step is advect_impl "jnp"
    imps = imps[:SHARDED_EAGER_STEPS]
    eager, ne = sharded_run(make_sharded_step(cfg5, mesh), shard_state(
        init_state(cfg5, device=dev), cfg5, mesh), imps)
    check_counts(16, ne, {k: 0 for k in ne})
    got = unshard_state(eager, dev)
    cfg_e = dataclasses.replace(cfg5, advect_impl="jnp")
    want = stepped(make_step(cfg_e), init_state(cfg_e, device=dev), imps)
    same_state(16, f"config 5 as written (solver {cfg5.solver}, eager "
               f"advection), {len(imps)} steps vs the single-device eager "
               "step", got, want)
    # stated tolerance: the eager advection rebases coordinates into the
    # shard window (si - ox + k), which may round by one ulp, so the
    # velocity is held in units of the swirl's speed (300 cells/s) at rtol
    # 1e-5 / atol 1e-5, as the tests hold a self-advected velocity; the
    # bf16 dye lerps in bf16, where such a shift moves a cell by less than
    # one bf16 ulp of the dye's unit scale (atol 2^-8; 2^-14 seen on the
    # card, at cells of ~4e-4 on a shard edge)
    torch.testing.assert_close(got.velocity / SWIRL_SPEED,
                               want.velocity / SWIRL_SPEED, rtol=1e-5,
                               atol=1e-5)
    torch.testing.assert_close(got.color.float(), want.color.float(),
                               rtol=0, atol=2.0 ** -8)
    return k11, cfg, mesh, state0, sh


def phase17_sharded_routes(dev, mesh):
    """The other sharded routes on a 2x2 mesh of the card.  Returns K4
    block's count on the sor_pallas route, its config and the sharded state
    after it."""
    from esp32_fluid_simulation_tpu_torch import (
        Impulses, SimConfig, SimState, init_ensemble, init_state,
        make_ensemble_step, make_step, make_step_with_metrics, render_rgb565)
    from esp32_fluid_simulation_tpu_torch.io_host.touch import scripted_swirl
    from esp32_fluid_simulation_tpu_torch.parallel import (
        gather, make_sharded_ensemble_step, make_sharded_render,
        make_sharded_step, make_sharded_step_with_metrics, shard_state,
        unshard_state)

    steps = ROUTE_STEPS
    cfg0 = SimConfig.from_json(CONFIG0.read_text())
    cfg3 = SimConfig.from_json(CONFIG3.read_text())
    routes = (
        ("sor_pallas", dataclasses.replace(cfg0, solver="sor_pallas"),
         {"K11 K4 sor_solve_kernel block": 4 * steps,
          "K11 K2 advect_kernel block": 8 * steps,
          "K11 K1 project_fused block": 0}),
        ("MacCormack + kernel advection (config 3 with fused_pallas)",
         dataclasses.replace(cfg3, advect_impl="pallas",
                             solver="fused_pallas"),
         {"K11 K2 advect_kernel block": 16 * steps,
          "K11 K1 project_fused block": 4 * steps,
          "K5 advect_maccormack_kernel": 0}))
    k4 = None
    for label, cfg, want in routes:
        state0 = init_state(cfg, device=dev)
        imps = [scripted_swirl(cfg, t, device=dev) for t in range(steps)]
        sh, n = sharded_run(make_sharded_step(cfg, mesh),
                            shard_state(state0, cfg, mesh), imps)
        check_counts(17, n, want)
        if k4 is None:
            k4 = (n["K11 K4 sor_solve_kernel block"], cfg, sh)
        if not same_state(17, f"{label} {cfg.shape[0]}x{cfg.shape[1]} "
                          f"{steps} steps, launches "
                          f"{ {k: n[k] for k in want} }, vs the "
                          "single-device make_step",
                          unshard_state(sh, dev),
                          stepped(make_step(cfg), state0, imps)):
            raise AssertionError(f"phase 17: {label} differs from the "
                                 "single-device step")

    # metrics at 4096^2 on the kernel route
    imps = [scripted_swirl(cfg0, t, device=dev) for t in range(2)]
    st = init_state(cfg0, device=dev)
    sh = shard_state(st, cfg0, mesh)
    mfn = make_sharded_step_with_metrics(cfg0, mesh)
    for imp in imps:
        st, want = make_step_with_metrics(cfg0)(st, imp)
        sh, got = mfn(sh, imp)
    print("phase 17 make_sharded_step_with_metrics 4096^2: "
          + ", ".join(f"{k} {float(got[k]):.6g} (single {float(want[k]):.6g})"
                      for k in want))
    for key in ("div_pre_max", "div_post_max", "poisson_residual_l2",
                "max_speed"):
        # stated tolerance (test_sharded.py:204-205): the shards' sums and
        # maxima combine in another order
        np.testing.assert_allclose(float(got[key]), float(want[key]),
                                   rtol=1e-4, atol=1e-5)
    if not (bool(got["finite"]) and same_state(
            17, "metrics step vs single-device step_with_metrics",
            unshard_state(sh, dev), st)):
        raise AssertionError("phase 17: the sharded metrics step differs")

    # the sharded render at s=1 and s=4, every pixel
    color = unshard_state(sh, dev).color
    for s in (1, 4):
        cfg_s = dataclasses.replace(cfg0, scaling=s)
        got = gather(make_sharded_render(cfg_s, mesh)(sh.color), dev)
        want = render_rgb565(color, s=s)
        eq = float((got == want).float().mean())
        print(f"phase 17 make_sharded_render s={s}: frame "
              f"{tuple(got.shape)}, {100 * eq:.4f}% pixels equal")
        if got.shape != want.shape or eq != 1.0:
            raise AssertionError(f"phase 17: sharded render s={s} differs")

    # config 4 through the sharded ensemble step
    member_cfg = SimConfig.from_json(CONFIG4.read_text())
    n_mem = ENSEMBLE_N
    ens0 = init_ensemble(member_cfg, n_mem, device=dev)
    sched = config4_schedule(member_cfg, n_mem, steps, dev)
    fn, cfg_super = make_sharded_ensemble_step(member_cfg, mesh, n_mem)
    got = stepped(fn, ens0, sched)
    want = stepped(make_ensemble_step(member_cfg), ens0, sched)
    # each shard steps its members on a shard-local supergrid, as in JAX:
    # the backtrace coordinates of the members off shard (0, 0) are smaller
    # than on the whole supergrid and round otherwise (ROADMAP queue 3), so
    # the whole ensemble is not bit-identical; its difference is printed
    same_state(17, f"config 4 make_sharded_ensemble_step ({n_mem} members, "
               f"{steps} steps) vs make_ensemble_step", got, want)
    gh, gw = (n // m for n, m in zip(cfg_super.shape, member_cfg.shape))
    sx, sy = gh // MESH_2X2[0], gw // MESH_2X2[1]
    alone_step = make_ensemble_step(member_cfg)
    for a in range(MESH_2X2[0]):
        for b in range(MESH_2X2[1]):
            # shard (a, b)'s members, stepped alone through
            # make_ensemble_step: the same sx x sy supergrid, the same
            # coordinates, bit-identical
            idx = torch.tensor([(a * sx + r) * gw + b * sy + c
                                for r in range(sx) for c in range(sy)],
                               device=dev)
            alone = stepped(alone_step, SimState(
                ens0.velocity[idx], ens0.color[idx], ens0.step),
                [Impulses(*(x[idx] for x in imp)) for imp in sched])
            if not (torch.equal(got.velocity[idx], alone.velocity)
                    and torch.equal(got.color[idx], alone.color)):
                raise AssertionError(f"phase 17: shard ({a}, {b})'s members "
                                     "differ from their run alone")
            if (a, b) == (0, 0) and not (
                    torch.equal(got.velocity[idx], want.velocity[idx])
                    and torch.equal(got.color[idx], want.color[idx])):
                raise AssertionError("phase 17: shard (0, 0)'s members "
                                     "differ from the whole ensemble's")
    if not (torch.isfinite(got.velocity).all()
            and torch.isfinite(got.color).all()):
        raise AssertionError("phase 17: non-finite sharded ensemble")
    print(f"phase 17 config 4: each shard's {sx * sy} members bit-identical "
          f"to them stepped alone through make_ensemble_step ({sx}x{sy} "
          "supergrid); shard (0, 0)'s also to the whole ensemble's")
    return k4


def phase5_sharded_timing(dev, card, cfg, mesh, state0, sh, k4_path):
    """Times of the sharded main path at 8192^2 beside the single-device
    step, its split, and each block mode beside its whole-grid kernel at
    4096^2; returns the K11 rows' work per main-path step."""
    from esp32_fluid_simulation_tpu_torch import make_step
    from esp32_fluid_simulation_tpu_torch.io_host.touch import scripted_swirl
    from esp32_fluid_simulation_tpu_torch.ops.cuda.advect import (
        advect_kernel, advect_reference)
    from esp32_fluid_simulation_tpu_torch.ops.cuda.modes import check_block
    from esp32_fluid_simulation_tpu_torch.ops.cuda.project import (
        project_fused, project_fused_reference)
    from esp32_fluid_simulation_tpu_torch.ops.cuda.sor import (
        sor_solve_kernel, sor_solve_reference)
    from esp32_fluid_simulation_tpu_torch.ops.fd import divergence
    from esp32_fluid_simulation_tpu_torch.parallel import (make_sharded_step,
                                                           unshard_state)
    from esp32_fluid_simulation_tpu_torch.parallel.sharded import (
        Shards, _exchange2)

    imps = [scripted_swirl(cfg, t, device=dev) for t in range(8)]
    res = {}
    step = make_sharded_step(cfg, mesh)
    box = {"st": sh, "t": 0}

    def sharded_one():
        box["st"] = step(box["st"], imps[box["t"] % 8])
        box["t"] += 1

    one = make_step(cfg)
    sbox = {"st": state0, "t": 0}

    def single_one():
        sbox["st"] = one(sbox["st"], imps[sbox["t"] % 8])
        sbox["t"] += 1

    res["single-device step 8192^2"] = cuda_ms(single_one, 5, warmup=1)
    res["sharded step 8192^2 (2x2)"] = cuda_ms(sharded_one, 5, warmup=1)
    res["sharded step 8192^2 (2x2) again"] = cuda_ms(sharded_one, 5,
                                                     warmup=0)
    res["single-device step 8192^2 again"] = cuda_ms(single_one, 5,
                                                     warmup=0)

    # the split, at the state the chain reached
    st = box["st"]
    lay = Shards(mesh, cfg.shape)
    md, dt, it = cfg.advect_max_disp, cfg.dt, cfg.sor_iters
    k, g1 = md + 1, 2 * it + 2
    vpad13 = _exchange2(st.velocity, k)
    cpad13 = _exchange2(st.color, k)
    vpad22 = _exchange2(st.velocity, g1)
    cells = [(a, b) for a in range(lay.nx) for b in range(lay.ny)]

    def over(fn):
        return lambda: [fn(a, b) for a, b in cells]

    def kw(a, b, g):
        return dict(global_offset=lay.origin(a, b), global_shape=cfg.shape,
                    halo=g)

    def blk(a, b, g):
        return check_block("phase 5", lay.origin(a, b), cfg.shape, g,
                           (lay.lh + 2 * g, lay.lw + 2 * g), 0, "")

    vel_s, col_s = st.velocity, st.color
    res["exchange velocity k=13"] = cuda_ms(
        lambda: _exchange2(vel_s, k), 10, warmup=2)
    res["exchange dye k=13"] = cuda_ms(lambda: _exchange2(col_s, k), 10,
                                       warmup=2)
    res["exchange velocity 2*iters+2=22"] = cuda_ms(
        lambda: _exchange2(vel_s, g1), 10, warmup=2)
    res["K2 block velocity x4"], res["K2 block velocity x4 plain"] = (
        time_pair(over(lambda a, b: advect_kernel(
            vpad13[a][b], vel_s[a][b], dt, True, max_disp=md, **kw(a, b, k))),
            over(lambda a, b: advect_reference(
                vpad13[a][b], vel_s[a][b], dt, True, md,
                block=blk(a, b, k))), n_kern=5, n_plain=1))
    res["K2 block dye x4"], res["K2 block dye x4 plain"] = time_pair(
        over(lambda a, b: advect_kernel(
            cpad13[a][b], vel_s[a][b], dt, False, max_disp=md, clip01=True,
            **kw(a, b, k))),
        over(lambda a, b: advect_reference(
            cpad13[a][b], vel_s[a][b], dt, False, md, clip01=True,
            block=blk(a, b, k))), n_kern=5, n_plain=1)
    res["K1 block x4"], res["K1 block x4 plain"] = time_pair(
        over(lambda a, b: project_fused(vpad22[a][b], cfg.dx, it, cfg.omega,
                                        **kw(a, b, g1))),
        over(lambda a, b: project_fused_reference(
            vpad22[a][b], cfg.dx, it, cfg.omega, block=blk(a, b, g1))),
        n_kern=5, n_plain=1)

    # each block mode beside its whole-grid kernel at 4096^2: the owned
    # block (0, 0) alone
    v0 = vel_s[0][0]
    c0 = col_s[0][0]
    res["K1 4096^2 whole grid"] = cuda_ms(
        lambda: project_fused(v0, cfg.dx, it, cfg.omega), 10, warmup=2)
    res["K1 block 4096^2 (haloed 4140^2)"] = cuda_ms(
        lambda: project_fused(vpad22[0][0], cfg.dx, it, cfg.omega,
                              **kw(0, 0, g1)), 10, warmup=2)
    # a wider halo whose rows start on 128-byte lines (4160 floats): does
    # the 4140-float row pitch cost K1 block its time over K1?
    vpad32 = _exchange2(vel_s, 32)[0][0]
    res["K1 block 4096^2 (haloed 4160^2, aligned rows)"] = cuda_ms(
        lambda: project_fused(vpad32, cfg.dx, it, cfg.omega,
                              **kw(0, 0, 32)), 10, warmup=2)
    del vpad32
    res["K2 velocity 4096^2 whole grid"] = cuda_ms(
        lambda: advect_kernel(v0, v0, dt, True, md, self_advect=True), 10,
        warmup=2)
    res["K2 block velocity 4096^2"] = cuda_ms(
        lambda: advect_kernel(vpad13[0][0], v0, dt, True, max_disp=md,
                              **kw(0, 0, k)), 10, warmup=2)
    res["K2 dye 4096^2 whole grid"] = cuda_ms(
        lambda: advect_kernel(c0, v0, dt, False, md, clip01=True), 10,
        warmup=2)
    res["K2 block dye 4096^2"] = cuda_ms(
        lambda: advect_kernel(cpad13[0][0], v0, dt, False, max_disp=md,
                              clip01=True, **kw(0, 0, k)), 10, warmup=2)
    d0 = divergence(v0, cfg.dx)
    d0pad = torch.nn.functional.pad(d0, (2 * it,) * 4)
    res["K4 4096^2 whole grid"] = cuda_ms(
        lambda: sor_solve_kernel(d0, cfg.dx, it, cfg.omega), 10, warmup=2)
    res["K4 block 4096^2 (haloed 4116^2)"] = cuda_ms(
        lambda: sor_solve_kernel(d0pad, cfg.dx, it, cfg.omega,
                                 global_offset=(0, 0),
                                 global_shape=cfg.shape, halo=2 * it),
        10, warmup=2)

    # K4 block on its own route's shapes: sor_pallas at 4096^2 on 2x2
    _, cfg4k, sh4 = k4_path
    lay4 = Shards(mesh, cfg4k.shape)
    div4 = lay4.split(divergence(unshard_state(sh4, dev).velocity, cfg4k.dx))
    dpad4 = _exchange2(div4, 2 * it)
    cells4 = [(a, b) for a in range(lay4.nx) for b in range(lay4.ny)]

    def kw4(a, b):
        return dict(global_offset=lay4.origin(a, b),
                    global_shape=cfg4k.shape, halo=2 * it)

    res["K4 block x4 (sor_pallas 4096^2 on 2x2)"], \
        res["K4 block x4 plain"] = time_pair(
            lambda: [sor_solve_kernel(dpad4[a][b], cfg4k.dx, it,
                                      cfg4k.omega, **kw4(a, b))
                     for a, b in cells4],
            lambda: [sor_solve_reference(
                dpad4[a][b], cfg4k.dx, it, cfg4k.omega, block=check_block(
                    "phase 5", lay4.origin(a, b), cfg4k.shape, 2 * it,
                    dpad4[a][b].shape, 0, "")) for a, b in cells4],
            n_kern=5, n_plain=1)
    print(f"phase 5 timing of the sharded path on {card} (CUDA events, ms "
          "per call; x4 = the four shards' calls of one step):")
    for key, v in res.items():
        print(f"  {key}: {v:.4f} ms")
    parts = (res["K1 block x4"] + res["K2 block velocity x4"]
             + res["K2 block dye x4"] + res["exchange velocity k=13"]
             + res["exchange dye k=13"]
             + res["exchange velocity 2*iters+2=22"])
    print(f"  split of the sharded step: K1 block x4 {res['K1 block x4']:.4f}"
          f", K2 block x8 "
          f"{res['K2 block velocity x4'] + res['K2 block dye x4']:.4f}, "
          f"exchanges {parts - res['K1 block x4'] - res['K2 block velocity x4'] - res['K2 block dye x4']:.4f}"
          f" = {parts:.4f} of {res['sharded step 8192^2 (2x2)']:.4f} ms")

    def total(grid):
        return sum(nbytes(x) for row in grid for x in row)

    owned_v, owned_c = total(vel_s), total(col_s)
    haloed22 = sum(x[0].numel() for row in vpad22 for x in row)
    # K2 block: the velocity pass reads the velocity once (its haloed
    # copy holds the owned cells; the second, owned array the kernel also
    # reads is a cost of the two-array design, not of the function) and
    # writes the owned block; the dye pass reads the haloed dye and the
    # owned velocity and writes the owned dye
    k2_bytes = (total(vpad13) + owned_v) + (total(cpad13) + owned_v
                                            + owned_c)
    return {
        "K11 K1 project_fused block": (
            res["K1 block x4"], res["K1 block x4 plain"],
            total(vpad22) + owned_v + owned_v // 2,
            haloed22 * (13 + 8 * it)),
        "K11 K2 advect_kernel block": (
            res["K2 block velocity x4"] + res["K2 block dye x4"],
            res["K2 block velocity x4 plain"] + res["K2 block dye x4 plain"],
            k2_bytes,
            (owned_v // 8) * (49 + 60)),
        "K11 K4 sor_solve_kernel block": (
            res["K4 block x4 (sor_pallas 4096^2 on 2x2)"],
            res["K4 block x4 plain"],
            total(dpad4) + total(div4),
            sum(x.numel() for row in dpad4 for x in row) * (1 + 8 * it)),
    }


def phase15b_block_kernels3d(dev):
    """K11 for K7 and K9: block mode against the plain versions, on every
    65x100 block of (9, 130, 200) and on the corner block of 256^3 cut
    2x2 (K7 also in its self-advect mode).  Returns the largest difference
    per summary row."""
    from esp32_fluid_simulation_tpu_torch.ops.cuda.advect3d import (
        advect3d_kernel, advect3d_reference)
    from esp32_fluid_simulation_tpu_torch.ops.cuda.modes import check_block3d
    from esp32_fluid_simulation_tpu_torch.ops.cuda.sor3d import (
        sor3d_chunk, sor3d_chunk_reference)

    gen = torch.Generator(device=dev).manual_seed(2468)
    err = {}

    def check(name, label, got, want):
        err[name] = max(err.get(name, 0.0), compare(label, got, want))

    dt, md, sweeps = 1.0 / 30.0, 2, 3
    k = md + 1
    for gshape, bshape, offsets in BLOCK3_CASES:
        print(f"phase 15b K11 K7 and K9 block modes vs plain at {gshape}, "
              f"blocks {bshape[0]}x{bshape[1]}")
        # sigma 40 cells/s: |v|*dt > max_disp=2 on ~13% of the components
        vel = 40.0 * torch.randn((3,) + gshape, generator=gen, device=dev)
        pair = torch.rand((2,) + gshape, generator=gen,
                          device=dev).to(torch.bfloat16)
        d = torch.randn(gshape, generator=gen, device=dev)
        p = torch.randn(gshape, generator=gen, device=dev)
        whole_v = advect3d_kernel(vel, vel, dt, True, md)
        whole_s = advect3d_kernel(pair, vel, dt, False, md)
        for off in offsets:
            kw = dict(global_offset=off, global_shape=gshape, halo=k)
            vown = haloed(vel, off, bshape, 0)
            for field, no_slip, whole, label in (
                    (vel, True, whole_v, "f32 velocity no_slip"),
                    (pair, False, whole_s, "bf16 scalars"),
                    (pair[0], False, whole_s[0], "bf16 1 scalar")):
                fpad = haloed(field, off, bshape, k)
                blk = check_block3d("phase 15b", off, gshape, k, fpad.shape,
                                    0, "")
                got = advect3d_kernel(fpad, vown, dt, no_slip, md, **kw)
                check("K11 K7 advect3d_kernel block",
                      f"K7 block {label} at {off}", got,
                      advect3d_reference(fpad, vown, dt, no_slip, md, blk))
                check("K11 K7 advect3d_kernel block",
                      f"K7 block {label} at {off} vs whole-grid K7", got,
                      haloed(whole, off, bshape, 0))
            # the self-advect: the velocity read from the haloed field
            vpad = haloed(vel, off, bshape, k)
            blk = check_block3d("phase 15b", off, gshape, k, vpad.shape, 0,
                                "")
            got = advect3d_kernel(vpad, None, dt, True, md, **kw)
            check("K11 K7 advect3d_kernel block",
                  f"K7 block self-advect at {off}", got,
                  advect3d_reference(vpad, None, dt, True, md, blk))
            check("K11 K7 advect3d_kernel block",
                  f"K7 block self-advect at {off} vs whole-grid K7", got,
                  haloed(whole_v, off, bshape, 0))
            # the chain's chunk (one pass), its last chunk of 1 sweep and
            # a chunk deeper than one pass (two launches)
            for n in (sweeps, 1, 4):
                dpad = haloed(d, off, bshape, 2 * n)
                origin = (0, off[0] - 2 * n, off[1] - 2 * n)
                for p0, label in ((torch.zeros_like(dpad), "from zero"),
                                  (haloed(p, off, bshape, 2 * n),
                                   "from a given p")):
                    check("K11 K9 sor3d_chunk block",
                          f"K9 chunk of {n} sweeps {label} at {off}",
                          sor3d_chunk(dpad, p0, 1.0, n, 1.5,
                                      global_offset=origin,
                                      global_shape=gshape),
                          sor3d_chunk_reference(dpad, p0, 1.0, n, 1.5,
                                                origin, gshape))
        del vel, pair, d, p, whole_v, whole_s
    return err


def same_smoke(phase, label, got, want):
    """Print how far two smoke states are apart; True when bit-identical."""
    diffs = {name: float((getattr(got, name).float()
                          - getattr(want, name).float()).abs().max())
             for name in ("velocity", "density", "temperature")}
    same = all(torch.equal(getattr(got, n), getattr(want, n)) for n in diffs)
    print(f"phase {phase} {label}: "
          + " ".join(f"max|d{n[0]}|={v:.3g}" for n, v in diffs.items())
          + f" bit-identical={same}")
    return same


def smoke_stepped(fn, state, steps):
    for _ in range(steps):
        state = fn(state)
    return state


def phase18_sharded_smoke(dev, mesh):
    """Config 5's 3D half: the 256^3 plume with the kernel settings on the
    2x2 mesh of the card, against the single-device kernel step and the
    plain path; then the default ("auto": eager) plume against the
    single-device eager step.  Returns the K11 counts of the run, the
    config and the sharded state after it."""
    from esp32_fluid_simulation_tpu_torch import (SmokeConfig, SmokeState,
                                                  init_smoke, make_smoke_step)
    from esp32_fluid_simulation_tpu_torch.models.smoke3d import (
        source_tensor)
    from esp32_fluid_simulation_tpu_torch.parallel import (
        make_sharded_smoke_step, shard_smoke_state, unshard_smoke_state)

    cfg = SmokeConfig(shape=SMOKE, advect_impl="pallas", sor_impl="pallas")
    steps = SHARDED_SMOKE_STEPS
    state0 = init_smoke(cfg, device=dev)
    fn = make_sharded_smoke_step(cfg, mesh)
    sh = shard_smoke_state(state0, cfg, mesh)
    torch.cuda.synchronize()
    counts = reset_counts()
    sh = smoke_stepped(fn, sh, steps)
    torch.cuda.synchronize()
    n = counts()
    chunks = -(-cfg.sor_iters // min(cfg.sor_chunk, cfg.sor_iters))
    # K7 block: the velocity self-advect and the stacked density +
    # temperature, per shard and step
    want = {"K11 K7 advect3d_kernel block": 2 * 4 * steps,
            "K11 K9 sor3d_chunk block": 4 * chunks * steps}
    check_counts(18, n, dict(want, **{"K7 advect3d_kernel": 2 * 4 * steps,
                                      "K8 divergence3d": 0,
                                      "K8 subtract_gradient3d": 0,
                                      "K9 sor3d_solve": 0}))
    st = unshard_smoke_state(sh, dev)
    for name in ("velocity", "density", "temperature"):
        if not torch.isfinite(getattr(st, name).float()).all():
            raise AssertionError(f"phase 18: non-finite {name}")
    rho = st.density.float()
    lo, hi = float(rho.min()), float(rho.max())
    w_up = float((st.velocity[0] * rho).sum())
    if lo < 0.0 or hi > 1.0 or hi < 0.05 or not w_up < 0.0 \
            or st.step != steps:
        raise AssertionError(f"phase 18: density in [{lo}, {hi}], sum "
                             f"v0*rho {w_up}, step {st.step}")
    print(f"phase 18 sharded smoke {cfg.shape} on a {MESH_2X2[0]}x"
          f"{MESH_2X2[1]} mesh of {dev}, {steps} steps of "
          f"make_sharded_smoke_step: launches {want}; finite, density in "
          f"[{lo}, {hi}], sum v0*rho {w_up:.4g} (< 0: rising)")
    single = smoke_stepped(make_smoke_step(cfg), state0, steps)
    src = source_tensor(cfg, dev)
    plain = smoke_stepped(lambda s: plain_smoke_step(s, cfg, src), SmokeState(
        state0.velocity.clone(), state0.density.clone(),
        state0.temperature.clone(), 0), steps)
    for label, ref in (("vs the single-device make_smoke_step", single),
                       ("vs the plain path on the card", plain)):
        same_smoke(18, label, st, ref)
        # stated tolerance, as phase 7's: every kernel of both paths is
        # bit-equal to its plain version and the sharded stencils are the
        # eager ops K8 matches, so the states agree to the bit up to
        # float32 noise
        torch.testing.assert_close(st.velocity, ref.velocity, rtol=1e-5,
                                   atol=1e-5)
        for a, b in ((st.density, ref.density),
                     (st.temperature, ref.temperature)):
            torch.testing.assert_close(a.float(), b.float(), rtol=0,
                                       atol=2.0 ** -8)
    del single, plain, st

    # the default config: advect_impl and sor_impl "auto" are the eager
    # routes in the sharded step; the single-device eager step is "jnp"
    cfg_a = SmokeConfig(shape=SMOKE)
    eager = smoke_stepped(make_sharded_smoke_step(cfg_a, mesh),
                          shard_smoke_state(init_smoke(cfg_a, device=dev),
                                            cfg_a, mesh), 2)
    got = unshard_smoke_state(eager, dev)
    cfg_e = dataclasses.replace(cfg_a, advect_impl="jnp", sor_impl="jnp")
    ref = smoke_stepped(make_smoke_step(cfg_e), init_smoke(cfg_e, device=dev),
                        2)
    same_smoke(18, "default SmokeConfig (eager route), 2 steps vs the "
               "single-device eager step", got, ref)
    # stated tolerance (test_sharded_smoke.py:124-129): the bf16 scalars'
    # rounding drives the buoyancy
    torch.testing.assert_close(got.velocity, ref.velocity, rtol=1e-3,
                               atol=2e-3)
    torch.testing.assert_close(got.density.float(), ref.density.float(),
                               rtol=0.02, atol=4e-3)
    return {k: n[k] for k in want}, cfg, sh


def dyebed3d_impulses(cfg, dev):
    """Four drags in the dye bed's interior."""
    from esp32_fluid_simulation_tpu_torch import Impulses
    d, h, w = cfg.shape
    return Impulses.from_lists(
        cfg, [(d // 2, h // 3, w // 3), (d // 4, h // 2, 2 * w // 3),
              (3 * d // 4, 2 * h // 3, w // 2), (d // 2, h // 2, w // 2)],
        [(40.0, 90.0, -45.0), (-30.0, -60.0, 120.0), (20.0, 150.0, 60.0),
         (-50.0, 30.0, -90.0)], device=dev)


def phase19_dyebed3d(dev, mesh):
    """The 3D dye bed on the 2x2 mesh: the kernel route against the sharded
    eager route, and the K9 block chain against the whole-grid solve.
    Returns the kernel config and its sharded state."""
    from esp32_fluid_simulation_tpu_torch import (Impulses, SimConfig,
                                                  init_state)
    from esp32_fluid_simulation_tpu_torch.ops.cuda.sor3d import (
        sor3d_reference, sor3d_solve)
    from esp32_fluid_simulation_tpu_torch.parallel import (
        gather, make_sharded_step, shard_state, unshard_state)
    from esp32_fluid_simulation_tpu_torch.parallel.sharded import Shards
    from esp32_fluid_simulation_tpu_torch.parallel.sharded3d import (
        Stencils3D)

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kcfg = SimConfig(shape=DYEBED3, advect_impl="pallas",
                     solver="sor_pallas")
    ecfg = dataclasses.replace(kcfg, advect_impl="jnp", solver="sor")
    steps = DYEBED3_STEPS
    imps = ([dyebed3d_impulses(kcfg, dev)]
            + [Impulses.none(kcfg, device=dev)] * (steps - 1))
    state0 = init_state(kcfg, device=dev)
    sk, nk = sharded_run(make_sharded_step(kcfg, mesh),
                         shard_state(state0, kcfg, mesh), imps)
    chunks = -(-kcfg.sor_iters // 3)
    check_counts(19, nk, {"K11 K7 advect3d_kernel block": 2 * 4 * steps,
                          "K11 K9 sor3d_chunk block": 4 * chunks * steps,
                          "K11 K4 sor_solve_kernel block": 0})
    peak_k = torch.cuda.max_memory_allocated()
    se, ne = sharded_run(make_sharded_step(ecfg, mesh),
                         shard_state(state0, ecfg, mesh), imps)
    check_counts(19, ne, {k: 0 for k in ne})
    print(f"phase 19 peak device memory: kernel route "
          f"{peak_k / 2 ** 30:.2f} GiB, with the eager route "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    got, want = unshard_state(sk, dev), unshard_state(se, dev)
    vmax = float(want.velocity.abs().max())
    same_state(19, f"3D dye bed {kcfg.shape} {steps} steps, kernel route "
               f"(launches K7 block {nk['K11 K7 advect3d_kernel block']}, "
               f"K9 block {nk['K11 K9 sor3d_chunk block']}; max |v| of the "
               f"eager route {vmax:.4g}) vs the sharded eager route", got, want)
    # stated tolerance (test_sharded3d.py:154-159, rtol 1e-4 / atol 1e-4):
    # the eager advection rebases its coordinates into the shard window and
    # lerps in another order than K7, and a one-ulp coordinate shift can
    # move a stencil by a node, so the velocity is held in units of the
    # eager state's own max |v|: atol 1e-4 * max |v|, which a bf16 route
    # (2^-8 relative) would miss
    torch.testing.assert_close(got.velocity / vmax, want.velocity / vmax,
                               rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(got.color, want.color, rtol=1e-4, atol=1e-4)
    if not (vmax > 1.0 and torch.isfinite(got.color).all()):
        raise AssertionError(f"phase 19: max |v| {vmax}")
    del got, want, se

    # the K9 block chain's pressure on this state's divergence
    ops = Stencils3D(Shards(mesh, kcfg.shape), kcfg.dx)
    div = ops.divergence(sk.velocity)
    p = gather(ops.sor_kernel(div, kcfg.sor_iters, kcfg.omega), dev)
    dg = gather(div, dev)
    for label, fn in (("sor_solve of the gathered divergence",
                       sor3d_reference), ("whole-grid K9", sor3d_solve)):
        compare(f"phase 19 K9 block chain pressure vs {label}", p,
                fn(dg, kcfg.dx, kcfg.sor_iters, kcfg.omega))
    del p, dg, div
    return kcfg, sk


def phase5_sharded3d_timing(dev, card, cfg, mesh, sh, cfg19, sh19):
    """Times of the sharded 256^3 smoke step beside the single-device one,
    its split, and the 3D dye-bed step on both routes; returns the K11 K7
    and K9 rows' work per smoke step."""
    from esp32_fluid_simulation_tpu_torch import (init_smoke,
                                                  make_smoke_step)
    from esp32_fluid_simulation_tpu_torch.ops.cuda.advect3d import (
        advect3d_kernel, advect3d_reference)
    from esp32_fluid_simulation_tpu_torch.ops.cuda.modes import check_block3d
    from esp32_fluid_simulation_tpu_torch.ops.cuda.sor3d import (
        sor3d_chunk, sor3d_chunk_reference)
    from esp32_fluid_simulation_tpu_torch.parallel import (
        make_sharded_smoke_step, make_sharded_step)
    from esp32_fluid_simulation_tpu_torch.parallel.sharded import (
        Shards, _exchange2)
    from esp32_fluid_simulation_tpu_torch.parallel.sharded3d import (
        Stencils3D)

    res = {}
    sbox = {"st": sh}
    step = make_sharded_smoke_step(cfg, mesh)

    def sharded_one():
        sbox["st"] = step(sbox["st"])

    one = make_smoke_step(cfg)
    box = {"st": smoke_stepped(one, init_smoke(cfg, device=dev),
                               SHARDED_SMOKE_STEPS)}

    def single_one():
        box["st"] = one(box["st"])

    res["single-device smoke step 256^3"] = cuda_ms(single_one, 10, warmup=2)
    res["sharded smoke step 256^3 (2x2)"] = cuda_ms(sharded_one, 10,
                                                    warmup=2)
    res["sharded smoke step 256^3 (2x2) again"] = cuda_ms(sharded_one, 10,
                                                          warmup=0)
    res["single-device smoke step 256^3 again"] = cuda_ms(single_one, 10,
                                                          warmup=0)

    # the split, at the state the chain reached
    st = sbox["st"]
    lay = Shards(mesh, cfg.shape)
    ops = Stencils3D(lay, cfg.dx)
    md, dt, it, om = cfg.advect_max_disp, cfg.dt, cfg.sor_iters, cfg.omega
    ck = min(cfg.sor_chunk, it)
    k, g = md + 1, 2 * ck
    vel, rho, temp = st.velocity, st.density, st.temperature
    cells = [(a, b) for a in range(lay.nx) for b in range(lay.ny)]

    def stacked():
        return lay.map(lambda a, b, r, t: torch.stack([r, t]), rho, temp)

    vpad, rpad, tpad, ppad = (_exchange2(x, k)
                              for x in (vel, rho, temp, stacked()))

    def k7(pads, no_slip, self_advect=False, plain=False):
        """K7 block on each shard's block of each of ``pads``; the
        self-advect reads the velocity from the pad."""
        def run():
            for pad in pads:
                for a, b in cells:
                    f = pad[a][b]
                    v = None if self_advect else vel[a][b]
                    if plain:
                        advect3d_reference(f, v, dt, no_slip, md, check_block3d(
                            "phase 5", lay.origin(a, b), cfg.shape, k,
                            f.shape, 0, ""))
                    else:
                        advect3d_kernel(f, v, dt, no_slip, md,
                                        global_offset=lay.origin(a, b),
                                        global_shape=cfg.shape, halo=k)
        return run

    res["exchange velocity k=3"] = cuda_ms(lambda: _exchange2(vel, k), 10,
                                           warmup=2)
    res["stack + exchange density + temperature k=3"] = cuda_ms(
        lambda: _exchange2(stacked(), k), 10, warmup=2)
    res["K7 block velocity x4"], res["K7 block velocity x4 plain"] = \
        time_pair(k7([vpad], True, True), k7([vpad], True, True, True), 10,
                  1)
    res["K7 block scalar pair x4"], res["K7 block scalar pair x4 plain"] = \
        time_pair(k7([ppad], False), k7([ppad], False, plain=True), 10, 1)
    # the parent's route: the owned velocity as a second input, and the
    # scalars apart, each with its own exchange
    res["K7 block x12 (owned velocity, scalars apart)"] = cuda_ms(
        lambda: (k7([vpad], True)(), k7([rpad, tpad], False)()), 10,
        warmup=2)
    res["exchange density, temperature apart k=3"] = cuda_ms(
        lambda: (_exchange2(rho, k), _exchange2(temp, k)), 10, warmup=2)
    div = ops.divergence(vel)
    res["divergence (its exchanges + eager stencil)"] = cuda_ms(
        lambda: ops.divergence(vel), 10, warmup=2)
    dg = _exchange2(div, g)
    res["exchange divergence 2*chunk=6"] = cuda_ms(lambda: _exchange2(div, g),
                                                   10, warmup=2)
    sweeps = [min(ck, it - done) for done in range(0, it, ck)]
    p0 = [[torch.zeros_like(x) for x in row] for row in dg]

    def origin(a, b):
        ox, oy = lay.origin(a, b)
        return (0, ox - g, oy - g)

    def k9(plain=False):
        def run():
            for kk in sweeps:
                for a, b in cells:
                    if plain:
                        sor3d_chunk_reference(dg[a][b], p0[a][b], cfg.dx, kk,
                                              om, origin(a, b), cfg.shape)
                    else:
                        sor3d_chunk(dg[a][b], p0[a][b], cfg.dx, kk, om,
                                    global_offset=origin(a, b),
                                    global_shape=cfg.shape)
        return run

    k9x = f"K9 block x{len(sweeps) * len(cells)}"
    res[k9x], res[k9x + " plain"] = time_pair(k9(), k9(True), 10, 1)
    res["K9 block chain (its exchanges included)"] = cuda_ms(
        lambda: ops.sor_kernel(div, it, om, ck), 10, warmup=2)
    p = ops.sor_kernel(div, it, om, ck)
    res["gradient subtract (its exchanges + eager stencil)"] = cuda_ms(
        lambda: ops.subtract_gradient(vel, p), 10, warmup=2)

    # the 3D dye bed on both routes, from phase 19's state
    imp = dyebed3d_impulses(cfg19, dev)
    for label, c in (("kernel", cfg19), ("eager", dataclasses.replace(
            cfg19, advect_impl="jnp", solver="sor"))):
        fn = make_sharded_step(c, mesh)
        dbox = {"st": sh19}

        def dye_one():
            dbox["st"] = fn(dbox["st"], imp)
        res[f"3D dye bed {cfg19.shape} step on 2x2, {label} route"] = \
            cuda_ms(dye_one, 3, warmup=1)

    print(f"phase 5 timing of the sharded 3D paths on {card} (CUDA events, "
          "ms per call; x4 = the four shards' calls of one step):")
    for key, v in res.items():
        print(f"  {key}: {v:.4f} ms")
    k7_ms = res["K7 block velocity x4"] + res["K7 block scalar pair x4"]
    parts = {"K7 block x8": k7_ms,
             "K9 block chain (exchanges included)":
                 res["K9 block chain (its exchanges included)"],
             "advection exchanges": res["exchange velocity k=3"]
             + res["stack + exchange density + temperature k=3"],
             "divergence": res["divergence (its exchanges + eager stencil)"],
             "gradient subtract":
                 res["gradient subtract (its exchanges + eager stencil)"]}
    total = res["sharded smoke step 256^3 (2x2)"]
    print("  split of the sharded smoke step: " + ", ".join(
        f"{key} {v:.4f}" for key, v in parts.items())
        + f"; the rest (source, buoyancy, layout) "
        f"{total - sum(parts.values()):.4f} of {total:.4f} ms; the K9 block "
        f"launches alone {res[k9x]:.4f}")

    def tot(grid):
        return sum(nbytes(x) for row in grid for x in row)

    n = sum(x[0].numel() for row in vel for x in row)
    # K7 block, counted as the single-device K7 row counts its work: the
    # velocity pass reads the velocity once (its haloed copy) and writes
    # the owned block; the scalar pair reads its haloed blocks and the
    # owned velocity, with one backtrace, and writes its owned blocks
    k7_bytes = (tot(vpad) + tot(vel)) + tot(vel) \
        + (tot(ppad) + tot(rho) + tot(temp))
    haloed_cells = sum(x.numel() for row in dg for x in row)
    return {
        "K11 K7 advect3d_kernel block": (
            k7_ms, res["K7 block velocity x4 plain"]
            + res["K7 block scalar pair x4 plain"], k7_bytes,
            n * ((34 + 3 * 19 + 17) + (34 + 2 * 19))),
        # each chunk call reads the haloed d and p and writes the haloed p
        "K11 K9 sor3d_chunk block": (
            res[k9x], res[k9x + " plain"], 3 * len(sweeps) * tot(dg),
            haloed_cells * 11 * it),
    }


def read_ppm(path):
    """A binary PPM as ``[H, W, 3]`` uint8."""
    data = Path(path).read_bytes()
    magic, w, h, maxval, rest = data.split(maxsplit=4)
    if magic != b"P6" or maxval != b"255":
        raise AssertionError(f"{path}: not a P6 PPM of 8-bit channels")
    return np.frombuffer(rest, np.uint8).reshape(int(h), int(w), 3)


def host_line(label, host_ms, device_ms, card):
    """One host-loop rate beside its step chain's CUDA-event time."""
    print(f"host loop {label}: {host_ms:.4f} ms a step "
          f"({1e3 / host_ms:.2f} a second) on {card}; the same entry point "
          f"chained, CUDA events: {device_ms:.4f} ms; the loop's host "
          f"share {100 * max(0.0, 1 - device_ms / host_ms):.1f}%")


def swirl_chain_ms(fn, cfg, state, dev, n=20):
    """CUDA-event ms a call of ``fn(state, scripted_swirl(cfg, t))``
    chained, with its impulse upload, as the host loops call it."""
    from esp32_fluid_simulation_tpu_torch.io_host.touch import scripted_swirl
    box = {"st": state, "t": 0}

    def one():
        out = fn(box["st"], scripted_swirl(cfg, box["t"], device=dev))
        # a state, or (state, frame)
        box["st"] = out[0] if isinstance(out[0], tuple) else out
        box["t"] += 1
    return cuda_ms(one, n, warmup=2)


def phase20_run_main(dev, card):
    """``run.main`` at config 0: checkpoints, resume, frame, metrics; the
    guarded step.  Returns the K1 and K2 launches of its runs."""
    import tempfile
    from esp32_fluid_simulation_tpu_torch import (SimConfig, init_state,
                                                  make_step, render_rgb8)
    from esp32_fluid_simulation_tpu_torch import run as run_cli
    from esp32_fluid_simulation_tpu_torch.io_host.touch import scripted_swirl
    from esp32_fluid_simulation_tpu_torch.utils import (load_checkpoint,
                                                        make_guarded_step)

    cfg = SimConfig.from_json(CONFIG0.read_text())
    common = ["--config", str(CONFIG0), "--device", str(dev)]
    guard = make_guarded_step(cfg)
    center = (cfg.shape[0] // 2, cfg.shape[1] // 2)
    with tempfile.TemporaryDirectory() as tmp:
        ck, ck2 = f"{tmp}/ckpt.npz", f"{tmp}/resumed.npz"
        ppm, mpath = f"{tmp}/final.ppm", f"{tmp}/metrics.jsonl"
        counts = reset_counts()
        run_cli.main(common + ["--steps", str(RUN_STEPS), "--checkpoint", ck,
                               "--checkpoint-every", str(RUN_CKPT_EVERY)])
        run_cli.main(["--resume", ck, "--steps", str(RESUME_STEPS),
                      "--device", str(dev), "--checkpoint", ck2,
                      "--checkpoint-every", str(RESUME_STEPS),
                      "--frame", ppm])
        run_cli.main(common + ["--steps", str(RUN_METRIC_STEPS), "--metrics",
                               mpath, "--metrics-every", "1"])
        salted = init_state(cfg, device=dev)
        salted.velocity[(0,) + center] = float("nan")
        out, was_reset = guard(salted, scripted_swirl(cfg, 0, device=dev))
        torch.cuda.synchronize()
        n = counts()
        steps = RUN_STEPS + RESUME_STEPS + RUN_METRIC_STEPS + 1
        if n["K1 project_fused"] != steps or \
                n["K2 advect_kernel"] != 2 * steps:
            raise AssertionError(f"phase 20: launch counts {n} for {steps} "
                                 "steps (want K1 = steps, K2 = 2 * steps)")
        resumed, rcfg = load_checkpoint(ck2, device=dev)
        frame = torch.from_numpy(read_ppm(ppm).copy())
        rows = [json.loads(line) for line in open(mpath)]

    # the same schedule stepped without a break
    want = init_state(cfg, device=dev)
    step = make_step(cfg)
    for t in range(RUN_STEPS + RESUME_STEPS):
        want = step(want, scripted_swirl(cfg, t, device=dev))
    same = (rcfg == cfg and resumed.step == want.step
            and resumed.color.dtype == torch.bfloat16
            and torch.equal(resumed.velocity, want.velocity)
            and torch.equal(resumed.color, want.color))
    print(f"phase 20 run.main at {cfg.shape[0]}x{cfg.shape[1]}: "
          f"{RUN_STEPS} steps with a checkpoint every {RUN_CKPT_EVERY}, "
          f"--resume for {RESUME_STEPS}: launches K1 "
          f"{n['K1 project_fused']}, K2 {n['K2 advect_kernel']}; the resumed "
          f"state ({resumed.color.dtype} dye) bit-equal to "
          f"{RUN_STEPS + RESUME_STEPS} make_step steps: {same}")
    if not same:
        raise AssertionError("phase 20: the resumed run differs from the "
                             "uninterrupted one")
    rgb = render_rgb8(want.color, s=cfg.scaling).permute(1, 2, 0).cpu()
    if not torch.equal(frame, rgb):
        raise AssertionError("phase 20: the PPM is not render_rgb8 of the "
                             "final dye")
    keys = ("div_pre_max", "div_post_max", "poisson_residual_l2",
            "max_speed")
    bad = [r for r in rows if not r["finite"]
           or not all(np.isfinite(r[k]) for k in keys)
           or r["div_post_max"] > r["div_pre_max"]]
    if len(rows) != RUN_METRIC_STEPS or bad:
        raise AssertionError(f"phase 20: metrics rows {len(rows)}, "
                             f"failing {bad}")
    print(f"phase 20 --metrics: {len(rows)} rows finite, div_post_max <= "
          f"div_pre_max; last " + ", ".join(
              f"{k} {rows[-1][k]:.4g}" for k in keys))
    fresh = init_state(cfg, device=dev)
    reset_ok = (bool(was_reset) and torch.equal(out.velocity, fresh.velocity)
                and torch.equal(out.color, fresh.color))
    normal, kept = guard(fresh, scripted_swirl(cfg, 0, device=dev))
    plain = step(fresh, scripted_swirl(cfg, 0, device=dev))
    keep_ok = (not bool(kept) and torch.equal(normal.velocity, plain.velocity)
               and torch.equal(normal.color, plain.color))
    print(f"phase 20 guarded step: NaN-salted state reset to the fresh one: "
          f"{reset_ok}; a finite step kept, equal to make_step's: {keep_ok}")
    if not (reset_ok and keep_ok):
        raise AssertionError("phase 20: the guarded step failed")

    # the loop's steady rate: runs of two lengths differenced, so the
    # set-up (init_state's host-built dye), the final sync and the JSON
    # line cancel; the least of three runs of each length
    walls = {steps_n: [] for steps_n in RUN_TIME_STEPS}
    for _ in range(3):
        for steps_n in RUN_TIME_STEPS:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run_cli.main(common + ["--steps", str(steps_n)])
            walls[steps_n].append(time.perf_counter() - t0)
    a, b = RUN_TIME_STEPS
    print(f"phase 20 run.main walls (s): {a} steps {walls[a]}, {b} steps "
          f"{walls[b]}")
    walls = {k: min(v) for k, v in walls.items()}
    host_ms = 1e3 * (walls[b] - walls[a]) / (b - a)
    host_line("run.main (make_step, scripted_swirl)", host_ms,
              swirl_chain_ms(step, cfg, fresh, dev), card)
    return {"K1 project_fused": n["K1 project_fused"],
            "K2 advect_kernel": n["K2 advect_kernel"]}


def phase21_pipeline(dev, card):
    """``SimPipeline`` at config 0: every frame delivered and bit-equal to
    a serial replay of the drained drags."""
    from esp32_fluid_simulation_tpu_torch import (SimConfig, Impulses,
                                                  init_state,
                                                  make_step_render)
    from esp32_fluid_simulation_tpu_torch.io_host.native import (
        rgb565_to_rgb888)
    from esp32_fluid_simulation_tpu_torch.io_host.pipeline import (
        FrameFetcher, SimPipeline)

    cfg = SimConfig.from_json(CONFIG0.read_text())
    frames = []
    pipe = SimPipeline(cfg, lambda rgb, k: frames.append(rgb), fps=1000.0,
                       device=dev)
    for drag in PIPE_DRAGS:
        pipe.push_drag(*drag)
    counts = reset_counts()
    t0 = time.perf_counter()
    delivered = pipe.run(PIPE_FRAMES)
    wall = time.perf_counter() - t0
    torch.cuda.synchronize()
    n = counts()
    if delivered != PIPE_FRAMES or len(frames) != PIPE_FRAMES:
        raise AssertionError(f"phase 21: {delivered} frames delivered "
                             f"({len(frames)} to the sink), want "
                             f"{PIPE_FRAMES}")
    if n["K1 project_fused"] != PIPE_FRAMES or \
            n["K2 advect_kernel"] != 2 * PIPE_FRAMES:
        raise AssertionError(f"phase 21: launch counts {n} for "
                             f"{PIPE_FRAMES} frames")
    # drags pushed before run() are drained at frame 0
    step_render = make_step_render(cfg)
    st = init_state(cfg, device=dev)
    first = Impulses.from_lists(cfg, [d[:2] for d in PIPE_DRAGS],
                                [d[2:] for d in PIPE_DRAGS], device=dev)
    none = Impulses.none(cfg, device=dev)
    differ = []
    for t in range(PIPE_FRAMES):
        st, frame = step_render(st, first if t == 0 else none)
        if not np.array_equal(rgb565_to_rgb888(frame.cpu().numpy()),
                              frames[t]):
            differ.append(t)
    moved = not np.array_equal(frames[0], frames[-1])
    print(f"phase 21 SimPipeline at {cfg.shape[0]}x{cfg.shape[1]}: "
          f"{delivered} frames delivered, launches K1 "
          f"{n['K1 project_fused']}, K2 {n['K2 advect_kernel']}; frames "
          f"differing from the serial make_step_render replay: {differ}; "
          f"the dye moved: {moved}")
    if differ or not moved:
        raise AssertionError("phase 21: the pipeline's frames differ from "
                             "the serial replay")
    host_line(f"SimPipeline (fps=1000, {PIPE_FRAMES} frames, rgb888 to the "
              "sink)", 1e3 * wall / PIPE_FRAMES,
              swirl_chain_ms(step_render, cfg, st, dev), card)
    # the consumer's share of a frame, on the host's clock: the copy to
    # the host (copy stream, pinned buffer) and the 565 -> 888 expansion
    fetcher = FrameFetcher()
    t0 = time.perf_counter()
    for _ in range(5):
        host = fetcher.fetch(frame, FrameFetcher.mark(frame))
    t1 = time.perf_counter()
    for _ in range(5):
        rgb565_to_rgb888(host)
    t2 = time.perf_counter()
    print(f"phase 21 consumer per frame ({tuple(frame.shape)} RGB565): "
          f"FrameFetcher.fetch {200 * (t1 - t0):.4f} ms, rgb565_to_rgb888 "
          f"{200 * (t2 - t1):.4f} ms (host clock, 5 calls each)")
    return {"K1 project_fused": n["K1 project_fused"],
            "K2 advect_kernel": n["K2 advect_kernel"]}


def phase22_serve(dev, card):
    """``serve`` at config 0 with a 4:1 stream: /stats, /drag, /frame."""
    import threading
    import urllib.request
    from esp32_fluid_simulation_tpu_torch import SimConfig, init_state
    from esp32_fluid_simulation_tpu_torch.io_host.native import (
        jpeg_available)
    from esp32_fluid_simulation_tpu_torch.io_host.server import serve

    cfg = SimConfig.from_json(CONFIG0.read_text())
    counts = reset_counts()
    sim, httpd = serve(cfg, port=0, fps=1000.0,
                       stream_decim=SERVE_DECIM, device=dev)
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    http = threading.Thread(target=httpd.serve_forever, daemon=True)
    http.start()

    def get(path):
        return urllib.request.urlopen(base + path, timeout=30).read()

    try:
        deadline = time.time() + 120
        while time.time() < deadline:
            stats = json.loads(get("/stats"))
            if stats["steps"] > SERVE_MIN_STEPS:
                break
            time.sleep(0.2)
        # a drag before each frame, at two places: one drag at 4096^2
        # moves too little dye to change a 4:1 view within 0.3 s
        status, frames = [], []
        for frm, to in SERVE_DRAGS:
            req = urllib.request.Request(base + "/drag", method="POST",
                                         data=json.dumps({
                                             "from": frm, "to": to,
                                             "ms": 16}).encode())
            status.append(urllib.request.urlopen(req, timeout=30).status)
            time.sleep(0.3)
            frames.append(get("/frame"))
        f1, f2 = frames
        stats = json.loads(get("/stats"))
        page = get("/")
    finally:
        sim.stop()
        httpd.shutdown()
        httpd.server_close()
        for th in sim.threads:
            th.join(timeout=60)
    torch.cuda.synchronize()
    n = counts()
    done = sim.steps_done
    print(f"phase 22 serve at {cfg.shape[0]}x{cfg.shape[1]}, stream_decim "
          f"{SERVE_DECIM}: /stats {stats}; /drag {status}; two /frame "
          f"{len(f1)} and {len(f2)} bytes, differ: {f1 != f2}; mime "
          f"{sim.mime} (libjpeg at build time: {jpeg_available()}); "
          f"launches K1 {n['K1 project_fused']}, K2 "
          f"{n['K2 advect_kernel']} for {done} steps")
    if stats["steps"] <= SERVE_MIN_STEPS or status != [204, 204] \
            or f1 == f2 \
            or len(f1) < 100 or b"/stream" not in page:
        raise AssertionError("phase 22: the server's round trip failed")
    if any(th.is_alive() for th in sim.threads):
        raise AssertionError("phase 22: a server thread did not stop")
    if n["K1 project_fused"] != done or n["K2 advect_kernel"] != 2 * done:
        raise AssertionError(f"phase 22: launch counts {n} for {done} steps")
    host_line(f"serve (sim_fps of /stats, fps=1000, stream_decim "
              f"{SERVE_DECIM}, frames polled by /frame)",
              1e3 / max(stats["sim_fps"], 1e-9),
              swirl_chain_ms(sim._step_render, cfg,
                             init_state(cfg, device=dev), dev), card)
    print(f"phase 22 /stats: sim_fps {stats['sim_fps']}, encode_fps "
          f"{stats['encode_fps']}")
    return {"K1 project_fused": n["K1 project_fused"],
            "K2 advect_kernel": n["K2 advect_kernel"]}


def phase23_demo(dev):
    """The demo at its own small sizes: the 2D bed, --pipeline and
    --smoke3d each write their frames."""
    import tempfile
    from esp32_fluid_simulation_tpu_torch import demo

    runs = {"2D bed": (["--frames", "6", "--every", "3"], "frame_", 2),
            "--pipeline": (["--pipeline", "--frames", "6"], "pipe_", 6),
            "--smoke3d": (["--smoke3d", "--frames", "6", "--every", "3"],
                          "smoke_", 2)}
    with tempfile.TemporaryDirectory() as tmp:
        for label, (argv, prefix, want) in runs.items():
            out = f"{tmp}/{prefix}"
            got = demo.main(argv + ["--out", out, "--device", str(dev)])
            files = sorted(p.name for p in Path(out).glob(prefix + "*.ppm"))
            print(f"phase 23 demo {label}: {got} frames, {len(files)} "
                  f"PPM files")
            if got != want or len(files) != want:
                raise AssertionError(f"phase 23: demo {label} wrote "
                                     f"{files}, want {want} frames")


def phase24_dcn(dev, card, cfg, mesh, sh):
    """Config 5 at 8192^2 on the kernel route (``cfg``, phase 16's) across
    two processes on the card: ``run_dcn_dryrun`` over gloo, each process
    owning one row of two 4096^2 blocks, its strips staged through pinned
    host memory.  Each child checks its blocks bit for bit against
    ``make_step`` and reports its K11 launches and ms/step; returns the
    children's K11 K1/K2 block launches, summed."""
    from esp32_fluid_simulation_tpu_torch.parallel import make_sharded_step
    from esp32_fluid_simulation_tpu_torch.parallel.dcn import (
        SWIRL_SPEED as DCN_SWIRL_SPEED, dcn_results, run_dcn_dryrun)
    from esp32_fluid_simulation_tpu_torch.io_host.touch import scripted_swirl

    # the children's traffic: the same pokes at the same speed
    imps = [scripted_swirl(cfg, t, speed=DCN_SWIRL_SPEED, device=dev)
            for t in range(DCN_STEPS)]
    step = make_sharded_step(cfg, mesh)
    box = {"st": sh, "t": 0}

    def sharded_one():
        box["st"] = step(box["st"], imps[box["t"] % DCN_STEPS])
        box["t"] += 1

    single_ms = cuda_ms(sharded_one, DCN_STEPS - 1, warmup=1)
    del box["st"]
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out = run_dcn_dryrun(num_processes=2, devices_per_process=2,
                         steps=DCN_STEPS, timeout=DCN_TIMEOUT,
                         backend="gloo", device="cuda", cfg=cfg, atol=0.0)
    wall = time.perf_counter() - t0
    for line in out.splitlines():
        if line.startswith("dcn proc "):
            print(f"phase 24 {line}")
    res = dcn_results(out)
    if len(res) != 2 or any(r["device"] != str(dev) or not r["host_staged"]
                            or r["shape"] != list(cfg.shape) for r in res):
        raise AssertionError(f"phase 24: unexpected children {res}")
    k1 = sum(r["launches"]["project_fused.block_launches"] for r in res)
    k2 = sum(r["launches"]["advect_kernel.block_launches"] for r in res)
    if (k1, k2) != (4 * DCN_STEPS, 8 * DCN_STEPS):
        raise AssertionError(f"phase 24: K11 K1/K2 block launches {k1}/{k2}"
                             f" over {DCN_STEPS} steps in both processes")
    ms = max(r["ms_per_step"] for r in res)
    print(f"phase 24 dcn config 5 {cfg.shape[0]}x{cfg.shape[1]} "
          f"({cfg.solver}, advect_impl {cfg.advect_impl}) across 2 processes "
          f"on {dev}, transport gloo (strips staged through pinned host "
          f"buffers), {DCN_STEPS} steps bit-equal to make_step in each "
          f"process: launches K11 K1 block {k1}, K11 K2 block {k2}; "
          f"{ms:.4f} ms/step (CUDA events in each child over steps "
          f"2-{DCN_STEPS}, the slower rank's; ranks "
          f"{[round(r['ms_per_step'], 4) for r in res]}) beside phase 16's "
          f"single-process 2x2 mesh {single_ms:.4f} ms/step (CUDA events, "
          f"this process, the same {DCN_SWIRL_SPEED:g} cells/s pokes), on "
          f"{card}; the dryrun took {wall:.1f} s")
    return {"K11 K1 project_fused block": k1,
            "K11 K2 advect_kernel block": k2}


def phase25_profiling(dev, card, cfg, state0):
    """``utils.profiling`` and ``utils.roofline`` at config 0:
    ``chain_time`` of ``make_step_render``, cold and warm, beside the
    CUDA-event time of the same chained call (phase 5's method), each
    within ``CHAIN_RTOL`` of it, and ``speed_of_light``'s ideal
    step; then one ``trace`` of a few steps, which must hold K1's and K2's
    device kernels by name.  Runs after every other profiler trace."""
    import tempfile
    from esp32_fluid_simulation_tpu_torch import make_step_render
    from esp32_fluid_simulation_tpu_torch.io_host.touch import scripted_swirl
    from esp32_fluid_simulation_tpu_torch.utils import (GPU_SPECS,
                                                        chain_time,
                                                        speed_of_light,
                                                        trace)

    imp = scripted_swirl(cfg, 0, device=dev)
    step = make_step_render(cfg)
    box = {"st": state0}

    def one():
        box["st"], _ = step(box["st"], imp)

    def chained():
        return 1e3 * chain_time(lambda s: step(s, imp)[0], state0,
                                CHAIN_STEPS)

    # cold first: a fresh factory, the allocator's cache emptied, nothing
    # run before it in this phase (a user's first call); then in turns,
    # events, chain, chain, events: both see the same card state
    torch.cuda.empty_cache()
    cold = chained()
    events = [cuda_ms(one, CHAIN_STEPS, warmup=3)]
    chain = [chained(), chained()]
    events.append(cuda_ms(one, CHAIN_STEPS, warmup=0))
    sol = speed_of_light(cfg, "h100")
    gbps = GPU_SPECS["h100"].hbm_gbps
    print(f"phase 25 config 0 make_step_render on {card}: chain_time "
          f"cold {cold:.4f}, then {chain[0]:.4f} / {chain[1]:.4f} ms/step "
          f"({CHAIN_STEPS} chained steps less one) beside {events[0]:.4f} "
          f"/ {events[1]:.4f} ms/step by CUDA events (phase 5's method, "
          f"{CHAIN_STEPS} steps; in turns: cold chain, events, chain, "
          f"chain, events); speed_of_light(cfg0, 'h100') "
          f"{sol['ideal_ms_per_step']:.4f} ms/step "
          f"({sol['bytes_per_step']:.6g} bytes at {gbps / 1e3:g} TB/s, "
          f"{sol['ideal_fps']:.1f} fps ideal), the CUDA-event step at "
          f"{100 * sol['ideal_ms_per_step'] / min(events):.1f}% of it")
    for name, ms in (("cold", cold), ("warm", chain[0]), ("warm", chain[1])):
        if abs(ms - min(events)) > CHAIN_RTOL * min(events):
            raise AssertionError(
                f"phase 25: chain_time {name} {ms:.4f} ms/step, the CUDA "
                f"events {min(events):.4f}: not within "
                f"{100 * CHAIN_RTOL:g}%")
    del box["st"]
    with tempfile.TemporaryDirectory() as tmp:
        with trace(tmp):
            st = state0
            for _ in range(TRACE_STEPS):
                st, _ = step(st, imp)
        files = list(Path(tmp).glob("trace_*.json"))
        if len(files) != 1:
            raise AssertionError(f"phase 25: trace wrote {files}")
        recorded = json.loads(files[0].read_text())["traceEvents"]
    kernels = [e["name"] for e in recorded if e.get("cat") == "kernel"]
    k1 = sum("project_tile_kernel" in n for n in kernels)
    k2 = sum("advect_kernel" in n for n in kernels)
    names = sorted({n.replace("void ", "").replace(
        "(anonymous namespace)::", "").split("(")[0] for n in kernels})
    print(f"phase 25 trace of {TRACE_STEPS} config 0 steps: "
          f"{len(kernels)} device kernel events, K1 project_tile_kernel "
          f"{k1}, K2 advect_kernel {k2}; kernels {names}")
    if k1 != TRACE_STEPS or k2 != 2 * TRACE_STEPS:
        raise AssertionError(f"phase 25: the trace holds K1 x{k1} and K2 "
                             f"x{k2}, not x{TRACE_STEPS} and "
                             f"x{2 * TRACE_STEPS}")


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
    err3, k10_calls = phase1b_kernels3d(dev)
    err.update(err3)
    for name, e in phase13_k6_kernels(dev).items():
        err[name] = max(err.get(name, 0.0), e)
    err.update(phase15_block_kernels(dev))
    err.update(phase15b_block_kernels3d(dev))
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
    counts4, member_cfg, ens0, sched = phase14_config4(dev)
    counts.update(counts4)
    k11, cfg5, mesh, state5, sh5 = phase16_sharded_main_path(dev)
    counts.update(k11)
    k4_path = phase17_sharded_routes(dev, mesh)
    counts["K11 K4 sor_solve_kernel block"] = k4_path[0]
    k11_3d, cfg18, sh18 = phase18_sharded_smoke(dev, mesh)
    counts.update(k11_3d)
    cfg19, sh19 = phase19_dyebed3d(dev, mesh)
    # the host side's entry points at config 0: their K1 and K2 launches
    # count in those kernels' rows
    for host_counts in (phase20_run_main(dev, card),
                        phase21_pipeline(dev, card), phase22_serve(dev, card)):
        for name, k in host_counts.items():
            counts[name] += k
    phase23_demo(dev)
    for name, k in phase24_dcn(dev, card, cfg5, mesh, sh5).items():
        counts[name] += k
    work = phase5_timing(dev, cfg, state0, card)
    work.update(phase5_smoke_timing(dev, scfg, smoke, card))
    work.update(phase5_k4_k5_timing(dev, card, {
        "config3 step_render": (cfg3, st3, True),
        "sor_pallas step": (cfg_sor, st_sor, False),
        "config2 step_render": (cfg2, st2, True)}))
    sor_design(dev, card)
    work.update(phase5_config4_timing(dev, card, member_cfg, ens0, sched))
    work.update(phase5_sharded_timing(dev, card, cfg5, mesh, state5, sh5,
                                      k4_path))
    work.update(phase5_sharded3d_timing(dev, card, cfg18, mesh, sh18, cfg19,
                                        sh19))
    k10_ms = phase5_k10(dev, scfg, smoke, card, k10_calls)
    if k10_ms is not None:
        # the summary carries K10's device time inside the main path
        work["K10 render_smoke_mip_kernel"] = (
            k10_ms, *work["K10 render_smoke_mip_kernel"][1:])
    phase25_profiling(dev, card, cfg, state0)

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
    print(f"chip_smoke.py took {time.perf_counter() - t0:.1f} s, the "
          "kernel build included")
    print(card)
    print(json.dumps(summary))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
