"""Time K10, the smoke MIP render, on one NVIDIA GPU at the default 256^3
``SmokeConfig``, and sweep its launch geometry.

    python3 tools/torch_k10_mip.py [--root DIR] [--sweep]

Steps the plume 20 times from ``init_smoke`` and prints, with the card's
name and power limit, ``chip_smoke.py``'s ``k10_times`` of the package
under ``--root`` (default: this checkout): K10's device time (a
``torch.profiler`` trace) cold with L2 dirty and with L2 clean, and warm,
bf16 and f32, inside a chain of
``make_smoke_step`` + ``render_smoke``, that chain's ms per step + frame,
and the wrapper's host us per call.  ``--root`` may name another checkout
(a parent commit unpacked with ``git archive``): its package is imported
and built, and measured by this checkout's code.

``--sweep`` then times this checkout's kernel at each launch geometry
(``THREADS_X`` pixel groups x ``SEGMENTS`` depth segments a block, set on
``render/cuda_smoke.py``), each checked bit-equal to the plain version
first: device us a call, cold and warm, bf16 and f32.  Imports nothing of
JAX.
"""

import argparse
import importlib.util
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
# (threads_x, segments): 64 to 1024 threads a block
GEOMETRIES = [(x, s) for x in (16, 32, 64, 128, 256)
              for s in (1, 2, 4, 8, 16, 32) if 64 <= x * s <= 1024]


def chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def device_us(fn, n):
    """Mean device time (us) of K10's launches over ``n`` calls of ``fn``
    in one profiler trace; None if the trace does not hold all ``n``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    us = [e.time_range.elapsed_us() for e in prof.events()
          if e.device_type == DeviceType.CUDA and "smoke_mip" in e.name]
    return sum(us) / n if len(us) == n else None


def sweep(cs, dev, state):
    from esp32_fluid_simulation_tpu_torch.render import cuda_smoke
    kern = cuda_smoke.render_smoke_mip_kernel
    scratch = torch.empty(cs.SCRATCH_BYTES // 4, device=dev)
    vols = {str(t)[6:]: state.density.to(t)
            for t in (torch.bfloat16, torch.float32)}
    saved = cuda_smoke.THREADS_X, cuda_smoke.SEGMENTS
    rows = []
    try:
        for tx, seg in GEOMETRIES:
            cuda_smoke.THREADS_X, cuda_smoke.SEGMENTS = tx, seg
            row = [f"{tx}x{seg}"]
            for name, rho in vols.items():
                want = cuda_smoke.render_smoke_mip_reference(rho)
                if not torch.equal(kern(rho).view(torch.int16),
                                   want.view(torch.int16)):
                    raise AssertionError(f"K10 at {tx}x{seg} {name} differs "
                                         "from its plain version")

                def cold():
                    scratch.fill_(1.0)
                    kern(rho)

                row += [device_us(cold, cs.K10_CALLS),
                        device_us(lambda: kern(rho), cs.K10_CALLS)]
            rows.append(row)
    finally:
        cuda_smoke.THREADS_X, cuda_smoke.SEGMENTS = saved
    print("K10 sweep, device us a call (threads_x x segments: bf16 cold, "
          "bf16 warm, f32 cold, f32 warm):")
    for name, *us in rows:
        print(f"  {name}: " + " / ".join(
            "not measured" if u is None else f"{u:.3f}" for u in us))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", type=Path, default=ROOT)
    ap.add_argument("--sweep", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch_k10_mip: no CUDA device")
    if args.sweep and args.root.resolve() != ROOT:
        sys.exit("torch_k10_mip: --sweep times this checkout's kernel only")
    sys.path.insert(0, str(args.root.resolve()))
    cs = chip_smoke()
    from esp32_fluid_simulation_tpu_torch import (SmokeConfig, init_smoke,
                                                  make_smoke_step)
    import esp32_fluid_simulation_tpu_torch as pkg
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"{card}; package {Path(pkg.__file__).parent}")
    dev = torch.device("cuda", 0)
    cfg = SmokeConfig(shape=cs.SMOKE)
    st = init_smoke(cfg, device=dev)
    step = make_smoke_step(cfg)
    for _ in range(cs.SMOKE_STEPS):
        st = step(st)
    for k, v in cs.k10_times(dev, cfg, st).items():
        print(f"  {k}: " + ("not measured" if v is None else f"{v:.4f}"))
    if args.sweep:
        sweep(cs, dev, st)


if __name__ == "__main__":
    main()
