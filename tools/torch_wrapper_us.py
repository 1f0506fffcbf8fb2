"""Host time of the feed and the kernel wrappers, a call at a time, on one
NVIDIA GPU.

    python3 tools/torch_wrapper_us.py [--root DIR] [--against DIR] [--calls 40]

For the feed (``Impulses.from_lists`` of 8 pokes, config 0's and the
plume's) and each wrapper call of the benchmarked steps -- K1 and both K2
passes of config 0's ``step_render`` at 4096² (s=1), K7's two passes, K8's
two wrappers, K9 and K10 of the 256³ plume -- prints the median host
microseconds of ``--calls`` calls, each after a ``torch.cuda.synchronize()``
(the queue empty, as in a step's first launches), and of as many calls back
to back, beside the card's name and power limit.  No profiler runs.  The
inputs are the state after a few steps of each model.  ``--root`` names the
checkout whose package is measured (default: this one).  ``--against``
names a second checkout (a parent commit unpacked with ``git archive``):
its package is loaded beside the first under another name, with its own
kernel library, and the two packages' calls take turns within one process,
their order swapped every round, so that a busy host weighs on both alike.
Prints one JSON line.  Imports nothing of JAX.
"""

import argparse
import importlib
import importlib.util
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

PKG = "esp32_fluid_simulation_tpu_torch"


def load_package(root: Path, name: str):
    """The package of checkout ``root``, imported as ``name``."""
    pkg = root / PKG
    spec = importlib.util.spec_from_file_location(
        name, pkg / "__init__.py", submodule_search_locations=[str(pkg)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def wrapper_calls(pkg, root: Path, dev):
    """``{label: call}`` of ``pkg``'s feed and wrappers at the benchmarked
    shapes."""
    import torch

    def sub(name):
        return importlib.import_module(f"{pkg.__name__}.{name}")

    scripted_swirl = sub("io_host.touch").scripted_swirl
    advect_kernel = sub("ops.cuda.advect").advect_kernel
    advect3d_kernel = sub("ops.cuda.advect3d").advect3d_kernel
    fd3d = sub("ops.cuda.fd3d")
    project_fused = sub("ops.cuda.project").project_fused
    sor3d_solve = sub("ops.cuda.sor3d").sor3d_solve
    mip = sub("render.cuda_smoke").render_smoke_mip_kernel

    cfg = pkg.SimConfig.from_json(
        (root / "examples" / "config0_4096_production.json").read_text())
    st, step = pkg.init_state(cfg, device=dev), pkg.make_step_render(cfg)
    for t in range(5):
        st, _ = step(st, scripted_swirl(cfg, t, device=dev))
    imp = scripted_swirl(cfg, 5, device=dev)
    vel, dye, md = st.velocity, st.color, cfg.advect_max_disp
    sc = pkg.SmokeConfig(shape=(256, 256, 256), advect_impl="pallas",
                         sor_impl="pallas")
    sm, smoke = pkg.init_smoke(sc, device=dev), pkg.make_smoke_step(sc)
    for _ in range(5):
        sm = smoke(sm)
    v3, scal = sm.velocity, torch.stack([sm.density, sm.temperature])
    div = fd3d.divergence3d(v3, sc.dx)
    p = sor3d_solve(div, sc.dx, sc.sor_iters, sc.omega)
    md3 = sc.advect_max_disp
    pokes2 = ([(1229 + 200 * k, 2867 - 250 * k) for k in range(8)],
              [(300.0 - 40 * k, -150.0 + 45 * k) for k in range(8)])
    pokes3 = ([(154, 128 + 3 * k, 102 + 6 * k) for k in range(8)],
              [(0.0, 45.0 - 11 * k, -20.0 + 7 * k) for k in range(8)])
    return {
        "feed (config 0)": lambda: pkg.Impulses.from_lists(
            cfg, *pokes2, device=dev),
        "feed (plume)": lambda: pkg.Impulses.from_lists(
            sc, *pokes3, device=dev),
        "K1 project_fused": lambda: project_fused(
            vel, cfg.dx, cfg.sor_iters, cfg.omega, impulses=imp),
        "K2 self-advect": lambda: advect_kernel(
            vel, vel, cfg.dt, True, max_disp=md),
        "K2 dye + frame": lambda: advect_kernel(
            dye, vel, cfg.dt, False, max_disp=md, clip01=True, rgb565=True),
        "K7 self-advect": lambda: advect3d_kernel(
            v3, v3, sc.dt, no_slip=True, max_disp=md3),
        "K7 scalars": lambda: advect3d_kernel(
            scal, v3, sc.dt, no_slip=False, max_disp=md3),
        "K8 divergence3d": lambda: fd3d.divergence3d(v3, sc.dx),
        "K8 subtract_gradient3d": lambda: fd3d.subtract_gradient3d(
            v3, p, sc.dx),
        "K9 sor3d_solve": lambda: sor3d_solve(div, sc.dx, sc.sor_iters,
                                              sc.omega),
        "K10 render_smoke_mip_kernel": lambda: mip(sm.density),
    }


def host_us(fns, calls, sync):
    """Median host us of a call of each of ``fns`` (``{side: call}``), the
    sides taking turns call by call, their order reversed every round."""
    import torch
    for fn in fns.values():
        for _ in range(5):
            fn()
    torch.cuda.synchronize()
    sides = list(fns)
    times = {side: [] for side in sides}
    for r in range(calls):
        for side in sides if r % 2 == 0 else sides[::-1]:
            if sync:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            fns[side]()
            times[side].append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    return {side: round(1e6 * statistics.median(v), 1)
            for side, v in times.items()}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--against")
    ap.add_argument("--calls", type=int, default=40)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("torch_wrapper_us: no CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    roots = {"root": Path(args.root).resolve()}
    if args.against:
        roots["against"] = Path(args.against).resolve()
    dev = torch.device("cuda", 0)
    calls = {side: wrapper_calls(load_package(root, f"{PKG}_{side}"), root,
                                 dev)
             for side, root in roots.items()}
    res = {"card": card, "calls": args.calls,
           **{side: str(root) for side, root in roots.items()}}
    for label in calls["root"]:
        fns = {side: calls[side][label] for side in calls}
        res[label] = {"after sync": host_us(fns, args.calls, True),
                      "back to back": host_us(fns, args.calls, False)}
    print(json.dumps(res))


if __name__ == "__main__":
    main()
