"""The multi-process leg of the communication backend (counterpart of
``esp32_fluid_simulation_tpu/parallel/dcn.py``).

JAX runs one ``shard_map`` program over a mesh that spans processes
(``jax.distributed.initialize``; XLA routes the cross-process edges of
each collective over DCN).  The port's sharded steps are eager, and run
multi-controller as they are: every process runs the same step over one
mesh from ``topology.make_process_mesh``, holds only its own blocks, and
``parallel.halo`` moves the strips that cross processes through
``torch.distributed`` (one ``batch_isend_irecv`` per exchange; the
whole-grid gathers and the mesh metrics as collectives).

``run_dcn_dryrun`` spawns ``num_processes`` children (``python -m
esp32_fluid_simulation_tpu_torch.parallel.dcn ...``).  Each builds the
global mesh, runs the sharded step for ``steps`` steps of
``scripted_swirl`` and checks its own blocks against the single-device
``make_step`` trajectory, which every process computes for itself.  The
caller chooses the transport, and nothing falls back to another; the
blocks are on the card unless the caller asks for the CPU:

* ``backend="gloo", device="cpu"``: the CPU stand-in, as JAX's gloo;
* ``backend="gloo", device="cuda"``: the blocks and the kernels on the
  card (rank r on ``cuda:(r % cards)``, so processes may share one), every
  strip staged through a pinned host buffer, since gloo carries CPU
  tensors only;
* ``backend="nccl"``: rank r on ``cuda:r``; it raises where the host has
  fewer cards than processes, since NCCL refuses two ranks on one card.

    python -m esp32_fluid_simulation_tpu_torch.parallel.dcn PID N PORT \\
        [STEPS] [--backend gloo|nccl] [--device cpu|cuda] ...

runs one child by hand (``--help`` lists the rest).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

# the default config (JAX's dcn.py:66) and its CFL clamp, the max_disp=3
# JAX passes to the sharded step (dcn.py:94)
BLOCK_CELLS = 16
DEFAULT_MAX_DISP = 3
# the scripted swirl's pokes, cells/s: 2 cells a step at dt 1/30, under the
# default clamp (JAX's dcn pokes at 30-72 cells/s), so the eager sharded
# step, which clamps, and the single-device step, which does not, agree
SWIRL_SPEED = 60.0


def _process_device(rank: int, num_processes: int, backend: str,
                   device: str):
    """The ``torch.device`` rank ``rank`` runs on, or a clear error where
    the transport cannot serve it."""
    import torch

    if backend not in ("gloo", "nccl"):
        raise ValueError(f"unknown backend {backend!r} (gloo or nccl)")
    if device not in ("cpu", "cuda"):
        raise ValueError(f"unknown device {device!r} (cpu or cuda)")
    if device == "cpu":
        if backend == "nccl":
            raise ValueError("nccl carries CUDA tensors only: use "
                             "device='cuda', or backend='gloo' on the CPU")
        return torch.device("cpu")
    cards = torch.cuda.device_count()
    if backend == "nccl" and cards < num_processes:
        raise RuntimeError(
            f"nccl needs a card per process: {num_processes} processes, "
            f"{cards} visible cards (NCCL refuses two ranks on one card; "
            "backend='gloo' shares one through host staging)")
    if cards == 0:
        raise RuntimeError("device='cuda' but no CUDA device is visible")
    return torch.device("cuda", rank if backend == "nccl" else rank % cards)


def dcn_worker_body(process_id: int, num_processes: int, port: int,
                    steps: int = 3, *, backend: str = "gloo",
                    device: str = "cuda", devices_per_process: int = 4,
                    cfg_json: str | None = None, atol: float = 1e-4,
                    with_metrics: bool = False,
                    out_dir: str | None = None, store: str | None = None,
                    timeout: float = 600.0) -> None:
    """Runs INSIDE each process of the group.

    Joins the group (``store``: a file for a ``FileStore``; else TCP on
    ``localhost:port``), builds the global mesh over every process's
    ``devices_per_process`` positions (all on this process's device),
    runs ``steps`` sharded steps of ``cfg_json`` (default: JAX's
    ``SimConfig(shape=(gx*16, gy*16), sor_iters=4)`` with the clamp at 3
    cells) driven by ``scripted_swirl`` at ``SWIRL_SPEED``, and asserts
    that this process's blocks are within ``atol`` of the single-device
    ``make_step`` trajectory (0: bit-equal).  Prints the OK line and a
    ``result`` line (JSON: ms per step over steps 2.., by CUDA events on a
    card and the host clock on the CPU; the K11 K1/K2 block launches of
    the sharded steps).  ``out_dir``: write this process's blocks (and
    metrics) to ``out_dir/rank<pid>.npz``.  ``timeout``: seconds any
    collective may wait."""
    import datetime

    import numpy as np
    import torch
    import torch.distributed as dist

    from ..config import SimConfig
    from ..io_host.touch import scripted_swirl
    from ..models.stable_fluids import init_state, make_step
    from ..ops.cuda.advect import advect_kernel
    from ..ops.cuda.project import project_fused
    from .halo import staged
    from .sharded import (make_sharded_step, shard_state,
                          sharded_state_sharding)
    from .topology import X_AXIS, Y_AXIS, make_process_mesh

    dev = _process_device(process_id, num_processes, backend, device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    else:
        torch.set_num_threads(1)
    dist.init_process_group(
        backend, init_method=(f"file://{store}" if store
                              else f"tcp://localhost:{port}"),
        world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=timeout))
    try:
        mesh = make_process_mesh([dev] * devices_per_process)
        gx, gy = mesh.shape[X_AXIS], mesh.shape[Y_AXIS]
        if cfg_json is None:
            cfg = SimConfig(shape=(gx * BLOCK_CELLS, gy * BLOCK_CELLS),
                            sor_iters=4, advect_max_disp=DEFAULT_MAX_DISP)
        else:
            cfg = SimConfig.from_json(cfg_json)
        imps = [scripted_swirl(cfg, t, speed=SWIRL_SPEED, device=dev)
                for t in range(steps)]
        state0 = init_state(cfg, device=dev)
        fn = make_sharded_step(cfg, mesh, with_metrics=with_metrics)
        state = shard_state(state0, cfg, mesh)
        project_fused.block_launches = 0
        advect_kernel.block_launches = 0
        on_card = dev.type == "cuda"
        start = end = t0 = None
        metrics = None
        for t, imp in enumerate(imps):
            if t == 1:
                if on_card:
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    start.record()
                else:
                    t0 = time.perf_counter()
            state = fn(state, imp)
            if with_metrics:
                state, metrics = state
        ms = None
        if steps > 1:
            if on_card:
                end.record()
                end.synchronize()
                ms = start.elapsed_time(end) / (steps - 1)
            else:
                ms = 1e3 * (time.perf_counter() - t0) / (steps - 1)
        launches = {"project_fused.block_launches":
                    project_fused.block_launches,
                    "advect_kernel.block_launches":
                    advect_kernel.block_launches}

        # the single-device reference, computed in every process
        ref = state0
        one = make_step(cfg)
        for imp in imps:
            ref = one(ref, imp)
        sh = sharded_state_sharding(cfg, mesh)
        worst = {"velocity": 0.0, "color": 0.0}
        arrays = {}
        for a, b in sh.cells:
            ox, oy = sh.origin(a, b)
            for name in worst:
                got = getattr(state, name)[a][b]
                want = getattr(ref, name)[..., ox:ox + sh.lh,
                                          oy:oy + sh.lw]
                if got.dtype != want.dtype or got.shape != want.shape:
                    raise AssertionError(f"{name} block ({a}, {b}): "
                                         f"{got.dtype}{tuple(got.shape)} vs "
                                         f"{want.dtype}{tuple(want.shape)}")
                err = float((got.float() - want.float()).abs().max())
                if not err <= atol or (atol == 0
                                       and not torch.equal(got, want)):
                    raise AssertionError(
                        f"dcn proc {process_id}: {name} block ({a}, {b}) "
                        f"differs from the single-device step by {err} "
                        f"(atol {atol})")
                worst[name] = max(worst[name], err)
                arrays[f"{name}_{a}_{b}"] = got.float().cpu().numpy()
        if metrics is not None:
            for k, v in metrics.items():
                arrays[f"metric_{k}"] = v.cpu().numpy()
        if out_dir is not None:
            np.savez(os.path.join(out_dir, f"rank{process_id}.npz"),
                     **arrays)
        dist.barrier()
        print(f"dcn proc {process_id}/{num_processes}: {steps} sharded "
              f"steps over a {gx}x{gy} mesh spanning {num_processes} "
              f"processes OK ({len(sh.cells)} local shards; "
              f"max|dvel|={worst['velocity']:.2e}, "
              f"max|dcolor|={worst['color']:.2e} vs single-device)",
              flush=True)
        print(f"dcn proc {process_id} result " + json.dumps({
            "backend": backend, "device": str(dev),
            "host_staged": staged(dev), "shape": list(cfg.shape),
            "ms_per_step": ms, "launches": launches}), flush=True)
    finally:
        dist.destroy_process_group()


def run_dcn_dryrun(num_processes: int = 2, devices_per_process: int = 4,
                   port: int | None = None, steps: int = 3,
                   timeout: float = 600.0, *, backend: str = "gloo",
                   device: str = "cuda", cfg=None, atol: float = 1e-4,
                   with_metrics: bool = False,
                   out_dir: str | None = None) -> str:
    """Spawn the multi-process mesh from a normal single-process session.

    Returns the concatenated child stdout (the per-process OK and result
    lines).  Raises ``RuntimeError`` with the failing child's output on any
    child failure or timeout; the other children are then stopped.
    ``port`` None joins the group through a file store in a fresh
    temporary directory (no port to collide with).  ``cfg``: a
    ``SimConfig`` (default: ``dcn_worker_body``'s).  The other keywords
    pass to ``dcn_worker_body``; ``timeout`` bounds the whole run and each
    collective inside it."""
    pkg_root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ)
    env["PYTHONPATH"] = pkg_root + os.pathsep + env.get("PYTHONPATH", "")
    with tempfile.TemporaryDirectory(prefix="dcn_") as tmp:
        extra = ["--backend", backend, "--device", device,
                 "--devices-per-process", str(devices_per_process),
                 "--atol", repr(atol),
                 "--timeout", repr(timeout)]
        if port is None:
            extra += ["--store", os.path.join(tmp, "store")]
            port = 0
        if cfg is not None:
            extra += ["--config-json", cfg.to_json()]
        if with_metrics:
            extra.append("--with-metrics")
        if out_dir is not None:
            extra += ["--out-dir", str(out_dir)]
        procs, logs = [], []
        for pid in range(num_processes):
            log = open(os.path.join(tmp, f"child{pid}.log"), "w+")
            logs.append(log)
            procs.append(subprocess.Popen(
                [sys.executable, "-m",
                 "esp32_fluid_simulation_tpu_torch.parallel.dcn",
                 str(pid), str(num_processes), str(port), str(steps)]
                + extra, env=env, stdout=log, stderr=subprocess.STDOUT,
                text=True))
        fail = None
        deadline = time.monotonic() + timeout
        try:
            while any(p.poll() is None for p in procs):
                bad = [pid for pid, p in enumerate(procs)
                       if p.returncode not in (None, 0)]
                if bad or time.monotonic() > deadline:
                    fail = (f"dcn child {bad[0]} rc={procs[bad[0]].returncode}"
                            if bad else f"dcn children timed out after "
                            f"{timeout} s")
                    break
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
        outs = []
        for log in logs:
            log.seek(0)
            outs.append(log.read())
            log.close()
    for pid, p in enumerate(procs):
        if p.returncode != 0 and fail is None:
            fail = f"dcn child {pid} rc={p.returncode}"
    if fail:
        raise RuntimeError(fail + "".join(
            f"\n--- dcn child {pid} output ---\n{out}"
            for pid, out in enumerate(outs)))
    joined = "".join(outs)
    ok_lines = [ln for ln in joined.splitlines() if "sharded steps" in ln]
    if len(ok_lines) != num_processes:
        raise RuntimeError(f"expected {num_processes} OK lines, got "
                           f"{len(ok_lines)}:\n{joined}")
    return joined


def dcn_results(output: str) -> list:
    """The ``result`` objects of ``run_dcn_dryrun``'s output, by rank."""
    rows = [ln.split(" result ", 1) for ln in output.splitlines()
            if ln.startswith("dcn proc ") and " result " in ln]
    return [json.loads(body) for _, body in
            sorted(rows, key=lambda r: int(r[0].split()[2]))]


def main(argv=None) -> None:
    p = argparse.ArgumentParser(
        description="One process of the multi-process sharded step "
                    "(run_dcn_dryrun starts them).")
    p.add_argument("process_id", type=int)
    p.add_argument("num_processes", type=int)
    p.add_argument("port", type=int, help="TCP port of rank 0 on localhost "
                   "(unused with --store)")
    p.add_argument("steps", type=int, nargs="?", default=3)
    p.add_argument("--backend", choices=("gloo", "nccl"), default="gloo")
    p.add_argument("--device", choices=("cpu", "cuda"), default="cuda",
                   help="where the blocks and kernels run (default: the "
                   "card; cpu only with gloo)")
    p.add_argument("--devices-per-process", type=int, default=4)
    p.add_argument("--config-json", default=None)
    p.add_argument("--atol", type=float, default=1e-4)
    p.add_argument("--with-metrics", action="store_true")
    p.add_argument("--out-dir", default=None)
    p.add_argument("--store", default=None,
                   help="a file for the group's FileStore")
    p.add_argument("--timeout", type=float, default=600.0)
    a = p.parse_args(argv)
    dcn_worker_body(a.process_id, a.num_processes, a.port, a.steps,
                    backend=a.backend, device=a.device,
                    devices_per_process=a.devices_per_process,
                    cfg_json=a.config_json, atol=a.atol,
                    with_metrics=a.with_metrics, out_dir=a.out_dir,
                    store=a.store, timeout=a.timeout)


if __name__ == "__main__":
    main()
