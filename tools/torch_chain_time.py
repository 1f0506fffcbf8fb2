"""Hold ``utils.chain_time`` against CUDA events at config 0 on one NVIDIA
GPU, cold and warm, and find what a cold reading pays for.

    python3 tools/torch_chain_time.py [--n 20] [--after-dcn]

In one fresh process, on ``examples/config0_4096_production.json``'s
``make_step_render`` chained over its state, it prints (with the card's
name and power limit) a row per reading, in this order:

* ``settle1`` readings: ``chain_time``'s difference of an n-step and a
  1-step chain after one settling application (the method before it
  settled with a whole chain), instrumented: the 1-step and n-step runs'
  ms, the n-step run's slowest step (events between steps), the
  ``cudaMalloc`` calls of the caching allocator in each run, and the
  card's SM clock just before;
* ``utils.chain_time`` as the package has it, and the CUDA-event time of
  the same chained call after 3 warm-up steps (``chip_smoke.py``'s
  ``cuda_ms``).

The cases: the first call of the process; warm; after
``torch.cuda.empty_cache()`` (the allocator's cache empty, as after a
phase that frees it); after 10 s idle with the cache warm.
``--after-dcn`` first runs ``chip_smoke.py``'s phases 16 and 24 (config
5 on a 2x2 mesh in this process, then across two child processes on the
card), so that the first reading follows them as phase 25 once did.
Each settle1 row also carries the host's ms to enqueue the n-step run
(``tn_host_ms``): a run whose events read no more than that was bound by
the host.  Imports nothing of JAX.
"""

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def smi(query):
    res = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return res.stdout.strip().splitlines()[0] if res.stdout.strip() else "?"


def mallocs():
    return torch.cuda.memory_stats().get("num_device_alloc", -1)


def settle1(fn, x0, n):
    """The 1-settle chain_time, with each run's allocations and the
    n-step run's slowest step."""
    def run(k):
        cur = x0
        before = mallocs()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(k + 1)]
        ev[0].record()
        t0 = time.perf_counter()
        for i in range(k):
            cur = fn(cur)
            ev[i + 1].record()
        host = 1e3 * (time.perf_counter() - t0)
        ev[-1].synchronize()
        steps = [ev[i].elapsed_time(ev[i + 1]) for i in range(k)]
        return sum(steps), max(steps), steps.index(max(steps)), \
            mallocs() - before, host

    clock = smi("clocks.sm")
    settle = run(1)
    t1 = run(1)
    tn = run(n)
    return {"ms_per_step": max((tn[0] - t1[0]) / (n - 1), 1e-6),
            "t1_ms": t1[0], "tn_ms": tn[0], "tn_slowest_step_ms": tn[1],
            "tn_slowest_step": tn[2], "tn_host_ms": tn[4],
            "mallocs_settle_t1_tn": [settle[3], t1[3], tn[3]],
            "sm_clock_before": clock}


def events_ms(fn, x0, n, warmup=3):
    box = {"st": x0}

    def one():
        box["st"] = fn(box["st"])
    for _ in range(warmup):
        one()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        one()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--n", type=int, default=20)
    p.add_argument("--after-dcn", action="store_true")
    a = p.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_chain_time: no CUDA device")
    from esp32_fluid_simulation_tpu_torch import (SimConfig, init_state,
                                                  make_step_render)
    from esp32_fluid_simulation_tpu_torch.io_host.touch import scripted_swirl
    from esp32_fluid_simulation_tpu_torch.ops.cuda import build
    from esp32_fluid_simulation_tpu_torch.utils import chain_time

    card = smi("name,power.limit")
    print(f"card: {card}")
    build.load()
    dev = torch.device("cuda", 0)
    if a.after_dcn:
        import importlib.util
        spec = importlib.util.spec_from_file_location(
            "chip_smoke", ROOT / "chip_smoke.py")
        smoke = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(smoke)
        _, cfg5, mesh, _, sh5 = smoke.phase16_sharded_main_path(dev)
        smoke.phase24_dcn(dev, card, cfg5, mesh, sh5)
        del sh5
    cfg = SimConfig.from_json(
        (ROOT / "examples" / "config0_4096_production.json").read_text())
    state0 = init_state(cfg, device=dev)
    imp = scripted_swirl(cfg, 0, device=dev)
    step = make_step_render(cfg)

    def fn(s):
        return step(s, imp)[0]

    def row(case, method, value):
        r = {"case": case, "method": method}
        r.update(value if isinstance(value, dict) else {"ms_per_step": value})
        print(json.dumps(r), flush=True)

    row("first call, after phases 16 and 24" if a.after_dcn
        else "first call of the process", "settle1", settle1(fn, state0, a.n))
    row("warm", "settle1", settle1(fn, state0, a.n))
    row("warm", "utils.chain_time", 1e3 * chain_time(fn, state0, a.n))
    row("warm", "events", events_ms(fn, state0, a.n))
    for _ in range(2):
        torch.cuda.empty_cache()
        row("cache emptied", "settle1", settle1(fn, state0, a.n))
    for _ in range(2):
        torch.cuda.empty_cache()
        row("cache emptied", "utils.chain_time",
            1e3 * chain_time(fn, state0, a.n))
    torch.cuda.empty_cache()
    row("cache emptied", "events", events_ms(fn, state0, a.n))
    time.sleep(10)
    row("10 s idle", "settle1", settle1(fn, state0, a.n))
    time.sleep(10)
    row("10 s idle", "utils.chain_time", 1e3 * chain_time(fn, state0, a.n))
    row("warm", "events", events_ms(fn, state0, a.n))
    print(card)


if __name__ == "__main__":
    main()
