"""K1 (``ops/cuda/project.py``, ``csrc/project.cu``): the projection
stage's least bytes, the velocity read and written once (the pressure is
scratch, not state; the impulses are a few hundred bytes), at the card's
published bandwidth, over K1's device time a traced step, in percent."""

import re

from bench_port import sizes

K1 = re.compile(r"\b(project_tile_kernel|drain_divergence_kernel"
                r"|sor_half_sweep_kernel|gradient_kernel)\b")


def read(summary: dict, ctx: dict):
    bw = ctx["hbm_bytes_per_s"]
    dev_s = sum(k["seconds"] for k in summary["kernels"]
                if K1.search(k["name"]))
    if not bw or dev_s <= 0:
        return None
    least = 2 * sizes.velocity_bytes(ctx["sim"]) / bw
    return 100.0 * least / (dev_s / summary["steps"])
