"""K9 (``ops/cuda/sor3d.py``, ``csrc/sor3d.cu``), every pass of a plume
step's RB-SOR solve: the solve's least bytes (``sizes3d.sor_bytes``) at
the card's published bandwidth, over K9's device time a traced step, in
percent."""

import re

from bench_port import sizes3d

KERNEL = re.compile(r"\bsor3d_pass_kernel\b")


def read(summary: dict, ctx: dict):
    bw = ctx["hbm_bytes_per_s"]
    dev_s = sum(k["seconds"] for k in summary["kernels"]
                if KERNEL.search(k["name"]))
    if not bw or dev_s <= 0:
        return None
    least = sizes3d.sor_bytes(ctx["sim"]) / bw
    return 100.0 * least / (dev_s / summary["steps"])
