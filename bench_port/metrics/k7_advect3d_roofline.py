"""K7 (``ops/cuda/advect3d.py``, ``csrc/advect3d.cu``), both calls of a
plume step, the velocity self-advect and the two scalars: their least
bytes (``sizes3d.advect_bytes``) at the card's published bandwidth, over
K7's device time a traced step, in percent."""

import re

from bench_port import sizes3d

KERNEL = re.compile(r"\badvect3d_kernel\b")


def read(summary: dict, ctx: dict):
    bw = ctx["hbm_bytes_per_s"]
    dev_s = sum(k["seconds"] for k in summary["kernels"]
                if KERNEL.search(k["name"]))
    if not bw or dev_s <= 0:
        return None
    least = sizes3d.advect_bytes(ctx["sim"]) / bw
    return 100.0 * least / (dev_s / summary["steps"])
