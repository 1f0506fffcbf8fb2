"""K10 (``render/cuda_smoke.py``, ``csrc/smoke_mip.cu``), the plume's MIP
frame: its least bytes (``sizes3d.mip_bytes``) at the card's published
bandwidth, over K10's device time a traced step, in percent."""

import re

from bench_port import sizes3d

KERNEL = re.compile(r"\bsmoke_mip_kernel\b")


def read(summary: dict, ctx: dict):
    bw = ctx["hbm_bytes_per_s"]
    dev_s = sum(k["seconds"] for k in summary["kernels"]
                if KERNEL.search(k["name"]))
    if not bw or dev_s <= 0:
        return None
    least = sizes3d.mip_bytes(ctx["sim"]) / bw
    return 100.0 * least / (dev_s / summary["steps"])
