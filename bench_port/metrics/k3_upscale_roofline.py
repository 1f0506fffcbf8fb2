"""K3 (``render/cuda_upscale.py``, ``csrc/upscale.cu``): the dye read
and the frame written once at the card's published bandwidth, over K3's
device time a traced step, in percent."""

import re

from bench_port import sizes

K3 = re.compile(r"\brender_rgb565_kernel\b")


def read(summary: dict, ctx: dict):
    bw = ctx["hbm_bytes_per_s"]
    dev_s = sum(k["seconds"] for k in summary["kernels"]
                if K3.search(k["name"]))
    if not bw or dev_s <= 0:
        return None
    least = (sizes.dye_bytes(ctx["sim"])
             + sizes.frame_bytes(ctx["sim"], ctx["scaling"]))
    return 100.0 * (least / bw) / (dev_s / summary["steps"])
