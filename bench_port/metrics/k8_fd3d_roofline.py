"""K8 (``ops/cuda/fd3d.py``, ``csrc/fd3d.cu``), the divergence and the
gradient subtract of a plume step: their least bytes
(``sizes3d.fd_bytes``) at the card's published bandwidth, over K8's
device time a traced step, in percent."""

import re

from bench_port import sizes3d

KERNEL = re.compile(r"\b(divergence3d_kernel|subtract_gradient3d_kernel)\b")


def read(summary: dict, ctx: dict):
    bw = ctx["hbm_bytes_per_s"]
    dev_s = sum(k["seconds"] for k in summary["kernels"]
                if KERNEL.search(k["name"]))
    if not bw or dev_s <= 0:
        return None
    least = sizes3d.fd_bytes(ctx["sim"]) / bw
    return 100.0 * least / (dev_s / summary["steps"])
