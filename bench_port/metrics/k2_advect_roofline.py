"""K2 (``ops/cuda/advect.py``, ``csrc/advect.cu``), both calls of a step:
the least bytes of the two advection stages at the card's published
bandwidth, over K2's device time a traced step, in percent.  Self-advect:
the velocity read and written; dye: the velocity and dye read, the dye
and, at s=1, where the pack rides the dye store, the frame written."""

import re

from bench_port import sizes

K2 = re.compile(r"\badvect_kernel\b")


def read(summary: dict, ctx: dict):
    bw = ctx["hbm_bytes_per_s"]
    dev_s = sum(k["seconds"] for k in summary["kernels"]
                if K2.search(k["name"]))
    if not bw or dev_s <= 0:
        return None
    sim, s = ctx["sim"], ctx["scaling"]
    vel, dye = sizes.velocity_bytes(sim), sizes.dye_bytes(sim)
    least = 3 * vel + 2 * dye + (sizes.frame_bytes(sim, s) if s == 1
                                 else 0)
    return 100.0 * (least / bw) / (dev_s / summary["steps"])
