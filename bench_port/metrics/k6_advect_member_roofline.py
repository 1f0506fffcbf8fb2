"""K2 in its member mode (``ops/cuda/advect.py`` ``member=``,
``csrc/advect.cu``), both calls of an ensemble step: their least bytes
(``sizes_members.advect_bytes``) at the card's published bandwidth, over
K2's device time a traced step, in percent.  None where the program's
counters show a K2 launch that was not a member launch."""

import re

from bench_port import sizes_members

K2 = re.compile(r"\badvect_kernel\b")


def read(summary: dict, ctx: dict):
    counters = summary.get("counters", {})
    if counters.get("K2") != counters.get("K2_member", -1):
        return None
    bw = ctx["hbm_bytes_per_s"]
    dev_s = sum(k["seconds"] for k in summary["kernels"]
                if K2.search(k["name"]))
    if not bw or dev_s <= 0:
        return None
    least = sizes_members.advect_bytes(ctx["sim"]) / bw
    return 100.0 * least / (dev_s / summary["steps"])
