"""K1 in its member mode (``ops/cuda/project.py`` ``member=``,
``csrc/project.cu``), the ensemble's projection: its least bytes
(``sizes_members.project_bytes``) at the card's published bandwidth, over
K1's device time a traced step, in percent.  None where the program's
counters show a K1 launch that was not a member launch."""

import re

from bench_port import sizes_members

K1 = re.compile(r"\b(project_tile_kernel|drain_divergence_kernel"
                r"|sor_half_sweep_kernel|gradient_kernel)\b")


def read(summary: dict, ctx: dict):
    counters = summary.get("counters", {})
    if counters.get("K1") != counters.get("K1_member", -1):
        return None
    bw = ctx["hbm_bytes_per_s"]
    dev_s = sum(k["seconds"] for k in summary["kernels"]
                if K1.search(k["name"]))
    if not bw or dev_s <= 0:
        return None
    least = sizes_members.project_bytes(ctx["sim"]) / bw
    return 100.0 * least / (dev_s / summary["steps"])
