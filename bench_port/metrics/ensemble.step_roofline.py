"""The ensemble step's share of the HBM roofline: the least bytes a step
needs (``sizes_members.step_bytes``: every member's velocity and dye read
and written once) at the card's published bandwidth, over the host-clock
time a step took in the untraced window, in percent.  The least bytes do
not depend on how the step is implemented, so no fusion can carry the
share past 100%."""

from bench_port import sizes_members


def read(summary: dict, ctx: dict):
    bw = ctx["hbm_bytes_per_s"]
    if not bw or not ctx["step_s"]:
        return None
    least = sizes_members.step_bytes(ctx["sim"]) / bw
    return 100.0 * least / ctx["step_s"]
