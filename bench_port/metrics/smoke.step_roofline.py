"""The plume step's share of the HBM roofline: the least bytes a step
and its frame need (``sizes3d.step_bytes``) at the card's published
bandwidth, over the host-clock time a step took in the untraced window,
in percent.  The least bytes do not depend on how the step is
implemented, so no fusion can carry the share past 100%."""

from bench_port import sizes3d


def read(summary: dict, ctx: dict):
    bw = ctx["hbm_bytes_per_s"]
    if not bw or not ctx["step_s"]:
        return None
    least = sizes3d.step_bytes(ctx["sim"]) / bw
    return 100.0 * least / ctx["step_s"]
