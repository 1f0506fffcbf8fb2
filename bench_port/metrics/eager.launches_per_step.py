"""Device kernels launched from inside an ATen op, per traced step: the
eager PyTorch ops of the step, as against the port's own library, which
is called from Python through ctypes and launches outside any ATen op."""


def read(summary: dict, ctx: dict):
    if not summary["kernels"] or not summary["steps"]:
        return None
    return sum(k["eager"] for k in summary["kernels"]) / summary["steps"]
