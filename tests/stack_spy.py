"""A spy on the tiled step's kernel wrappers for the CPU tests: it counts
the calls that take an ensemble's member stack (a 4D field or velocity),
which on the CPU run the wrappers' plain versions and launch nothing, so
the launch counters stay where they were.  Imports no JAX."""

from esp32_fluid_simulation_tpu_torch.models import stable_fluids
from esp32_fluid_simulation_tpu_torch.ops.cuda.advect import advect_kernel
from esp32_fluid_simulation_tpu_torch.ops.cuda.project import project_fused


def spy_stack_calls(monkeypatch):
    """Wrap ``stable_fluids``' ``advect_kernel`` and ``project_fused``;
    returns a dict whose ``"calls"`` counts their calls on a member
    stack."""
    seen = {"calls": 0}
    for name in ("advect_kernel", "project_fused"):
        def spy(x, *args, _real=getattr(stable_fluids, name), **kw):
            seen["calls"] += x.dim() == 4
            return _real(x, *args, **kw)
        monkeypatch.setattr(stable_fluids, name, spy)
    return seen


def stack_launches():
    """K2's and K1's launches on a member stack, on a card."""
    return advect_kernel.stack_launches + project_fused.stack_launches
