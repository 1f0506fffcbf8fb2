"""Entry ``step_render``: the dye bed's step and frame, driven as the
program's own loops drive it (``run.main``, the server's sim thread).

Each step of the window turns the traffic's impulse lists into
``Impulses`` through ``Impulses.from_lists`` and calls the closure of
``make_step_render``.  The frame stays on the device.
"""

from __future__ import annotations


class StepRender:
    def __init__(self, sim: dict, scaling: int, device):
        from esp32_fluid_simulation_tpu_torch import (Impulses, SimConfig,
                                                      init_state)
        from esp32_fluid_simulation_tpu_torch.models.stable_fluids import (
            make_step_render)

        fields = dict(sim, shape=tuple(sim["shape"]), scaling=scaling)
        self.cfg = SimConfig(**fields)
        self.device = device
        self._from_lists = Impulses.from_lists
        self._step = make_step_render(self.cfg)
        self._state = init_state(self.cfg, device=device)
        self._frame = None

    def feed(self, pos, vel):
        """The program's input for one step, from the traffic's lists."""
        return self._from_lists(self.cfg, pos, vel, device=self.device)

    def step(self, fed) -> None:
        self._state, self._frame = self._step(self._state, fed)

    def counters(self) -> dict:
        """The program's launch counters of the kernels a step may run."""
        from esp32_fluid_simulation_tpu_torch.ops.cuda.advect import (
            advect_kernel)
        from esp32_fluid_simulation_tpu_torch.ops.cuda.project import (
            project_fused)
        from esp32_fluid_simulation_tpu_torch.render.cuda_upscale import (
            render_rgb565_kernel)
        return {"K1": project_fused.launches, "K2": advect_kernel.launches,
                "K3": render_rgb565_kernel.launches}

    def inputs(self) -> dict:
        """The state the next step reads."""
        return {"velocity": self._state.velocity, "dye": self._state.color}

    def outputs(self) -> dict:
        """What the last step produced."""
        return {"velocity": self._state.velocity, "dye": self._state.color,
                "frame": self._frame}


def build(sim: dict, scaling: int, device) -> StepRender:
    return StepRender(sim, scaling, device)


def cpu_sim(sim: dict) -> dict:
    """The same settings at 48x72, a grid that the CPU self-test steps in
    milliseconds, with the kernels' plain versions."""
    return dict(sim, shape=[48, 72])
