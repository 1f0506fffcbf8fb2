"""Entry ``smoke_mip``: the 3D smoke plume's step and its top-down MIP
frame, driven as the README's plume loop drives it, stirred through the
drag queue.

Each step of the window turns the traffic's impulse lists into
``Impulses`` through ``Impulses.from_lists`` (positions ``(z, i, j)``),
calls the closure of ``make_smoke_step`` with them and renders
``render_smoke(density)``: the maximum along axis 0, heat-mapped and
packed to byte-swapped RGB565 (K10 on the card).  The frame stays on the
device.
"""

from __future__ import annotations


class SmokeMip:
    def __init__(self, sim: dict, scaling: int, device):
        from esp32_fluid_simulation_tpu_torch import (Impulses, SmokeConfig,
                                                      init_smoke,
                                                      make_smoke_step,
                                                      render_smoke)

        if scaling != 1:
            raise ValueError("smoke_mip renders the MIP at the grid's own "
                             f"size (scaling 1), not {scaling}")
        fields = dict(sim, shape=tuple(sim["shape"]),
                      source_center=tuple(sim["source_center"]))
        self.cfg = SmokeConfig(**fields)
        self.device = device
        self._from_lists = Impulses.from_lists
        self._render = render_smoke
        self._step = make_smoke_step(self.cfg)
        self._state = init_smoke(self.cfg, device=device)
        self._frame = None

    def feed(self, pos, vel):
        """The program's input for one step, from the traffic's lists."""
        return self._from_lists(self.cfg, pos, vel, device=self.device)

    def step(self, fed) -> None:
        self._state = self._step(self._state, fed)
        self._frame = self._render(self._state.density)

    def counters(self) -> dict:
        """The program's launch counters of the kernels a step runs."""
        from esp32_fluid_simulation_tpu_torch.ops.cuda.advect3d import (
            advect3d_kernel)
        from esp32_fluid_simulation_tpu_torch.ops.cuda.fd3d import (
            divergence3d, subtract_gradient3d)
        from esp32_fluid_simulation_tpu_torch.ops.cuda.sor3d import (
            sor3d_solve)
        from esp32_fluid_simulation_tpu_torch.render.cuda_smoke import (
            render_smoke_mip_kernel)
        return {"K7": advect3d_kernel.launches,
                "K8": divergence3d.launches + subtract_gradient3d.launches,
                "K9": sor3d_solve.launches,
                "K10": render_smoke_mip_kernel.launches}

    def inputs(self) -> dict:
        """The state the next step reads."""
        s = self._state
        return {"velocity": s.velocity, "density": s.density,
                "temperature": s.temperature}

    def outputs(self) -> dict:
        """What the last step produced."""
        s = self._state
        return {"velocity": s.velocity, "density": s.density,
                "temperature": s.temperature, "frame": self._frame}


def build(sim: dict, scaling: int, device) -> SmokeMip:
    return SmokeMip(sim, scaling, device)


def cpu_sim(sim: dict) -> dict:
    """The same settings at 20x24x28, three different extents, a plume
    that the CPU self-test steps in milliseconds with the kernels' plain
    versions."""
    return dict(sim, shape=[20, 24, 28])
