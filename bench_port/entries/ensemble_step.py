"""Entry ``ensemble_step``: an ensemble of independent dye beds stepped
together, driven as a sweep's caller drives it (``run.py --ensemble``).

The configuration's ``shape`` is ``[members, H, W]``; the members share
the rest of it.  The state is kept as the member stack (velocity
``[n, 2, H, W]``, dye ``[n, 3, H, W]``) between steps.  Each step of the
window turns the traffic's flat lists (each poke's member, member-local
cell and velocity) into one batched ``Impulses`` through
``Impulses.from_member_lists`` and calls the closure of
``make_ensemble_step``, which lays the members out on one supergrid, steps
it through the kernels' member modes and lays them back.  No frame is
drawn.
"""

from __future__ import annotations


class EnsembleStep:
    def __init__(self, sim: dict, scaling: int, device):
        from esp32_fluid_simulation_tpu_torch import (Impulses, SimConfig,
                                                      init_ensemble,
                                                      make_ensemble_step)

        if scaling != 1:
            raise ValueError("ensemble_step draws no frame (scaling 1), "
                             f"not {scaling}")
        self.n, h, w = (int(x) for x in sim["shape"])
        self.cfg = SimConfig(**dict(sim, shape=(h, w)))
        self.device = device
        self._from_member_lists = Impulses.from_member_lists
        self._step = make_ensemble_step(self.cfg)
        self._state = init_ensemble(self.cfg, self.n, device=device)

    def feed(self, member, pos, vel):
        """The program's input for one step, from the traffic's lists."""
        return self._from_member_lists(self.cfg, self.n, member, pos, vel,
                                       device=self.device)

    def step(self, fed) -> None:
        self._state = self._step(self._state, fed)

    def counters(self) -> dict:
        """The program's launch counters of the kernels a step may run, by
        mode, and its state layout conversions."""
        from esp32_fluid_simulation_tpu_torch.models.ensemble import (
            layout_conversions)
        from esp32_fluid_simulation_tpu_torch.ops.cuda.advect import (
            advect_kernel)
        from esp32_fluid_simulation_tpu_torch.ops.cuda.project import (
            project_fused)
        return {"K1": project_fused.launches,
                "K1_member": project_fused.member_launches,
                "K2": advect_kernel.launches,
                "K2_member": advect_kernel.member_launches,
                "K2_overlay": advect_kernel.overlay_launches,
                "layouts": layout_conversions()}

    def inputs(self) -> dict:
        """The state the next step reads."""
        return {"velocity": self._state.velocity, "dye": self._state.color}

    def outputs(self) -> dict:
        """What the last step produced."""
        return {"velocity": self._state.velocity, "dye": self._state.color}


def build(sim: dict, scaling: int, device) -> EnsembleStep:
    return EnsembleStep(sim, scaling, device)


def cpu_sim(sim: dict) -> dict:
    """The same settings with 4 members of 32x48, the smallest the program
    still lays out on one supergrid (members of 32 and more), on the
    kernel route that the card takes at the cell's size (``advect_impl``
    "pallas"; on the CPU the kernels' plain versions), which the CPU
    self-test steps in milliseconds."""
    return dict(sim, shape=[4, 32, 48], advect_impl="pallas")
