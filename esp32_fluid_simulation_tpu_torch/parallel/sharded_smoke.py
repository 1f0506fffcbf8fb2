"""The sharded 3D smoke step (config 5's 3D half: the 256^3 plume over a
mesh; counterpart of ``esp32_fluid_simulation_tpu/parallel/
sharded_smoke.py``).

The vertical axis (D, axis -3) stays whole on every shard; the horizontal
axes shard over the ``(x, y)`` mesh as in the 2D step, with the 3D
stencils of ``parallel/sharded3d.py``: halo windows for the backtrace
(no CFL clamp on the vertical axis in the eager route,
``sharded_smoke.py:80``), reflect-negate and Neumann ghosts, a 1-wide
pressure exchange per SOR half-sweep, the hybrid sharded multigrid and
vorticity confinement.  The plume source is the global mask sliced at
each shard's origin.

Kernel routes: ``advect_impl="pallas"`` advects through K7 in block
mode, two launches per shard per step: the velocity self-advect, which
reads the velocity from its own haloed block, and density + temperature
stacked into one 2-channel block with one exchange, as the single-device
step stacks them (JAX makes three exchanges and launches,
``sharded_smoke.py:66-73, 339-341``; each cell's arithmetic is the same,
so the result is too); ``solver="sor"`` with
``sor_impl="pallas"`` solves through the K9 block chain, one
``2*sor_chunk``-wide exchange per chunk (``:151-173``).  ``"auto"`` takes
the eager routes, as the 2D sharded step does.  On the kernel routes a
shard's cells equal the single-device kernel step's (K7, K8, K9) to the
bit: the sharded divergence and gradient are the eager stencils, which K8
matches to the bit.

A sharded smoke state is a ``SmokeState`` whose fields are grids of
per-shard blocks (``shard_smoke_state`` / ``unshard_smoke_state``).
"""

from __future__ import annotations

import torch

from ..models.smoke3d import SmokeConfig, SmokeState, inject_and_buoy, \
    source_tensor
from .sharded import Shards, check_max_disp, gather, unzip
from .sharded3d import Stencils3D
from .topology import Mesh


def sharded_smoke_sharding(cfg: SmokeConfig, mesh: Mesh) -> Shards:
    """The layout of a ``SmokeState`` of ``cfg`` on ``mesh``: every field
    split over the ``(x, y)`` mesh axes (its trailing two), the vertical
    axis whole, ``step`` a host int."""
    return Shards(mesh, cfg.shape)


def shard_smoke_state(state: SmokeState, cfg: SmokeConfig,
                      mesh: Mesh) -> SmokeState:
    """A ``SmokeState`` -> its sharded form (the counterpart of
    ``jax.device_put(state, sharded_smoke_sharding(cfg, mesh))``)."""
    sh = sharded_smoke_sharding(cfg, mesh)
    return SmokeState(velocity=sh.split(state.velocity),
                      density=sh.split(state.density),
                      temperature=sh.split(state.temperature),
                      step=state.step)


def unshard_smoke_state(sharded: SmokeState, device="cuda") -> SmokeState:
    """A sharded smoke state -> one ``SmokeState`` on ``device``."""
    device = torch.device(device)
    return SmokeState(velocity=gather(sharded.velocity, device),
                      density=gather(sharded.density, device),
                      temperature=gather(sharded.temperature, device),
                      step=sharded.step)


def make_sharded_smoke_step(cfg: SmokeConfig, mesh: Mesh,
                            max_disp: int | None = None,
                            donate: bool = True):
    """Build the sharded ``state -> state`` plume step over ``mesh``
    (``state`` from ``shard_smoke_state``).

    ``max_disp``: the advection's CFL clamp in cells, which sets its halo.
    None means ``cfg.advect_max_disp``; kernel advection, whose clamp the
    single-device step takes from that field, refuses another value (JAX
    defaults to 4 here and to 2 in the single-device kernel).  ``donate``
    is accepted for the JAX signature; PyTorch has no counterpart.
    """
    del donate
    if cfg.solver not in ("sor", "multigrid"):
        raise ValueError(f"unknown solver {cfg.solver!r}")
    use_kernel_advect = cfg.advect_impl == "pallas"
    use_kernel_sor = cfg.solver == "sor" and cfg.sor_impl == "pallas"
    max_disp = check_max_disp(cfg, max_disp, use_kernel_advect)
    sh = sharded_smoke_sharding(cfg, mesh)
    ops = Stencils3D(sh, cfg.dx)
    k = max_disp + 1
    dt = cfg.dt
    sources = {}

    def source(a, b):
        """The global source mask's block at shard (a, b), built once per
        device."""
        dev = sh.devices[a][b]
        if dev not in sources:
            sources[dev] = source_tensor(cfg, dev)
        ox, oy = sh.origin(a, b)
        return sources[dev][:, ox:ox + sh.lh, oy:oy + sh.lw]

    def advect(field, vel, no_slip):
        """``vel`` None: ``field`` is the velocity and advects itself."""
        fpad = sh.exchange2(field, k)
        if use_kernel_advect:
            return ops.advect_kernel(fpad, vel, dt, max_disp, no_slip)
        return ops.advect_eager(fpad, field if vel is None else vel, dt,
                                max_disp, no_slip)

    def step(state: SmokeState) -> SmokeState:
        vel = advect(state.velocity, None, no_slip=True)
        if use_kernel_advect:
            # rho + temp share one backtrace: one exchange and one
            # 2-channel launch per shard
            pair = sh.map(lambda a, b, r, t: torch.stack([r, t]),
                          state.density, state.temperature)
            rho, temp = unzip(sh.map(lambda a, b, x: (x[0], x[1]),
                                     advect(pair, vel, no_slip=False)), 2)
        else:
            rho = advect(state.density, vel, no_slip=False)
            temp = advect(state.temperature, vel, no_slip=False)
        out = sh.map(lambda a, b, v, r, t: inject_and_buoy(
            v, r, t, source(a, b), cfg), vel, rho, temp)
        vel, rho, temp = unzip(out, 3)
        if cfg.vorticity_eps > 0:
            vel = ops.vorticity(vel, cfg.vorticity_eps, dt)

        div = ops.divergence(vel)
        if cfg.solver == "multigrid":
            p = ops.multigrid(div, cfg.mg_cycles, 1.3)
        elif use_kernel_sor:
            p = ops.sor_kernel(div, cfg.sor_iters, cfg.omega, cfg.sor_chunk)
        else:
            p = ops.sor(div, cfg.sor_iters, cfg.omega)
        vel = ops.subtract_gradient(vel, p)

        if cfg.dissipation > 0:
            decay = 1.0 - cfg.dissipation * dt
            rho = sh.map(lambda a, b, x: x * decay, rho)
            temp = sh.map(lambda a, b, x: x * decay, temp)
        return SmokeState(velocity=vel, density=rho, temperature=temp,
                          step=state.step + 1)

    return step
