"""3D smoke plume model (counterpart of
``esp32_fluid_simulation_tpu/models/smoke3d.py``).

The dye bed's loop generalized to 3D with the standard smoke extensions
(Fedkiw et al. 2001): density and temperature advected through the flow, a
buoyancy force along the vertical axis 0 (``f = (alpha*T - beta*rho) *
z_hat``, low indices are up), a spherical source that injects density and
temperature every step, and optional dissipation.  The drag queue
(``Impulses``, ``.ino:264-269``) is drained into the velocity before the
projection, as in the dye bed: a user stirs the rising column.

On CUDA tensors at the sizes the JAX package sends to its TPU kernels the
step runs the hand-written kernels: K7 ``ops/cuda/advect3d.py`` (velocity
self-advect, then density + temperature in one 2-channel call, which on
a float32 velocity and bfloat16 scalars and mask also injects the source
and applies the buoyancy before it stores, bit-equal to
``inject_and_buoy``: ``advect3d_source_kernel``), K8
``ops/cuda/fd3d.py`` (divergence, gradient subtract) and K9
``ops/cuda/sor3d.py`` (the SOR solve).  Smaller or CPU grids run the
rank-polymorphic eager ops.  PyTorch runs eagerly: ``make_smoke_step``
returns a closure, which builds the source mask once per device.
"""

from __future__ import annotations

import dataclasses
from typing import ClassVar, NamedTuple, Tuple

import torch

from ..ops.advect import advect
from ..ops.fd import divergence, subtract_gradient, vorticity_confinement
from ..ops.poisson import sor_solve
from ..ops.multigrid import multigrid_solve
from ..ops.cuda.advect3d import (Source, advect3d_kernel,
                                 advect3d_source_kernel, apply_source)
from ..ops.cuda.fd3d import divergence3d, subtract_gradient3d
from ..ops.cuda.sor3d import sor3d_solve
from ..spans import span
from ..state import Impulses
from .stable_fluids import apply_impulses_

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class SmokeConfig:
    shape: Tuple[int, int, int] = (64, 64, 64)  # (D=vertical, H, W)
    dt: float = 1.0 / 30.0
    dx: float = 1.0
    solver: str = "sor"            # sor | multigrid
    sor_iters: int = 10
    omega: float = 1.5
    advect_impl: str = "auto"      # auto | jnp | pallas (the K7 kernel)
    # CFL clamp (cells/step) of the K7 kernel path
    advect_max_disp: int = 2
    sor_impl: str = "auto"         # auto | jnp | pallas (the K9 kernel)
    sor_chunk: int = 3             # validated as the JAX contract does
    mg_cycles: int = 1
    buoyancy_alpha: float = 8.0    # thermal lift
    buoyancy_beta: float = 2.0     # smoke weight
    dissipation: float = 0.0       # per-step scalar decay
    vorticity_eps: float = 0.0     # 3D vorticity confinement strength
    source_center: Tuple[float, float, float] = (0.9, 0.5, 0.5)  # fractional
    source_radius: float = 0.08    # fractional
    source_density: float = 1.0
    source_temperature: float = 1.0
    dtype: str = "float32"         # velocity and pressure
    scalar_dtype: str = "bfloat16"  # density and temperature storage
    max_impulses: ClassVar[int] = 16  # drag-queue slots (``Impulses``)

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def torch_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]

    @property
    def torch_sdtype(self) -> torch.dtype:
        return _DTYPES[self.scalar_dtype]


class SmokeState(NamedTuple):
    velocity: torch.Tensor     # [3, D, H, W]
    density: torch.Tensor      # [D, H, W]
    temperature: torch.Tensor  # [D, H, W]
    step: int                  # a Python int: it lives on the host


def _source_mask(cfg: SmokeConfig, device) -> torch.Tensor:
    """Spherical plume source near the bottom (axis-0 high side = ground),
    float32 on ``device``.  Built there in float64 with the JAX package's
    numpy operations in the same order, so the mask is the same bit for
    bit, and nothing crosses from the host."""
    rad = cfg.source_radius * min(cfg.shape)
    dist2 = 0.0
    for axis, (n, frac) in enumerate(zip(cfg.shape, cfg.source_center)):
        x = torch.arange(n, dtype=torch.float64, device=device) - frac * n
        view = [1, 1, 1]
        view[axis] = n
        dist2 = dist2 + (x * x).view(view)
    return (dist2 <= rad * rad).to(torch.float32)


def source_tensor(cfg: SmokeConfig, device) -> torch.Tensor:
    """The source mask in the scalar dtype on ``device``."""
    return _source_mask(cfg, device).to(cfg.torch_sdtype)


def plume_source(cfg: SmokeConfig, src: torch.Tensor) -> Source:
    """The step's source and buoyancy, from the mask ``src``."""
    return Source(src, cfg.dt * cfg.source_density,
                  cfg.dt * cfg.source_temperature, cfg.buoyancy_alpha,
                  cfg.buoyancy_beta)


def init_smoke(cfg: SmokeConfig, device="cuda") -> SmokeState:
    """Zero velocity, density and temperature on ``device``."""
    return SmokeState(
        velocity=torch.zeros((3,) + tuple(cfg.shape), dtype=cfg.torch_dtype,
                             device=device),
        density=torch.zeros(cfg.shape, dtype=cfg.torch_sdtype,
                            device=device),
        temperature=torch.zeros(cfg.shape, dtype=cfg.torch_sdtype,
                                device=device),
        step=0,
    )


def _cells(cfg: SmokeConfig) -> int:
    d, h, w = cfg.shape
    return d * h * w


def _use_pallas_advect3d(cfg: SmokeConfig, vel: torch.Tensor) -> bool:
    """K7: forced by ``advect_impl="pallas"``; under ``"auto"`` from 64^3
    up on CUDA tensors."""
    if cfg.advect_impl == "pallas":
        return True
    if cfg.advect_impl == "jnp":
        return False
    return _cells(cfg) >= 64 ** 3 and vel.is_cuda


def _use_pallas_sor3d(cfg: SmokeConfig, vel: torch.Tensor) -> bool:
    """K9: float32 RB-SOR only; forced by ``sor_impl="pallas"``; under
    ``"auto"`` from 128^3 up on CUDA tensors."""
    if cfg.solver != "sor" or cfg.torch_dtype != torch.float32:
        return False
    if cfg.sor_impl == "pallas":
        return True
    if cfg.sor_impl == "jnp":
        return False
    return _cells(cfg) >= 128 ** 3 and vel.is_cuda


def _use_fd3d_kernel(cfg: SmokeConfig, vel: torch.Tensor) -> bool:
    """K8: float32 velocity from 128^3 up on CUDA tensors, unless the
    advection is forced onto the eager ops."""
    return (cfg.torch_dtype == torch.float32 and _cells(cfg) >= 128 ** 3
            and vel.is_cuda and cfg.advect_impl != "jnp")


def _source_in_k7(vel, rho, temp, src) -> bool:
    """Whether K7's scalar launch applies the source and buoyancy: on the
    plume's dtypes (float32 velocity, bfloat16 scalars and mask)."""
    return (vel.dtype == torch.float32 and rho.dtype == torch.bfloat16
            and temp.dtype == torch.bfloat16 and src.dtype == torch.bfloat16)


def inject_and_buoy(vel, rho, temp, src, cfg: SmokeConfig):
    """Plume source and buoyancy (``smoke3d.py:169-179``) in eager ops
    (``ops/cuda/advect3d.py`` ``apply_source``).  The scalars round in
    their storage dtype after every op; the force is computed in the
    velocity dtype and subtracted from axis 0 of ``vel`` in place (``vel``
    is the fresh tensor the advection returned)."""
    return apply_source(vel, rho, temp, plume_source(cfg, src), cfg.dt)


def smoke_step(state: SmokeState, cfg: SmokeConfig,
               src: torch.Tensor | None = None,
               impulses: Impulses | None = None) -> SmokeState:
    """One plume step: advect, inject, buoyancy, optional vorticity
    confinement, drain ``impulses``, project, dissipate.  ``src`` is the
    source mask (``source_tensor``); ``make_smoke_step`` builds it once
    instead of every step.  ``impulses`` (``Impulses.from_lists(cfg,
    ...)``, positions ``(z, i, j)``) are written into the velocity in
    place, the last active slot winning at a repeated cell; None leaves
    the step as it is without a queue."""
    with span("fluid.smoke_step"):
        dt = cfg.dt
        vel, rho, temp = state.velocity, state.density, state.temperature
        if src is None:
            src = source_tensor(cfg, vel.device)

        # 1. advect everything through the current flow; 2-3. plume
        # source, buoyancy along -axis 0 (low indices are up)
        if _use_pallas_advect3d(cfg, vel):
            md = cfg.advect_max_disp
            vel = advect3d_kernel(vel, vel, dt, no_slip=True, max_disp=md)
            # rho + temp share one backtrace: one 2-channel call, which on
            # the plume's dtypes also applies the source and buoyancy
            fused = _source_in_k7(vel, rho, temp, src)
            if fused:
                scal = advect3d_source_kernel(
                    rho, temp, vel, dt, no_slip=False,
                    source=plume_source(cfg, src), max_disp=md)
            else:
                scal = advect3d_kernel(torch.stack([rho, temp]), vel, dt,
                                       no_slip=False, max_disp=md)
            rho, temp = scal[0], scal[1]
        else:
            fused = False
            vel = advect(vel, vel, dt, no_slip=True)
            rho = advect(rho, vel, dt, no_slip=False)
            temp = advect(temp, vel, dt, no_slip=False)
        if not fused:
            vel, rho, temp = inject_and_buoy(vel, rho, temp, src, cfg)
        if cfg.vorticity_eps > 0:   # smoke3d.py:180-182
            vel = vorticity_confinement(vel, cfg.vorticity_eps, dt, cfg.dx)
        if impulses is not None:
            # ``vel`` is this step's own tensor: drained in place, no copy
            vel = apply_impulses_(vel, impulses)

        # 4. pressure projection
        fd_kernel = _use_fd3d_kernel(cfg, vel)
        div = (divergence3d(vel, cfg.dx) if fd_kernel
               else divergence(vel, cfg.dx))
        if cfg.solver == "multigrid":
            p = multigrid_solve(div, cfg.dx, cycles=cfg.mg_cycles)
        elif _use_pallas_sor3d(cfg, vel):
            p = sor3d_solve(div, cfg.dx, cfg.sor_iters, cfg.omega,
                            chunk=cfg.sor_chunk)
        elif cfg.solver == "sor":
            p = sor_solve(div, cfg.dx, cfg.sor_iters, cfg.omega)
        else:
            raise ValueError(f"unknown solver {cfg.solver!r}")
        if fd_kernel:
            vel = subtract_gradient3d(vel, p, cfg.dx)
        else:
            vel = subtract_gradient(vel, p, cfg.dx)

        # 5. optional dissipation
        if cfg.dissipation > 0:
            decay = 1.0 - cfg.dissipation * dt
            rho = rho * decay
            temp = temp * decay

        return SmokeState(velocity=vel, density=rho, temperature=temp,
                          step=state.step + 1)


def make_smoke_step(cfg: SmokeConfig, donate: bool = True):
    """``(state, impulses=None) -> state`` specialized to ``cfg``.
    ``donate`` is accepted for the JAX signature; PyTorch has no
    counterpart.  The source mask is built once per device, on that
    device."""
    del donate
    masks = {}

    def fn(state: SmokeState, impulses: Impulses | None = None
           ) -> SmokeState:
        dev = state.velocity.device
        if dev not in masks:
            masks[dev] = source_tensor(cfg, dev)
        return smoke_step(state, cfg, masks[dev], impulses)

    return fn
