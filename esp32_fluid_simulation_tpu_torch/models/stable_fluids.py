"""The stable-fluids dye bed step (counterpart of
``esp32_fluid_simulation_tpu/models/stable_fluids.py``).

``step(state, impulses) -> state`` is the reference's ``loop()``
(``.ino:249-289``):

  1. self-advect velocity (``.ino:251-256``, no-slip sampling),
  2. apply the drained drag queue (``.ino:258-269``),
  3. pressure projection: divergence -> RB-SOR -> gradient subtract
     (``.ino:271-278``),
  4. advect dye (``.ino:280-282``).

With ``solver="fused_pallas"`` the drain and the projection run in the K1
kernel (``ops/cuda/project.py``); with the kernel advect
(``_use_pallas_advect``) both advections run in K2 (``ops/cuda/advect.py``),
the dye clamp and, in ``step_render`` at ``scaling == 1``, the RGB565 frame
riding the dye store, or in K5 for ``advector="maccormack"``.
``solver="sor_pallas"`` solves in K4 (``ops/cuda/sor.py``).  Vorticity
confinement (``vorticity_eps > 0``) sits between the impulses and the
projection, as in the JAX step (``stable_fluids.py:294-317``).  A
``domain_tile`` config is a supergrid of independent member tiles
(``_step_tiled``): on the kernel path K2 and K1 run in their member modes
(K6) and the drag queue drains at the velocity advect's store; otherwise
each member steps on its own through the eager ops.  The kernel wrappers
run their plain PyTorch versions on CPU tensors.  PyTorch runs eagerly:
``make_step`` and friends return plain closures.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

from ..config import SimConfig
from ..spans import span
from ..state import SimState, Impulses
from ..ops.advect import advect, advect_maccormack, advect_rk2
from ..ops.blur import triangular_blur_inplace
from ..ops.fd import divergence, subtract_gradient, vorticity_confinement
from ..ops.poisson import (jacobi_solve, poisson_solve, poisson_residual,
                           sor_solve)
from ..ops.cuda.advect import advect_kernel, advect_maccormack_kernel
from ..ops.cuda.project import project_fused
from ..render.upscale import render_rgb565


def init_color(cfg: SimConfig, device="cuda") -> torch.Tensor:
    """Angular RGB sectors around the grid center, then two in-place
    [1/4,1/2,1/4] blurs in the storage dtype (``.ino:203-241``).

    With ``domain_tile`` every member tile gets its own (identical) sector
    init: the member pattern is built and blurred once, then tiled, so the
    blur never smears across member walls."""
    if cfg.domain_tile is not None:
        mh, mw = cfg.domain_tile
        member = init_color(dataclasses.replace(
            cfg, shape=(mh, mw), domain_tile=None, solver="sor"), device)
        return member.repeat(1, cfg.shape[0] // mh, cfg.shape[1] // mw)
    h, w = cfg.shape[-2], cfg.shape[-1]
    ci, cj = h // 2, w // 2
    ii = np.arange(h, dtype=np.float32)[:, None]
    jj = np.arange(w, dtype=np.float32)[None, :]
    # ``ci - ii`` (not ``-(ii - ci)``): the reference negates an *integer*
    # zero at the center row (.ino:210), yielding +0.0 and atan2 = +pi on the
    # left half; float ``-(ii-ci)`` would give -0.0 and -pi there.
    angle = np.arctan2(ci - ii, jj - cj)
    red = angle < -np.pi / 3
    green = (angle >= -np.pi / 3) & (angle < np.pi / 3)
    blue = ~(red | green)
    color = np.stack([red, green, blue]).astype(np.float32)  # [3, H, W]
    if cfg.ndim == 3:
        color = np.broadcast_to(color[:, None], (3,) + cfg.shape).copy()
    c = torch.from_numpy(color).to(device=device,
                                   dtype=cfg.torch_color_dtype)
    # horizontal (j) pass then vertical (i) pass (.ino:220-241)
    c = triangular_blur_inplace(c, axis=c.dim() - 1)
    c = triangular_blur_inplace(c, axis=c.dim() - 2)
    return c


def init_state(cfg: SimConfig, device="cuda") -> SimState:
    """Zero velocity + sector dye on ``device`` (``setup()``,
    ``.ino:194-241``)."""
    vel = torch.zeros((cfg.ndim,) + tuple(cfg.shape), dtype=cfg.torch_dtype,
                      device=device)
    return SimState(velocity=vel, color=init_color(cfg, device), step=0)


def _resolved_impulse_targets(imp: Impulses, shape):
    """Queue-drain resolution in slot space (``.ino:264-269``): each slot's
    cell, clamped to the grid, and the index of the LAST active slot that
    writes that cell (-1 where no active slot does)."""
    nd = len(shape)
    k = imp.pos.shape[0]
    idx = tuple(imp.pos[:, a].long().clamp(0, shape[a] - 1)
                for a in range(nd))
    same = idx[0][:, None] == idx[0][None, :]
    for ax in range(1, nd):
        same &= idx[ax][:, None] == idx[ax][None, :]
    slots = torch.arange(k, device=imp.pos.device)
    winner = torch.where(same & imp.active[None, :], slots[None, :],
                         torch.full_like(slots[None, :], -1)).amax(dim=1)
    return idx, winner


def apply_impulses(vel: torch.Tensor, imp: Impulses) -> torch.Tensor:
    """Write drag velocities into cells (``.ino:264-269``), the last active
    slot winning at a duplicated cell; positions are clamped to the grid.

    One scatter for all slots: every slot writes the value its cell ends
    with (the winner's, or the cell's own where no active slot writes it),
    so duplicate indices carry equal values and the write order does not
    matter — no host sync, no per-slot pass."""
    idx, winner = _resolved_impulse_targets(imp, vel.shape[1:])
    where = (slice(None),) + idx
    vals = imp.velocity.to(vel.dtype)[winner.clamp(min=0)].T   # [nd, k]
    out = vel.clone()
    out[where] = torch.where(winner >= 0, vals, vel[where])
    return out


def impulses_in_window(imp: Impulses, global_shape, origin,
                       shape) -> Impulses:
    """``imp`` in the frame of a ``shape`` window whose first cell sits at
    global ``origin`` of a ``global_shape`` grid (2D or 3D): positions
    clamped to the grid, then shifted; the slots whose cell lies outside
    the window become inactive, so ``apply_impulses`` on the window writes
    exactly the window's cells of the whole grid's drain."""
    idx = [imp.pos[:, a].long().clamp(0, global_shape[a] - 1) - origin[a]
           for a in range(len(global_shape))]
    inside = imp.active
    for x, n in zip(idx, shape):
        inside = inside & (x >= 0) & (x < n)
    return Impulses(pos=torch.stack(idx, dim=1).to(imp.pos.dtype),
                    velocity=imp.velocity, active=inside)


def write_cells(cells, write, vals, shape, base=None):
    """A ``[C, *shape]`` tensor: ``base`` (zeros when None, in ``vals``'
    dtype) with ``vals`` (``[C, K]``) written at the flat cell indices
    ``cells`` (``[K]``) where ``write``.  The other slots land in one spare
    element past the end and are dropped (JAX's ``mode="drop"``), so nothing
    waits on the host; the cells written must be distinct."""
    c, n = vals.shape[0], math.prod(shape)
    dev = vals.device
    if base is None:
        flat = torch.zeros(c * n + 1, dtype=vals.dtype, device=dev)
    else:
        flat = torch.empty(c * n + 1, dtype=base.dtype, device=dev)
        flat[:-1].copy_(base.reshape(-1))
        vals = vals.to(base.dtype)
    ch = torch.arange(c, device=dev)[:, None] * n
    idx = torch.where(write[None, :], ch + cells[None, :], c * n)
    flat[idx.reshape(-1)] = vals.reshape(-1)
    return flat[:-1].view((c,) + tuple(shape))


def overlay_from_targets(cells, write, vals, shape):
    """The dense ``[nd+1, *shape]`` float32 overlay of K2's store-time
    drain: channels ``[0, nd)`` the values written at ``cells`` where
    ``write``, channel ``nd`` a 1.0 write flag."""
    k = vals.shape[1]
    combo = torch.cat([vals.to(torch.float32),
                       torch.ones((1, k), dtype=torch.float32,
                                  device=vals.device)], dim=0)
    return write_cells(cells, write, combo, shape)


def impulse_overlay(imp: Impulses, shape) -> torch.Tensor:
    """Impulses as the dense ``[nd+1, *shape]`` float32 overlay consumed by
    K2's ``overlay=`` (``stable_fluids.py:119-136``): the same cells and
    bit-identical values as ``apply_impulses``, the last active slot winning
    at a duplicated cell."""
    idx, winner = _resolved_impulse_targets(imp, shape)
    slots = torch.arange(imp.pos.shape[0], device=imp.pos.device)
    cells = idx[0]
    for a in range(1, len(shape)):
        cells = cells * shape[a] + idx[a]
    return overlay_from_targets(cells, winner == slots, imp.velocity.T,
                                shape)


def _use_pallas_advect(cfg: SimConfig, vel: torch.Tensor) -> bool:
    """Whether the step advects through K2: forced by
    ``advect_impl="pallas"``; under ``"auto"`` from 512^2 up on CUDA
    tensors (smaller grids stay on the unclamped ``ops.advect`` path)."""
    if cfg.advector not in ("semilag", "maccormack") or cfg.ndim != 2:
        return False
    if cfg.advect_impl == "pallas":
        return True
    if cfg.advect_impl == "jnp":
        return False
    h, w = cfg.shape
    return h * w >= 512 * 512 and vel.is_cuda


def _advect_by(cfg: SimConfig, vel: torch.Tensor):
    """The advection for ``cfg`` (``stable_fluids.py:157-183``): K5 or the
    eager MacCormack, the eager RK2 (never a kernel), K2 or the eager
    semi-Lagrangian advect."""
    use_kernel = _use_pallas_advect(cfg, vel)
    if use_kernel and cfg.advect_sample_dtype != "float32":
        raise NotImplementedError(
            "advect_sample_dtype='bfloat16' is not ported (ROADMAP.md queue "
            "1, 'Not to port')")
    if cfg.advector == "maccormack":
        if not use_kernel:
            return advect_maccormack

        def adv_mc(field, vel, dt, no_slip):
            return advect_maccormack_kernel(field, vel, dt, no_slip,
                                            max_disp=cfg.advect_max_disp)
        return adv_mc
    if cfg.advector == "rk2":
        return advect_rk2
    if not use_kernel:
        return advect

    def adv(field, vel, dt, no_slip, clip01=False, self_advect=False):
        return advect_kernel(field, vel, dt, no_slip,
                             max_disp=cfg.advect_max_disp, clip01=clip01,
                             self_advect=self_advect)
    adv.fuses_clip01 = True
    adv.takes_self_advect = True
    return adv


def _self_advect(adv, vel, dt):
    """Velocity self-advect (``.ino:251-256``)."""
    if getattr(adv, "takes_self_advect", False):
        return adv(vel, vel, dt, no_slip=True, self_advect=True)
    return adv(vel, vel, dt, no_slip=True)


def _advect_color(adv, color, vel, cfg: SimConfig):
    clip = cfg.clamps_dye
    if clip and getattr(adv, "fuses_clip01", False):
        return adv(color, vel, cfg.dt, no_slip=False, clip01=True)
    color = adv(color, vel, cfg.dt, no_slip=False)
    return torch.clamp(color, 0.0, 1.0) if clip else color


def _project(vel: torch.Tensor, cfg: SimConfig,
             impulses: Impulses | None = None) -> torch.Tensor:
    """Pressure projection (``.ino:271-278``): composed ops, or K1 (which
    also drains ``impulses``)."""
    if cfg.solver == "fused_pallas":
        vel, _ = project_fused(vel, cfg.dx, cfg.sor_iters, cfg.omega,
                               impulses=impulses)
        return vel
    if impulses is not None:
        raise ValueError("the composed projection takes no impulses")
    p = poisson_solve(divergence(vel, cfg.dx), cfg)
    return subtract_gradient(vel, p, cfg.dx)


def _on_device(imp: Impulses, device) -> Impulses:
    return Impulses(*(t.to(device) for t in imp))


def _impulses_and_forces(vel: torch.Tensor, impulses: Impulses,
                         cfg: SimConfig) -> torch.Tensor:
    """The drained drag queue, then vorticity confinement when enabled
    (rank-polymorphic: the 2D curl or the 3D one)."""
    vel = apply_impulses(vel, impulses)
    if cfg.vorticity_eps > 0.0:
        vel = vorticity_confinement(vel, cfg.vorticity_eps, cfg.dt, cfg.dx)
    return vel


def _to_members(x: torch.Tensor, mh: int, mw: int) -> torch.Tensor:
    """``[C, gh*mh, gw*mw]`` -> ``[gh*gw, C, mh, mw]`` (tiled domain ->
    member stack, row-major over the tile grid)."""
    c, h, w = x.shape
    gh, gw = h // mh, w // mw
    return (x.reshape(c, gh, mh, gw, mw).permute(1, 3, 0, 2, 4)
            .reshape(gh * gw, c, mh, mw))


def _from_members(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """``[gh*gw, C, mh, mw]`` -> ``[C, h, w]``, the inverse of
    ``_to_members``."""
    n, c, mh, mw = x.shape
    gh, gw = h // mh, w // mw
    return (x.reshape(gh, gw, c, mh, mw).permute(2, 0, 3, 1, 4)
            .reshape(c, h, w))


def tiled_uses_kernels(cfg: SimConfig, vel: torch.Tensor) -> bool:
    """Whether ``_step_tiled`` takes the kernel path: the fused projection
    and the kernel advect."""
    return cfg.solver == "fused_pallas" and _use_pallas_advect(cfg, vel)


def _step_tiled(state: SimState, impulses: Impulses | None, cfg: SimConfig,
                apply_fn=None, overlay=None, rgb565: bool = False,
                bswap: bool = True):
    """Tiled-domain step (``stable_fluids.py:209-291``): one supergrid of
    independent ``cfg.domain_tile`` members, every boundary condition acting
    per member tile.

    ``apply_fn(vel) -> vel`` overrides the impulse application on both
    paths (the ensemble injects its per-member impulses there); then
    ``impulses`` are not applied.  ``overlay`` (an ``impulse_overlay``-shaped
    ``[3, H, W]`` tensor) is the kernel path's form of the drain: it rides
    the velocity advect's store (K2 ``overlay=``), and is built from
    ``impulses`` when neither it nor ``apply_fn`` is given.  ``rgb565``
    (kernel path only) also returns the frame packed on the member-mode dye
    store: ``(state, frame)``.

    The kernel path runs K2 with ``member=`` twice and K1 with ``member=``
    once.  The eager path steps each member on its own grid through the
    composed ops in a loop (JAX vmaps them), then clips the dye."""
    mh, mw = cfg.domain_tile
    h, w = cfg.shape
    if impulses is not None:
        impulses = _on_device(impulses, state.velocity.device)
    custom_apply = apply_fn is not None
    if apply_fn is None:
        def apply_fn(v):
            return apply_impulses(v, impulses)
    use_kernel = tiled_uses_kernels(cfg, state.velocity)
    if rgb565 and not use_kernel:
        raise ValueError("rgb565 needs the tiled kernel path "
                         "(solver='fused_pallas' + kernel advect)")
    if use_kernel:
        if cfg.advect_sample_dtype != "float32":
            raise NotImplementedError(
                "advect_sample_dtype='bfloat16' is not ported (ROADMAP.md "
                "queue 1, 'Not to port')")

        def adv(field, vel, no_slip, **kw):
            return advect_kernel(field, vel, cfg.dt, no_slip,
                                 max_disp=cfg.advect_max_disp,
                                 member=(mh, mw), **kw)

        # a caller's apply_fn overrides the impulses: the overlay is built
        # from them only when the default applier would have run
        if overlay is None and impulses is not None and not custom_apply:
            overlay = impulse_overlay(impulses, (h, w))
        if overlay is not None:
            vel = adv(state.velocity, state.velocity, True, self_advect=True,
                      overlay=overlay)
        else:
            vel = apply_fn(adv(state.velocity, state.velocity, True,
                               self_advect=True))
        vel, _ = project_fused(vel, cfg.dx, cfg.sor_iters, cfg.omega,
                               member=(mh, mw))
        if rgb565:
            color, frame = adv(state.color, vel, False, clip01=True,
                               rgb565=True, bswap=bswap)
            return SimState(velocity=vel, color=color,
                            step=state.step + 1), frame
        color = adv(state.color, vel, False, clip01=True)
        return SimState(velocity=vel, color=color, step=state.step + 1)

    def project_member(v):
        d = divergence(v, cfg.dx)
        if cfg.solver == "jacobi":
            p = jacobi_solve(d, cfg.dx, cfg.sor_iters, min(cfg.omega, 1.0))
        else:
            p = sor_solve(d, cfg.dx, cfg.sor_iters, cfg.omega)
        return subtract_gradient(v, p, cfg.dx)

    vel_m = torch.stack([advect(v, v, cfg.dt, no_slip=True)
                         for v in _to_members(state.velocity, mh, mw)])
    vel = apply_fn(_from_members(vel_m, h, w))
    vel_m = torch.stack([project_member(v)
                         for v in _to_members(vel, mh, mw)])
    col_m = torch.stack([advect(c, v, cfg.dt, no_slip=False) for c, v in
                         zip(_to_members(state.color, mh, mw), vel_m)])
    color = torch.clamp(_from_members(col_m, h, w), 0.0, 1.0)
    return SimState(velocity=_from_members(vel_m, h, w), color=color,
                    step=state.step + 1)


def step(state: SimState, impulses: Impulses, cfg: SimConfig) -> SimState:
    """One simulation step — the reference's ``loop()`` (``.ino:249-289``).
    ``impulses`` may lie on the CPU; they follow the state's device."""
    if cfg.domain_tile is not None:
        return _step_tiled(state, impulses, cfg)
    impulses = _on_device(impulses, state.velocity.device)
    adv = _advect_by(cfg, state.velocity)
    vel = _self_advect(adv, state.velocity, cfg.dt)
    if cfg.solver == "fused_pallas" and cfg.vorticity_eps == 0.0:
        # K1 drains the queue itself (same .ino:258-278 order)
        vel = _project(vel, cfg, impulses=impulses)
    else:
        # confinement sits between the impulses and the projection, so
        # this order keeps the drain out of K1
        vel = _project(_impulses_and_forces(vel, impulses, cfg), cfg)
    color = _advect_color(adv, state.color, vel, cfg)
    return SimState(velocity=vel, color=color, step=state.step + 1)


def step_render(state: SimState, impulses: Impulses, cfg: SimConfig,
                bswap: bool = True):
    """One step plus its RGB565 frame: ``(state, frame)``.

    At ``cfg.scaling == 1`` on the kernel path the pack rides the K2 dye
    store (bit-identical to ``render_rgb565(state.color, s=1)``), on a
    ``domain_tile`` supergrid the member-mode one; otherwise the render
    follows the step."""
    with span("fluid.step_render"):
        fused = (cfg.ndim == 2 and cfg.scaling == 1 and cfg.clamps_dye
                 and cfg.advector == "semilag" and cfg.vorticity_eps == 0.0
                 and cfg.solver == "fused_pallas"
                 and _use_pallas_advect(cfg, state.velocity))
        if fused and cfg.domain_tile is not None:
            return _step_tiled(state, impulses, cfg, rgb565=True, bswap=bswap)
        if not fused:
            st = step(state, impulses, cfg)
            return st, render_rgb565(st.color, s=cfg.scaling, bswap=bswap,
                                     unit_range=cfg.clamps_dye)
        impulses = _on_device(impulses, state.velocity.device)
        adv = _advect_by(cfg, state.velocity)
        vel = _self_advect(adv, state.velocity, cfg.dt)
        vel = _project(vel, cfg, impulses=impulses)
        color, frame = advect_kernel(state.color, vel, cfg.dt, False,
                                     max_disp=cfg.advect_max_disp, clip01=True,
                                     rgb565=True, bswap=bswap)
        return SimState(velocity=vel, color=color, step=state.step + 1), frame


def make_step(cfg: SimConfig, donate: bool = True):
    """``(state, impulses) -> state`` specialized to ``cfg``.  ``donate``
    is accepted for the JAX signature and has no effect on this eager
    closure (it keeps no buffers of its own to reuse)."""
    del donate
    return functools.partial(step, cfg=cfg)


def make_step_render(cfg: SimConfig, bswap: bool = True,
                     donate: bool = True):
    """``(state, impulses) -> (state, rgb565_frame)`` — see
    :func:`step_render`.  ``donate`` is accepted for the JAX signature and
    has no effect on this eager closure."""
    del donate
    return functools.partial(step_render, cfg=cfg, bswap=bswap)


def step_with_metrics(state: SimState, impulses: Impulses, cfg: SimConfig):
    """Step plus on-device observability (``stable_fluids.py:391-424``):
    ``(state, metrics)`` with the pre/post-projection divergence maxima,
    the Poisson residual norm, the max speed and a finiteness flag, each a
    0-dim tensor on the state's device (nothing is read back here).

    As in the JAX package, the impulses are scattered before the
    projection (K1 runs without them), the dye advects without the fused
    clamp, clipped after for ``semilag``/``rk2``, and ``domain_tile`` is
    ignored: the whole grid steps as one domain."""
    impulses = _on_device(impulses, state.velocity.device)
    adv = _advect_by(cfg, state.velocity)
    vel = _self_advect(adv, state.velocity, cfg.dt)
    vel = _impulses_and_forces(vel, impulses, cfg)

    div = divergence(vel, cfg.dx)
    if cfg.solver == "fused_pallas":
        vel, p = project_fused(vel, cfg.dx, cfg.sor_iters, cfg.omega)
    else:
        p = poisson_solve(div, cfg)
        vel = subtract_gradient(vel, p, cfg.dx)
    div_post = divergence(vel, cfg.dx)

    color = adv(state.color, vel, cfg.dt, no_slip=False)
    if cfg.advector in ("semilag", "rk2"):
        color = torch.clamp(color, 0.0, 1.0)

    res = poisson_residual(p, div, cfg.dx)
    metrics = {
        "div_pre_max": torch.max(torch.abs(div)),
        "div_post_max": torch.max(torch.abs(div_post)),
        "poisson_residual_l2": torch.sqrt(torch.mean(res * res)),
        "max_speed": torch.sqrt(torch.max(torch.sum(vel * vel, dim=0))),
        "finite": (torch.isfinite(vel).all()
                   & torch.isfinite(color).all()),
    }
    return SimState(velocity=vel, color=color, step=state.step + 1), metrics


def make_step_with_metrics(cfg: SimConfig, donate: bool = True):
    """``(state, impulses) -> (state, metrics)`` — see
    :func:`step_with_metrics`.  ``donate`` is accepted for the JAX
    signature and has no effect on this eager closure."""
    del donate
    return functools.partial(step_with_metrics, cfg=cfg)


def make_multi_step(cfg: SimConfig, donate: bool = True):
    """``run(state, schedule) -> state``: ``n`` steps, where ``schedule`` is
    an ``Impulses`` with a leading ``[n]`` axis (``stack_schedule``).  A
    plain loop for now.  ``donate`` is accepted for the JAX signature and
    has no effect on this eager loop."""
    del donate
    def run(state: SimState, schedule: Impulses) -> SimState:
        for t in range(schedule.pos.shape[0]):
            state = step(state, Impulses(*(x[t] for x in schedule)), cfg)
        return state

    return run


def stack_schedule(imps) -> Impulses:
    """[Impulses, ...] (one per step) -> schedule with a leading [n]."""
    return Impulses(*(torch.stack(xs) for xs in zip(*imps)))
