"""Ensembles of independent members (counterpart of
``esp32_fluid_simulation_tpu/models/ensemble.py``; BASELINE config 4: 256
independent 256^2 sims on one card for parameter sweeps).

An ensemble state is a member stack: ``SimState`` with velocity
``[n, 2, mh, mw]``, color ``[n, 3, mh, mw]`` and ``step`` a Python int, since
all members step together (the JAX package carries an ``[n]`` int32 step
array; ``interop.ensemble_state_{from,to}_numpy`` convert).  Members differ
in their impulse schedules (batched ``Impulses`` ``[n, K, 2]``,
``stack_impulses``); the config is shared.

``mode="auto"`` routes a compatible member config onto the tiled supergrid:
the members become the tiles of one grid (``tiled_ensemble_config``) whose
kernels evaluate every boundary condition per tile (K6: K1 and K2 with
``member=``, the impulses as K2's store-time ``overlay=``, built on the
card by ``ops.cuda.advect.member_overlay``), so the whole ensemble
advances in one kernel-path step (``stable_fluids._step_tiled``).  On the
kernel path with K1's trapezoid (``project_fused_takes_stack``) the
supergrid is only an addressing scheme: K2 and K1 read and write the member
stack in place, and the state is never laid out otherwise.  Elsewhere (the
eager ops, K1's sequence route) the member stack is converted to the
supergrid and back around the step.  The step's spans are
``fluid.ensemble_step``, ``fluid.ensemble.layout`` (each member stack <->
supergrid conversion, counted by ``layout_conversions``) and
``fluid.ensemble.overlay``.
``mode="vmap"`` steps each member through the port's ``step`` in a Python
loop — the kernel wrappers take one grid each — so it is the parity oracle,
not a fast path (JAX vmaps it into one program).
"""

from __future__ import annotations

import dataclasses

import torch

from ..config import SimConfig
from ..ops.cuda.advect import member_overlay
from ..ops.cuda.modes import member_grid
from ..ops.cuda.project import project_fused_takes_stack
from ..ops.impulses import member_cells, member_writes, write_cells
from ..spans import span
from ..state import SimState, Impulses
from .stable_fluids import (_from_members, _step_tiled, _to_members,
                            init_state, step, tiled_uses_kernels)


def init_ensemble(cfg: SimConfig, n: int, device="cuda") -> SimState:
    """n identical members (they diverge through per-member impulses)."""
    s = init_state(cfg, device)
    return SimState(
        velocity=s.velocity.expand((n,) + s.velocity.shape).contiguous(),
        color=s.color.expand((n,) + s.color.shape).contiguous(), step=0)


def stack_impulses(imps) -> Impulses:
    """[Impulses, ...] (one per member) -> batched Impulses ``[n, K, nd]``."""
    return Impulses(*(torch.stack(xs) for xs in zip(*imps)))


def _tiled_compatible(cfg: SimConfig) -> bool:
    """Can this member config run as one kernel-path supergrid step?"""
    return (cfg.ndim == 2 and cfg.advector == "semilag"
            and cfg.vorticity_eps == 0.0 and cfg.domain_tile is None
            and cfg.solver in ("sor", "fused_pallas")
            and min(cfg.shape) >= 32)


def _member_impulse_targets(imp: Impulses, gh: int, gw: int, mh: int,
                            mw: int):
    """``[n, K]`` member impulses -> supergrid targets ``(rows[n*K],
    cols[n*K], vals[nd, n*K])`` (``ops.impulses.member_writes``); the
    slots that write nothing get row ``gh*mh``, one past the grid."""
    n, k, nd = imp.pos.shape
    rows, cols, write = member_writes(imp, gw, mh, mw)
    rows = torch.where(write, rows, gh * mh)
    vals = imp.velocity.permute(2, 0, 1).reshape(nd, n * k)
    return rows.reshape(-1), cols.reshape(-1), vals


def _apply_member_impulses(vel, imp: Impulses, gh: int, gw: int, mh: int,
                           mw: int):
    """Batched per-member impulses onto the supergrid velocity: one scatter
    for all (member, slot) points (members write disjoint tiles)."""
    cells, write, vals = member_cells(imp, gh, gw, mh, mw)
    return write_cells(cells, write, vals, vel.shape[1:], base=vel)


def _resolve_tiled(cfg: SimConfig, mode: str) -> bool:
    """Shared mode validation of make_ensemble_step and its rollout."""
    if mode not in ("auto", "vmap", "tiled"):
        raise ValueError(f"unknown ensemble mode {mode!r}")
    if mode == "tiled" and not _tiled_compatible(cfg):
        raise ValueError("config is not tiled-ensemble compatible "
                         "(needs 2D semilag, no vorticity, sor/fused "
                         "solver)")
    return _tiled_compatible(cfg) if mode == "auto" else mode == "tiled"


# Under mode="auto" the member loop becomes an error, not a silent slowdown,
# from this member count on (the JAX package's guard, ensemble.py:119-137).
_AUTO_VMAP_GUARD_N = 64


def _guard_auto_vmap(cfg: SimConfig, n: int) -> None:
    if n >= _AUTO_VMAP_GUARD_N:
        raise ValueError(
            f"mode='auto' fell back to the vmap ensemble path for n={n} "
            f"members — this config ({cfg.advector=}, "
            f"{cfg.vorticity_eps=}, {cfg.solver=}) is not tiled-supergrid "
            f"compatible, and the member loop steps {n} grids one after "
            f"another.  Pass mode='vmap' explicitly to accept that cost, or "
            f"use a tiled-compatible member config (2D semilag, no "
            f"vorticity, solver='sor'/'fused_pallas').")


def layout_conversions() -> int:
    """Running total of state layout conversions, member stack to
    supergrid or back (``_to_super``, ``_from_super``): a permuting copy
    of the whole state each.  Read it by difference: ``make_ensemble_step``
    makes 2 a step and its rollout 2 a call, but none on the stack route
    (``_on_stack``)."""
    return _to_super.calls + _from_super.calls


def _to_super(state: SimState, cfg_super: SimConfig) -> SimState:
    """Member-stack ``[n, C, mh, mw]`` state -> one supergrid state."""
    with span("fluid.ensemble.layout"):
        h, w = cfg_super.shape
        _to_super.calls += 1
        return SimState(velocity=_from_members(state.velocity, h, w),
                        color=_from_members(state.color, h, w),
                        step=state.step)


def _from_super(out: SimState, cfg: SimConfig) -> SimState:
    """Supergrid state -> member-stack ``[n, C, mh, mw]`` state."""
    with span("fluid.ensemble.layout"):
        mh, mw = cfg.shape
        _from_super.calls += 1
        return SimState(velocity=_to_members(out.velocity, mh, mw),
                        color=_to_members(out.color, mh, mw), step=out.step)


_to_super.calls = 0
_from_super.calls = 0


def _step_members(state: SimState, imps: Impulses, cfg: SimConfig):
    """The "vmap" route: each member through ``step``, one after another."""
    outs = [step(SimState(state.velocity[m], state.color[m], state.step),
                 Impulses(*(x[m] for x in imps)), cfg)
            for m in range(state.velocity.shape[0])]
    return SimState(velocity=torch.stack([o.velocity for o in outs]),
                    color=torch.stack([o.color for o in outs]),
                    step=state.step + 1)


def _on_stack(cfg_super: SimConfig, vel: torch.Tensor) -> bool:
    """Whether the step runs on the member stack as it lies: the kernel
    path, with K1's trapezoid, the one K1 route that takes a stack."""
    return (tiled_uses_kernels(cfg_super, vel)
            and project_fused_takes_stack(cfg_super.sor_iters))


def _step_super(st: SimState, imps: Impulses, cfg_super: SimConfig, gh: int,
                gw: int) -> SimState:
    """One supergrid step with batched member impulses: on the kernel path
    they drain at the velocity advect's store (the overlay), otherwise
    through the scatter ``apply_fn``.  ``st`` lies on the supergrid, or
    as the member stack on the stack route (``_on_stack``)."""
    mh, mw = cfg_super.domain_tile
    imps = Impulses(*(t.to(st.velocity.device) for t in imps))
    overlay = None
    if tiled_uses_kernels(cfg_super, st.velocity):
        with span("fluid.ensemble.overlay"):
            overlay = member_overlay(imps, gh, gw, mh, mw)

    def apply_fn(v):
        return _apply_member_impulses(v, imps, gh, gw, mh, mw)

    return _step_tiled(st, None, cfg_super, apply_fn=apply_fn,
                       overlay=overlay)


def make_ensemble_step(cfg: SimConfig, donate: bool = True,
                       mode: str = "auto"):
    """Batched step ``(SimState[n, ...], Impulses[n, ...]) -> SimState``.

    ``mode="auto"`` (default) routes compatible configs onto the tiled
    supergrid and the whole ensemble advances in one kernel-path step;
    ``"vmap"`` forces the member loop (the parity oracle); ``"tiled"``
    requires a compatible config.  ``donate`` is accepted for the JAX
    signature (second, as there) and has no effect on eager code."""
    del donate
    if not _resolve_tiled(cfg, mode):
        def fn(state: SimState, imps: Impulses) -> SimState:
            with span("fluid.ensemble_step"):
                if mode == "auto":
                    _guard_auto_vmap(cfg, state.velocity.shape[0])
                return _step_members(state, imps, cfg)
        return fn

    def fn(state: SimState, imps: Impulses) -> SimState:
        with span("fluid.ensemble_step"):
            cfg_super, gh, gw = tiled_ensemble_config(
                cfg, state.velocity.shape[0])
            if _on_stack(cfg_super, state.velocity):
                return _step_super(state, imps, cfg_super, gh, gw)
            return _from_super(_step_super(_to_super(state, cfg_super),
                                           imps, cfg_super, gh, gw), cfg)
    return fn


def make_ensemble_multi_step(cfg: SimConfig, donate: bool = True,
                             mode: str = "auto"):
    """Ensemble rollout ``run(state, schedule) -> state``: ``schedule`` is
    an ``Impulses`` with leading ``[n_steps, n_members]`` axes
    (``stable_fluids.stack_schedule`` over per-step ``stack_impulses``).  On
    the tiled route off the stack route the member stack converts to and
    from the supergrid once per call instead of once per step.  ``donate``
    is accepted for the JAX signature and has no effect on eager code."""
    del donate
    if not _resolve_tiled(cfg, mode):
        def run(state: SimState, schedule: Impulses) -> SimState:
            if mode == "auto":
                _guard_auto_vmap(cfg, state.velocity.shape[0])
            for t in range(schedule.pos.shape[0]):
                state = _step_members(state, Impulses(*(x[t] for x in
                                                        schedule)), cfg)
            return state
        return run

    def run(state: SimState, schedule: Impulses) -> SimState:
        cfg_super, gh, gw = tiled_ensemble_config(cfg,
                                                  state.velocity.shape[0])
        on_stack = _on_stack(cfg_super, state.velocity)
        st = state if on_stack else _to_super(state, cfg_super)
        for t in range(schedule.pos.shape[0]):
            st = _step_super(st, Impulses(*(x[t] for x in schedule)),
                             cfg_super, gh, gw)
        return st if on_stack else _from_super(st, cfg)
    return run


def tiled_ensemble_config(member_cfg: SimConfig, n: int,
                          solver: str = "fused_pallas"):
    """Supergrid config for n member domains: the members become the tiles
    of a ``gh x gw`` grid (the most square factorization of n) and every
    boundary condition acts per tile (``SimConfig.domain_tile``).  Returns
    ``(supergrid_cfg, gh, gw)``."""
    gh, gw = member_grid(n)
    h, w = member_cfg.shape
    return dataclasses.replace(member_cfg, shape=(gh * h, gw * w),
                               domain_tile=(h, w), solver=solver), gh, gw


def tiled_member_impulses(cfg_super: SimConfig, member_cfg: SimConfig,
                          gh: int, gw: int, per_member,
                          device="cuda") -> Impulses:
    """Per-member impulse lists -> one supergrid ``Impulses`` batch.

    ``per_member``: a list of ``(pos_list, vel_list)`` per member (row-major
    over the ``(gh, gw)`` tile grid); positions are member-local and get
    offset to the member's tile origin.  The supergrid step applies at most
    ``cfg_super.max_impulses`` in all."""
    h, w = member_cfg.shape
    pos, vel = [], []
    for m, (ps, vs) in enumerate(per_member):
        oi, oj = (m // gw) * h, (m % gw) * w
        pos.extend((oi + p[0], oj + p[1]) for p in ps)
        vel.extend(vs)
    return Impulses.from_lists(cfg_super, pos, vel, device=device)
