"""Sharded tiled-domain supergrid step (BASELINE config 4 over a mesh;
counterpart of ``esp32_fluid_simulation_tpu/parallel/sharded_tiled.py``).

A ``SimConfig.domain_tile`` supergrid packs independent ``(mh, mw)``
member domains into one grid; every boundary condition is a member wall.
Sharding that supergrid over the ``(x, y)`` mesh axes with each shard
owning WHOLE member tiles makes the step embarrassingly parallel: member
walls never cross shard boundaries, so no halo exchange is needed at all.
Each shard runs the ordinary tiled step (``models.stable_fluids.
_step_tiled``, the K6 member modes on the kernel path) on its local block;
only the impulse scatter is shard-aware (global positions shift into the
shard frame, out-of-shard writes drop).

The alignment requirement (mesh divides the grid, shard blocks divide
into whole members) is checked at build time.
"""

from __future__ import annotations

import dataclasses

import torch

from ..config import SimConfig
from ..state import SimState, Impulses
from ..models.ensemble import (_from_super, _member_impulse_targets,
                               _to_super, tiled_ensemble_config)
from ..models.stable_fluids import _step_tiled, write_cells
from .sharded import Shards, shard_state, unshard_state, unzip
from .topology import Mesh


def _shard_local_scatter(vel, rows, cols, vals, ox, oy, lh, lw):
    """Write ``vals`` (``[2, K]``) at the global ``(rows, cols)`` that fall
    in this shard's ``lh x lw`` block at ``(ox, oy)``; the others drop (as
    do the rows already routed past the grid)."""
    in_shard = ((rows >= ox) & (rows < ox + lh)
                & (cols >= oy) & (cols < oy + lw))
    cells = ((rows - ox).clamp(0, lh - 1) * lw
             + (cols - oy).clamp(0, lw - 1))
    return write_cells(cells, in_shard, vals, (lh, lw), base=vel)


def make_sharded_tiled_step(cfg: SimConfig, mesh: Mesh, donate: bool = True,
                            member_impulses: bool = False):
    """The sharded step ``(state, impulses) -> state`` of a
    ``domain_tile`` supergrid config (``state`` from
    ``parallel.shard_state``).

    ``member_impulses=False``: plain ``Impulses`` with supergrid-global
    positions (the ``step(state, impulses, cfg)`` contract for tiled
    configs).  ``member_impulses=True``: the ensemble-batched ``Impulses``
    with a leading ``[n_members]`` axis and member-local positions
    (``models.ensemble.stack_impulses``), resolved as the single-device
    supergrid resolves them.  ``donate`` is accepted for the JAX signature
    and has no effect on eager code.
    """
    del donate
    if cfg.domain_tile is None:
        raise ValueError("make_sharded_tiled_step needs a domain_tile "
                         "config; use make_sharded_step for one domain")
    h, w = cfg.shape
    mh, mw = cfg.domain_tile
    sh = Shards(mesh, cfg.shape)
    lh, lw = sh.lh, sh.lw
    if lh % mh or lw % mw:
        raise ValueError(
            f"shard blocks ({lh},{lw}) must contain whole member tiles "
            f"({mh},{mw}): pick a mesh whose (x,y) factors divide the "
            f"({h // mh},{w // mw}) member grid")
    local_cfg = dataclasses.replace(cfg, shape=(lh, lw))
    gh_g, gw_g = h // mh, w // mw   # the global member grid

    def targets(imp):
        """Global ``(rows, cols, vals)``; rows of slots that write nothing
        lie past the grid."""
        if member_impulses:
            return _member_impulse_targets(imp, gh_g, gw_g, mh, mw)
        # the same last-wins overwrite resolution as apply_impulses, on
        # supergrid-global positions
        k = imp.pos.shape[0]
        gi = imp.pos[:, 0].long().clamp(0, h - 1)
        gj = imp.pos[:, 1].long().clamp(0, w - 1)
        same = (gi[:, None] == gi[None, :]) & (gj[:, None] == gj[None, :])
        later = torch.ones((k, k), dtype=torch.bool,
                           device=gi.device).triu(1)
        superseded = (same & later & imp.active[None, :]).any(dim=1)
        rows = torch.where(imp.active & ~superseded, gi, h)
        return rows, gj, imp.velocity.T

    def step(state: SimState, imp: Impulses) -> SimState:
        imps = sh.replicate(imp)

        def one(a, b, vel, color, im):
            ox, oy = sh.origin(a, b)
            rows, cols, vals = targets(im)

            def apply_fn(v):
                return _shard_local_scatter(v, rows, cols, vals, ox, oy,
                                            lh, lw)
            return _step_tiled(SimState(vel, color, state.step), None,
                               local_cfg, apply_fn=apply_fn)
        vel, color = unzip(sh.map(one, state.velocity, state.color, imps),
                           2)
        return SimState(velocity=vel, color=color, step=state.step + 1)

    return step


def make_sharded_ensemble_step(member_cfg: SimConfig, mesh: Mesh, n: int,
                               donate: bool = True):
    """Ensemble API over the sharded supergrid: ``(SimState[n, ...],
    Impulses[n, ...]) -> SimState[n, ...]``, the mesh rendition of
    ``models.ensemble.make_ensemble_step(mode="tiled")``.  Returns
    ``(step, cfg_super)``.

    The member stack converts to the supergrid on its own device, is split
    over the mesh, stepped, and gathered back there.  ``donate`` is
    accepted for the JAX signature and has no effect on eager code."""
    del donate
    cfg_super, _, _ = tiled_ensemble_config(member_cfg, n)
    inner = make_sharded_tiled_step(cfg_super, mesh, member_impulses=True)

    def fn(state: SimState, imps: Impulses) -> SimState:
        sharded = shard_state(_to_super(state, cfg_super), cfg_super, mesh)
        out = unshard_state(inner(sharded, imps), state.velocity.device)
        return _from_super(out, member_cfg)

    return fn, cfg_super
