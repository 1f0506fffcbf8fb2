"""The sharded simulation step: the whole of ``loop()`` (``.ino:249-289``)
over the ``(x, y)`` shards of a device mesh (counterpart of
``esp32_fluid_simulation_tpu/parallel/sharded.py``).

A sharded state is a ``SimState`` whose ``velocity`` and ``color`` are
grids of per-shard blocks, ``blocks[x][y]``, each on its mesh device
(``shard_state`` / ``unshard_state``).  On a mesh that spans processes
(``topology.make_process_mesh``, ``dcn.py``) every process runs the same
step and holds only its own blocks (None at the others'); the exchanges,
the multigrid's gathered coarse level and the metrics cross processes
through ``torch.distributed`` (``parallel.halo``).  Every field is partitioned over the
trailing two spatial axes; each stencil pass exchanges exactly the strips
it needs (``parallel.halo``) and the boundary conditions act at the
*global* edges.  Per step, as in the JAX package:

* advection: one ``max_disp+1``-wide exchange per axis per advected field
  (MacCormack adds the backward pass);
* projection: the kernel routes run the whole solve per shard after ONE
  wide exchange (K1 block mode with ``2*iters+2`` ghosts, K4 block mode
  with ``2*iters``); the eager SOR exchanges a ``sor_halo``-wide strip once
  per ``sor_halo`` half-sweeps (trapezoidal validity), Jacobi once per
  ``sor_halo`` iterations; multigrid smooths with 1-wide exchanges per
  level and gathers the small replicated coarse ladder once per V-cycle;
* divergence/gradient/vorticity: 1-wide exchanges, each velocity component
  only along its own difference axis.

Routes: ``solver="fused_pallas"`` with ``advect_impl="pallas"`` runs K2 and
K1 in block mode (K11), the drain inside K1 and the dye clip inside K2, as
the single-device step does; ``solver="sor_pallas"`` K4 in block mode;
``advector="maccormack"`` with ``advect_impl="pallas"`` K2 in block mode
with ``return_minmax``.  Kernel advection runs only for ``advect_impl ==
"pallas"``, as in the JAX sharded step (``sharded.py:115-116``): ``"auto"``
takes the eager route even on CUDA.  On the kernel routes a shard's result
equals the single-device step's cells to the bit; the eager advection
rebases its coordinates into the shard window (``si - ox + k``), which may
round, so it agrees to float tolerance.
"""

from __future__ import annotations

import torch

from ..config import SimConfig
from ..state import SimState, Impulses
from ..models.stable_fluids import apply_impulses, impulses_in_window
from ..ops.advect import noslip_axis_factor, sample_linear
from ..ops.cuda.advect import advect_kernel
from ..ops.cuda.project import project_fused
from ..ops.cuda.sor import diag_at, sor_solve_kernel, walls_at
from ..ops.multigrid import _coarse_shapes, _vcycle, multigrid_solve
from ..ops.poisson import _shift_zero, neg_inv_of
from ..render.upscale import pack_rgb565, upscale_bilinear
from .halo import all_gather_blocks, all_reduce, exchange_halo, on_device
from .topology import BATCH_AXIS, Mesh, X_AXIS, Y_AXIS


class Shards:
    """The ``(x, y)`` shards of one batch row (``row``) of a mesh over an
    ``H x W`` or ``D x H x W`` domain (the trailing two axes split, a
    vertical axis whole on every shard): each shard's device, the process
    that owns it and the origin of its ``lh x lw`` owned block.  This is
    the layout a sharded state follows (``sharded_state_sharding``).

    On a mesh that spans processes this process holds only its own blocks:
    ``map`` and ``split`` touch those and leave None at the others, and
    ``ranks`` (None on a single-process mesh) names every block's owner for
    the exchanges.  On a batched mesh the step runs on one batch row: JAX
    replicates it over ``batch``, the port computes it once."""

    def __init__(self, mesh: Mesh, shape, row: int = 0):
        nx, ny = mesh.shape[X_AXIS], mesh.shape[Y_AXIS]
        h, w = shape[-2:]
        if h % nx or w % ny:
            raise ValueError(f"grid {tuple(shape)} not divisible by mesh "
                             f"({nx},{ny})")
        self.nx, self.ny = nx, ny
        self.shape = tuple(shape)
        self.lh, self.lw = h // nx, w // ny
        self.devices = [[mesh.devices[row, a, b] for b in range(ny)]
                        for a in range(nx)]
        owners = mesh.ranks[row]
        self.ranks = (owners.tolist() if (owners != mesh.rank).any()
                      else None)
        self.cells = [(a, b) for a in range(nx) for b in range(ny)
                      if owners[a, b] == mesh.rank]
        if not self.cells:
            raise ValueError(f"process {mesh.rank} owns no shard of batch "
                             f"row {row} of {mesh}")
        self.home = self.devices[self.cells[0][0]][self.cells[0][1]]

    def origin(self, a, b):
        return a * self.lh, b * self.lw

    def map(self, fn, *grids):
        """``[[fn(a, b, *blocks)]]`` over this process's shards, each call
        with its shard's device current; None at the others."""
        out = [[None] * self.ny for _ in range(self.nx)]
        for a, b in self.cells:
            with on_device(self.devices[a][b]):
                out[a][b] = fn(a, b, *(g[a][b] for g in grids))
        return out

    def split(self, x: torch.Tensor):
        """A ``[..., H, W]`` tensor -> the grid of its owned blocks, each a
        fresh contiguous tensor on its shard's device."""
        def one(a, b):
            ox, oy = self.origin(a, b)
            part = x[..., ox:ox + self.lh, oy:oy + self.lw]
            blk = torch.empty(part.shape, dtype=x.dtype,
                              device=self.devices[a][b])
            return blk.copy_(part)
        return self.map(one)

    def replicate(self, imp: Impulses):
        """``imp`` on every shard's device (one copy per distinct
        device)."""
        copies = {}

        def one(a, b):
            dev = self.devices[a][b]
            if dev not in copies:
                copies[dev] = Impulses(*(t.to(dev) for t in imp))
            return copies[dev]
        return self.map(one)

    def exchange(self, blocks, width, dim, axis, bc="zero"):
        """``halo.exchange_halo`` over this layout's processes."""
        return exchange_halo(blocks, width, dim, axis, bc, ranks=self.ranks)

    def exchange2(self, blocks, width, bcs=("zero", "zero")):
        """``_exchange2`` over this layout's processes."""
        return _exchange2(blocks, width, bcs, ranks=self.ranks)


def unzip(grid, n):
    """A grid of ``n``-tuples (None where another process owns the shard)
    -> ``n`` grids."""
    return tuple([[None if cell is None else cell[i] for cell in row]
                  for row in grid] for i in range(n))


def gather(blocks, device) -> torch.Tensor:
    """A grid of blocks -> the whole ``[..., H, W]`` tensor on ``device``.
    A grid that spans processes (None at the blocks of others) is gathered
    from all of them (``halo.all_gather_blocks``): every process calls it
    and gets the whole tensor."""
    if any(blk is None for row in blocks for blk in row):
        blocks = all_gather_blocks(blocks)
    return torch.cat([torch.cat([blk.to(device) for blk in row], dim=-1)
                      for row in blocks], dim=-2)


def sharded_state_sharding(cfg: SimConfig, mesh: Mesh, batched: bool = False):
    """The layout of a ``SimState`` of ``cfg`` on ``mesh``: velocity and
    dye split over the ``(x, y)`` mesh axes (the trailing two; a 3D grid's
    vertical axis stays whole), ``step`` a host int.  ``batched``: a member
    stack ``[n, C, ...]`` whose leading axis is split over the ``batch``
    mesh axis as well (JAX's ``P("batch", None, ..., "x", "y")``), one
    ``Shards`` per batch row."""
    if batched:
        return [Shards(mesh, cfg.shape, row)
                for row in range(mesh.shape[BATCH_AXIS])]
    return Shards(mesh, cfg.shape)


def _members(n, rows):
    if n % rows:
        raise ValueError(f"{n} members not divisible by batch={rows}")
    return n // rows


def shard_state(state: SimState, cfg: SimConfig, mesh: Mesh,
                batched: bool = False) -> SimState:
    """A ``SimState`` -> its sharded form: velocity and dye as grids of
    owned blocks on the mesh devices (the counterpart of
    ``jax.device_put(state, sharded_state_sharding(cfg, mesh, batched))``).
    ``batched``: ``state`` is a member stack; each field becomes one grid
    per batch row, ``[row][x][y]``, batch row ``r`` holding members
    ``r*m:(r+1)*m`` of ``m = n / batch``."""
    sh = sharded_state_sharding(cfg, mesh, batched)
    if not batched:
        return SimState(velocity=sh.split(state.velocity),
                        color=sh.split(state.color), step=state.step)
    m = _members(state.velocity.shape[0], len(sh))

    def rows(x):
        return [row.split(x[r * m:(r + 1) * m]) for r, row in enumerate(sh)]
    return SimState(velocity=rows(state.velocity), color=rows(state.color),
                    step=state.step)


def unshard_state(sharded: SimState, device="cuda",
                  batched: bool = False) -> SimState:
    """A sharded state -> one ``SimState`` on ``device`` (a member stack
    where ``batched``)."""
    device = torch.device(device)

    def whole(grids):
        if not batched:
            return gather(grids, device)
        return torch.cat([gather(g, device) for g in grids], dim=0)
    return SimState(velocity=whole(sharded.velocity),
                    color=whole(sharded.color), step=sharded.step)


def _aii(gi, gj, h, w):
    """The Neumann diagonal of the cells at global rows ``gi`` and columns
    ``gj`` of an ``h x w`` domain."""
    return diag_at(walls_at(gi, gj, h, w))


def _exchange2(x, width, bcs=("zero", "zero"), ranks=None):
    """Exchange along x, then along y on the x-padded blocks: that order
    fills the corner ghosts (``sharded.py:67-70``)."""
    x = exchange_halo(x, width, -2, X_AXIS, bcs[0], ranks=ranks)
    return exchange_halo(x, width, -1, Y_AXIS, bcs[1], ranks=ranks)


def _channel(grid, c):
    return [[None if blk is None else blk[c] for blk in row] for row in grid]


def check_max_disp(cfg, max_disp, use_kernel_advect):
    """The advection's CFL clamp: ``max_disp``, None meaning
    ``cfg.advect_max_disp``; kernel advection, whose clamp the
    single-device step takes from that field, refuses another value."""
    if max_disp is None:
        return cfg.advect_max_disp
    if use_kernel_advect and max_disp != cfg.advect_max_disp:
        raise ValueError(
            f"max_disp={max_disp} differs from cfg.advect_max_disp="
            f"{cfg.advect_max_disp}, the kernel advection's clamp")
    return max_disp


def mesh_metrics(sh: Shards, div_pre, div_post, res, vel, color,
                 n_cells: float):
    """The SURVEY §5 observability scalars of a sharded step: each shard's
    reductions combined over the shards (and over the processes of a mesh
    that spans them), 0-dim tensors on this process's first shard's
    device."""
    def reduce(grid, fn, combine, op):
        part = combine(torch.stack([fn(blk).to(sh.home) for row in grid
                                    for blk in row if blk is not None]))
        return part if sh.ranks is None else all_reduce(part, op)

    def gmax(grid):
        return reduce(grid, torch.max, torch.max, "max")

    nonfinite = sh.map(lambda a, b, v, c: (
        (~torch.isfinite(v)).sum() + (~torch.isfinite(c)).sum()), vel, color)
    return {
        "div_pre_max": gmax(sh.map(lambda a, b, x: torch.abs(x), div_pre)),
        "div_post_max": gmax(sh.map(lambda a, b, x: torch.abs(x),
                                    div_post)),
        "poisson_residual_l2": torch.sqrt(reduce(
            sh.map(lambda a, b, r: r * r, res), torch.sum, torch.sum, "sum")
            / n_cells),
        "max_speed": torch.sqrt(gmax(sh.map(
            lambda a, b, v: torch.sum(v * v, dim=0), vel))),
        "finite": reduce(nonfinite, lambda x: x, torch.sum, "sum") == 0,
    }


def make_sharded_step(cfg: SimConfig, mesh: Mesh,
                      max_disp: int | None = None, donate: bool = True,
                      sor_halo: int = 1, with_metrics: bool = False):
    """Build the sharded ``step(state, impulses) -> state`` over ``mesh``
    (``state`` from ``shard_state``; ``impulses`` with global positions,
    on any device).

    ``max_disp``: advection CFL clamp in cells; it sets the advection halo.
    None means ``cfg.advect_max_disp``; kernel advection, whose clamp the
    single-device step takes from that field, refuses another value.
    ``sor_halo``: the eager SOR's pressure-halo depth; k trades k-ring
    redundant compute for ~k-fold fewer exchanges.  ``with_metrics``:
    return ``(state, metrics)`` with mesh-reduced observability scalars
    (see ``make_sharded_step_with_metrics``).  A 3D ``cfg`` goes to
    ``parallel.sharded3d.make_sharded_step_3d``.  ``donate`` is accepted
    for the JAX signature and has no effect on eager code.
    """
    del donate
    if cfg.ndim == 3:
        from .sharded3d import make_sharded_step_3d
        return make_sharded_step_3d(cfg, mesh, max_disp=max_disp,
                                    sor_halo=sor_halo,
                                    with_metrics=with_metrics)
    if cfg.domain_tile is not None:
        # Running a tiled-domain config as a plain single-domain sharded
        # step would silently drop every member-wall boundary condition.
        raise NotImplementedError(
            "make_sharded_step does not run domain_tile configs; use "
            "parallel.sharded_tiled.make_sharded_tiled_step or a single "
            "device")
    if cfg.advector not in ("semilag", "maccormack", "rk2"):
        raise NotImplementedError(
            f"sharded step supports advector='semilag'/'maccormack'/'rk2', "
            f"got {cfg.advector!r}")
    if cfg.solver not in ("sor", "jacobi", "multigrid", "sor_pallas",
                          "fused_pallas"):
        raise NotImplementedError(
            f"sharded step supports solver='sor'/'jacobi'/'multigrid'/"
            f"'sor_pallas'/'fused_pallas', got {cfg.solver!r}")
    use_kernel_advect = (cfg.advect_impl == "pallas"
                         and cfg.advector in ("semilag", "maccormack"))
    if use_kernel_advect and cfg.advect_sample_dtype != "float32":
        raise NotImplementedError(
            "advect_sample_dtype='bfloat16' is not ported (ROADMAP.md queue "
            "1, 'Not to port')")
    max_disp = check_max_disp(cfg, max_disp, use_kernel_advect)
    sh = Shards(mesh, cfg.shape)
    H, W = cfg.shape
    lh, lw = sh.lh, sh.lw
    k = max_disp + 1
    dt, dx, iters = cfg.dt, cfg.dx, cfg.sor_iters
    f32 = torch.float32

    def coords(a, b):
        """This shard's global row and column indices, int64
        ``[lh, 1]`` / ``[1, lw]``."""
        ox, oy = sh.origin(a, b)
        dev = sh.devices[a][b]
        return (torch.arange(lh, device=dev)[:, None] + ox,
                torch.arange(lw, device=dev)[None, :] + oy)

    fcoords = sh.map(lambda a, b: tuple(
        c.to(f32).expand(lh, lw) for c in coords(a, b)))

    def advect_local(field, vel, no_slip, sign=1.0, return_minmax=False,
                     clip01=False):
        """Backtrace + gather in a k-halo window; global-coordinate
        clamps (K2 block mode on the kernel route)."""
        fpad = sh.exchange2(field, k)
        if use_kernel_advect:
            def kern(a, b, f, v):
                return advect_kernel(
                    f, v if sign == 1.0 else -v, dt, no_slip,
                    max_disp=max_disp, clip01=clip01,
                    return_minmax=return_minmax,
                    global_offset=sh.origin(a, b), global_shape=(H, W),
                    halo=k)
            return sh.map(kern, fpad, vel)

        def eager(a, b, f, v):
            gi, gj = fcoords[a][b]
            ox, oy = sh.origin(a, b)
            si_raw = gi - sign * v[0].to(f32) * dt
            sj_raw = gj - sign * v[1].to(f32) * dt
            # CFL clamp to the halo, then the reference domain clamp
            si = torch.clamp(torch.clamp(si_raw, gi - max_disp,
                                         gi + max_disp), 0.0, H - 1.0)
            sj = torch.clamp(torch.clamp(sj_raw, gj - max_disp,
                                         gj + max_disp), 0.0, W - 1.0)
            # window row 0 is global row ox - k
            res = sample_linear(f, (si - float(ox) + float(k),
                                    sj - float(oy) + float(k)),
                                no_slip=False, return_minmax=return_minmax)
            out, extra = (res[0], res[1:]) if return_minmax else (res, ())
            if no_slip:
                out = out * (noslip_axis_factor(si_raw, H)
                             * noslip_axis_factor(sj_raw, W)).to(out.dtype)
            if clip01:
                out = torch.clamp(out, 0.0, 1.0)
            return (out, *extra) if return_minmax else out
        return sh.map(eager, fpad, vel)

    def rk2_local(field, vel, no_slip):
        """Midpoint backtrace (``ops.advect.advect_rk2``, shard-local):
        sample the velocity at x - dt/2·v(x) from a k-halo window, then
        trace the full step through it.  Both stages CFL-clamp to the
        halo."""
        vpad = sh.exchange2(vel, k)
        fpad = sh.exchange2(field, k)

        def one(a, b, f, v, vp):
            gi, gj = fcoords[a][b]
            ox, oy = sh.origin(a, b)

            def window_coords(ci_raw, cj_raw):
                ci = torch.clamp(torch.clamp(ci_raw, gi - max_disp,
                                             gi + max_disp), 0.0, H - 1.0)
                cj = torch.clamp(torch.clamp(cj_raw, gj - max_disp,
                                             gj + max_disp), 0.0, W - 1.0)
                return (ci - float(ox) + float(k),
                        cj - float(oy) + float(k))

            v0, v1 = v[0].to(f32), v[1].to(f32)
            v_mid = sample_linear(vp, window_coords(gi - 0.5 * dt * v0,
                                                    gj - 0.5 * dt * v1))
            si_raw = gi - v_mid[0].to(f32) * dt
            sj_raw = gj - v_mid[1].to(f32) * dt
            out = sample_linear(f, window_coords(si_raw, sj_raw))
            if no_slip:
                out = out * (noslip_axis_factor(si_raw, H)
                             * noslip_axis_factor(sj_raw, W)).to(out.dtype)
            return out
        return sh.map(one, fpad, vel, vpad)

    def advect_dispatch(field, vel, no_slip, clip01=False):
        """The configured advection; ``clip01`` clamps the result (fused
        into K2 on the kernel route)."""
        if cfg.advector == "rk2":
            out = rk2_local(field, vel, no_slip)
            return (sh.map(lambda a, b, x: torch.clamp(x, 0.0, 1.0), out)
                    if clip01 else out)
        if cfg.advector != "maccormack":
            return advect_local(field, vel, no_slip, clip01=clip01)
        # MacCormack (ops.advect.advect_maccormack, shard-local): forward
        # predictor with stencil extrema, backward corrector, clamp bounds
        # extended to the (possibly no-slip-discounted) predictor
        phi_hat, cmin, cmax = unzip(advect_local(field, vel, no_slip,
                                                 return_minmax=True), 3)
        phi_back = advect_local(phi_hat, vel, no_slip, sign=-1.0)

        def limit(a, b, f, ph, pb, lo, hi):
            corrected = ph + 0.5 * (f - pb)
            return torch.clamp(corrected, torch.minimum(lo, ph),
                               torch.maximum(hi, ph))
        return sh.map(limit, field, phi_hat, phi_back, cmin, cmax)

    def divergence_local(vel):
        # each component only needs ghosts along its own difference axis
        vx = sh.exchange(_channel(vel, 0), 1, -2, X_AXIS, "reflect_neg")
        vy = sh.exchange(_channel(vel, 1), 1, -1, Y_AXIS, "reflect_neg")
        inv = 1.0 / (2.0 * dx)
        return sh.map(lambda a, b, x, y: ((x[2:, :] - x[:-2, :])
                                          + (y[:, 2:] - y[:, :-2])) * inv,
                      vx, vy)

    def vorticity_local(vel):
        """Fedkiw confinement with edge-clamped halos (matches
        ``ops.fd.vorticity_confinement`` on the global grid)."""
        inv = 1.0 / (2.0 * dx)
        vx = sh.exchange(_channel(vel, 0), 1, -1, Y_AXIS, "edge")
        vy = sh.exchange(_channel(vel, 1), 1, -2, X_AXIS, "edge")
        w = sh.map(lambda a, b, x, y: ((y[2:, :] - y[:-2, :])
                                       - (x[:, 2:] - x[:, :-2])) * inv,
                   vx, vy)
        aw = sh.map(lambda a, b, x: torch.abs(x), w)
        aw_x = sh.exchange(aw, 1, -2, X_AXIS, "edge")
        aw_y = sh.exchange(aw, 1, -1, Y_AXIS, "edge")

        def force(a, b, v, w_, ax, ay):
            tiny = torch.tensor(1e-6, dtype=v.dtype, device=v.device)
            g0 = (ax[2:, :] - ax[:-2, :]) * inv
            g1 = (ay[:, 2:] - ay[:, :-2]) * inv
            mag = torch.sqrt(g0 * g0 + g1 * g1) + tiny
            f = torch.stack([(g1 / mag) * w_, -(g0 / mag) * w_], dim=0)
            return v + (cfg.vorticity_eps * dx * dt) * f
        return sh.map(force, vel, w, aw_x, aw_y)

    def gradient_sub_local(vel, p):
        ppad = sh.exchange2(p, 1, ("edge", "edge"))
        inv = 1.0 / (2.0 * dx)

        def one(a, b, v, pp):
            gx = (pp[2:, 1:-1] - pp[:-2, 1:-1]) * inv
            gy = (pp[1:-1, 2:] - pp[1:-1, :-2]) * inv
            return v - torch.stack([gx, gy], dim=0)
        return sh.map(one, vel, ppad)

    def sor_local(d):
        """Red-black SOR (or Jacobi) over the mesh with a tunable halo
        depth: a ``kk``-wide exchange once per ``kk`` half-sweeps on the
        extended block — each half-sweep invalidates one ring, so the owned
        block stays exact.  Global parity and the Neumann diagonal follow
        ``poisson.cpp:10-12, 67-89``."""
        kk = max(1, min(sor_halo, 2 * iters))
        jacobi = cfg.solver == "jacobi"
        omega = min(cfg.omega, 1.0) if jacobi else cfg.omega

        def consts(a, b, dpad):
            # extended-block coordinates: its (0, 0) is global (ox-kk, oy-kk)
            ox, oy = sh.origin(a, b)
            gi = torch.arange(lh + 2 * kk, device=dpad.device)[:, None] + (
                ox - kk)
            gj = torch.arange(lw + 2 * kk, device=dpad.device)[None, :] + (
                oy - kk)
            aii = _aii(gi, gj, H, W)
            in_dom = (gi >= 0) & (gi < H) & (gj >= 0) & (gj < W)
            neg_inv = neg_inv_of(aii, dpad.dtype)
            dxd = torch.where(in_dom, dx * dpad, 0.0)
            return (gi + gj) % 2, neg_inv, in_dom, dxd

        const = sh.map(consts, sh.exchange2(d, kk))

        def halves(a, b, pp, start, count):
            parity, neg_inv, in_dom, dxd = const[a][b]
            for m in range(count):
                nb = (((_shift_zero(pp, 0, -1) + _shift_zero(pp, 0, 1))
                       + _shift_zero(pp, 1, -1)) + _shift_zero(pp, 1, 1))
                p_new = (1.0 - omega) * pp + omega * (neg_inv * (dxd - nb))
                mask = in_dom if jacobi else (
                    (parity == (start + m) % 2) & in_dom)
                pp = torch.where(mask, p_new,
                                 torch.where(in_dom, pp, 0.0))
            return pp[kk:-kk, kk:-kk]

        # jacobi: one full update per iteration; sor: two half-sweeps
        total = iters if jacobi else 2 * iters
        p = sh.map(lambda a, b, x: torch.zeros_like(x), d)
        done = 0
        while done < total:
            n_here = min(kk, total - done)
            p = sh.map(lambda a, b, pp: halves(a, b, pp, done, n_here),
                       sh.exchange2(p, kk))
            done += n_here
        return p

    def mg_local(d):
        """Sharded geometric multigrid (``solver='multigrid'``).

        Hybrid ladder: levels stay sharded while every shard's block halves
        cleanly (even, >= 8 per side); below that the level is gathered
        and the remaining V-cycle runs once, replicated (the coarse grids
        are small), its result sliced back to the shards.  Same
        restriction (2x2 mean), linear prolongation, RB smoother and -4x
        residual scaling as ``ops/multigrid.py``."""
        omega_s = min(cfg.omega, 1.3)
        n_pre = n_post = 2
        plan = []
        hl, wl, lhl, lwl = H, W, lh, lw
        while (lhl % 2 == 0 and lwl % 2 == 0 and lhl >= 8 and lwl >= 8
               and min(hl, wl) > 3):
            plan.append((hl, wl, lhl, lwl))
            hl, wl, lhl, lwl = hl // 2, wl // 2, lhl // 2, lwl // 2
        rep_shapes = _coarse_shapes((hl, wl), 32)

        def level_coords(a, b, level):
            hg, wg, lhg, lwg = plan[level]
            dev = sh.devices[a][b]
            gi = torch.arange(lhg, device=dev)[:, None] + a * lhg
            gj = torch.arange(lwg, device=dev)[None, :] + b * lwg
            return (gi + gj) % 2, _aii(gi, gj, hg, wg)

        def consts(level):
            def one(a, b):
                parity, aii = level_coords(a, b, level)
                return parity, neg_inv_of(aii), aii.to(f32)
            return sh.map(one)

        def nbr_sum(p):
            pp = sh.exchange2(p, 1)
            return sh.map(lambda a, b, x: (x[:-2, 1:-1] + x[2:, 1:-1]
                                           + x[1:-1, :-2] + x[1:-1, 2:]), pp)

        def smooth(p, bb, const, sweeps):
            for _ in range(sweeps):
                for color in (0, 1):
                    nb = nbr_sum(p)

                    def upd(a, b, x, rhs, s):
                        parity, neg_inv, _ = const[a][b]
                        x_new = ((1.0 - omega_s) * x
                                 + omega_s * (neg_inv * (rhs - s)))
                        return torch.where(parity == color, x_new, x)
                    p = sh.map(upd, p, bb, nb)
            return p

        def prolong_sharded(x):
            # cell-centred linear interpolation per axis, neighbour values
            # via edge-clamped halos (ops.multigrid._prolong globally)
            for axis, name in ((0, X_AXIS), (1, Y_AXIS)):
                xp = sh.exchange(x, 1, axis, name, "edge")

                def interp(a, b, c, cp, axis=axis):
                    n = c.shape[axis]
                    lo = cp.narrow(axis, 0, n)
                    hi = cp.narrow(axis, 2, n)
                    inter = torch.stack([0.75 * c + 0.25 * lo,
                                         0.75 * c + 0.25 * hi], dim=axis + 1)
                    return inter.reshape(c.shape[:axis] + (2 * n,)
                                         + c.shape[axis + 1:])
                x = sh.map(interp, x, xp)
            return x

        def vcycle(p, bb, level):
            const = consts(level)
            p = smooth(p, bb, const, n_pre)
            nb = nbr_sum(p)

            def coarse_rhs(a, b, x, rhs, s):
                r = s - const[a][b][2] * x - rhs
                lhg, lwg = r.shape
                return -4.0 * r.reshape(lhg // 2, 2, lwg // 2, 2).mean(
                    dim=(1, 3))
            b_c = sh.map(coarse_rhs, p, bb, nb)
            if level + 1 < len(plan):
                e_c = vcycle(sh.map(lambda a, b, x: torch.zeros_like(x),
                                    b_c), b_c, level + 1)
            else:
                # gather the coarse level and solve it once, replicated
                g = gather(b_c, home)
                e_rep = _vcycle(torch.zeros_like(g), g, rep_shapes, 0,
                                omega_s, n_pre, n_post, 16)
                ch, cw = g.shape[0] // sh.nx, g.shape[1] // sh.ny
                e_c = sh.map(lambda a, b: e_rep[a * ch:(a + 1) * ch,
                                                b * cw:(b + 1) * cw].to(
                    sh.devices[a][b]))
            e_f = prolong_sharded(e_c)
            p = sh.map(lambda a, b, x, e: x + e, p, e_f)
            return smooth(p, bb, const, n_post)

        bb = sh.map(lambda a, b, x: dx * x, d)
        if not plan:  # too small to shard the ladder: replicate at once
            g = gather(bb, home)
            p_rep = multigrid_solve(g / dx, dx, cycles=cfg.mg_cycles,
                                    omega=cfg.omega)
            return sh.split(p_rep)
        p = sh.map(lambda a, b, x: torch.zeros_like(x), d)
        for _ in range(cfg.mg_cycles):
            p = vcycle(p, bb, 0)
        return p

    def impulses_local(vel, imps):
        """The drag queue's drain at global cells, each shard writing its
        own (``.ino:264-269`` semantics; the last active slot wins)."""
        def one(a, b, v, imp):
            return apply_impulses(v, impulses_in_window(
                imp, (H, W), sh.origin(a, b), (lh, lw)))
        return sh.map(one, vel, imps)

    def solve_local(div):
        """Pressure solve, solver-dispatched.  K4 runs the whole solve per
        shard after ONE wide exchange (trapezoidal validity), vs 2*iters
        exchanges for the eager SOR."""
        if cfg.solver == "sor_pallas":
            g2 = 2 * iters
            return sh.map(lambda a, b, dp: sor_solve_kernel(
                dp, dx, iters, cfg.omega, global_offset=sh.origin(a, b),
                global_shape=(H, W), halo=g2), sh.exchange2(div, g2))
        if cfg.solver == "multigrid":
            return mg_local(div)
        return sor_local(div)

    def project_local(vel, imps=None):
        """Pressure projection -> (velocity, pressure) grids; K1 block mode
        drains ``imps`` when given."""
        if cfg.solver == "fused_pallas":
            g2 = 2 * iters + 2

            def kern(a, b, vp, imp):
                return project_fused(vp, dx, iters, cfg.omega, impulses=imp,
                                     global_offset=sh.origin(a, b),
                                     global_shape=(H, W), halo=g2)
            none = [[None] * sh.ny for _ in range(sh.nx)]
            return unzip(sh.map(kern, sh.exchange2(vel, g2),
                                none if imps is None else imps), 2)
        p = solve_local(divergence_local(vel))
        return gradient_sub_local(vel, p), p

    def residual_local(p, div):
        """``ops.poisson.poisson_residual`` with exchanged zero-ghost halos
        and the global-edge Neumann diagonal."""
        def one(a, b, pp, dv):
            gi, gj = coords(a, b)
            nb = (((pp[:-2, 1:-1] + pp[2:, 1:-1]) + pp[1:-1, :-2])
                  + pp[1:-1, 2:])
            aii = _aii(gi, gj, H, W).to(pp.dtype)
            return nb - aii * pp[1:-1, 1:-1] - dx * dv
        return sh.map(one, sh.exchange2(p, 1), div)

    home = sh.home
    drain_in_k1 = (cfg.solver == "fused_pallas" and cfg.vorticity_eps == 0.0
                   and not with_metrics)

    def step(state: SimState, imp: Impulses):
        imps = sh.replicate(imp)
        vel = advect_dispatch(state.velocity, state.velocity, no_slip=True)
        if not drain_in_k1:
            vel = impulses_local(vel, imps)
        if cfg.vorticity_eps > 0.0:
            vel = vorticity_local(vel)
        div_pre = divergence_local(vel) if with_metrics else None
        vel, p = project_local(vel, imps if drain_in_k1 else None)
        color = advect_dispatch(state.color, vel, no_slip=False,
                                clip01=cfg.advector != "maccormack")
        new_state = SimState(velocity=vel, color=color, step=state.step + 1)
        if not with_metrics:
            return new_state
        return new_state, mesh_metrics(
            sh, div_pre, divergence_local(vel), residual_local(p, div_pre),
            vel, color, float(H * W))

    return step


def make_sharded_step_with_metrics(cfg: SimConfig, mesh: Mesh,
                                   max_disp: int | None = None,
                                   donate: bool = True, sor_halo: int = 1):
    """Sharded ``step_with_metrics``: the sharded step plus the SURVEY §5
    observability scalars (``div_pre_max``, ``div_post_max``,
    ``poisson_residual_l2``, ``max_speed``, ``finite``), reduced over the
    shards; 0-dim tensors on the first shard's device.  As the
    single-device ``step_with_metrics``, the impulses are scattered before
    the projection (K1 runs without them).  ``donate`` is accepted for the
    JAX signature and has no effect on eager code."""
    del donate
    return make_sharded_step(cfg, mesh, max_disp=max_disp,
                             sor_halo=sor_halo, with_metrics=True)


def make_sharded_render(cfg: SimConfig, mesh: Mesh):
    """Sharded upscale + RGB565: each shard upscales its block with a
    1-node edge halo; the lerp-endpoint row/column (``.ino:115``) is
    cropped from the last shards, so ``gather`` of the returned grid of
    frame blocks is the single-device render ``[(H-1)*s, (W-1)*s]``
    uint16."""
    sh = Shards(mesh, cfg.shape)
    s = cfg.scaling

    def render(color):
        cpad = sh.exchange2(color, 1, ("edge", "edge"))

        def one(a, b, c):
            # keep only the +1 ghost on the high side
            frame = pack_rgb565(upscale_bilinear(c[:, 1:, 1:], s))
            rows = frame.shape[0] - (s if a == sh.nx - 1 else 0)
            cols = frame.shape[1] - (s if b == sh.ny - 1 else 0)
            return frame[:rows, :cols]
        return sh.map(one, cpad)

    return render
