"""The sharded 3D dye-bed step: ``models.stable_fluids.step`` for a 3D
``SimConfig`` over the ``(x, y)`` shards of a device mesh
(counterpart of ``esp32_fluid_simulation_tpu/parallel/sharded3d.py``),
and the 3D stencils it shares with the sharded smoke step
(``parallel/sharded_smoke.py``).

The vertical axis (D, axis -3) stays whole on every shard; the trailing
two axes shard as in the 2D step (``parallel/sharded.py``), with halo
strips exchanged per stencil and the boundary conditions at the *global*
edges.  Per step:

* advection: one ``max_disp+1``-wide exchange per axis per advected field;
  the backtrace clamps to ``max_disp`` cells on the two sharded axes and
  only to the domain on the vertical one (``sharded3d.py:97-109``);
* projection: the eager SOR exchanges a ``sor_halo``-wide strip once per
  ``sor_halo`` half-sweeps, Jacobi once per ``sor_halo`` iterations;
  multigrid keeps the levels sharded while every block halves cleanly and
  solves the rest replicated; ``solver="sor_pallas"`` runs the K9 block
  chain (``sor3d_chunk``), one ``2*chunk``-wide exchange per chunk of
  ``chunk = 3`` sweeps (``sharded3d.py:246-267``);
* divergence, gradient and vorticity confinement: 1-wide exchanges.

Kernel advection (``advect_impl="pallas"``, semilag only, as in JAX) runs
K7 in block mode (``advect3d_kernel(global_offset=...)``): a shard's cells
equal the whole grid's to the bit.  The eager advection rebases its
coordinates into the shard window (``si - ox + k``), which may round, so
it agrees with the single-device step to float tolerance.  The 3D
``solver="sor_pallas"`` has no single-device counterpart (the 2D K4
raises for 3D), so it is held against the sharded eager SOR, as JAX does.
"""

from __future__ import annotations

import torch

from ..config import SimConfig
from ..state import SimState, Impulses
from ..models.stable_fluids import apply_impulses, impulses_in_window
from ..ops.advect import noslip_axis_factor, sample_linear
from ..ops.cuda.advect3d import advect3d_kernel
from ..ops.cuda.sor3d import aii3, sor3d_chunk
from ..ops.fd import _shift_edge_clamp, _shift_reflect_neg
from ..ops.multigrid import _coarse_shapes, _vcycle, multigrid_solve
from ..ops.poisson import _shift_zero, neg_inv_of
from .sharded import (Shards, _channel, check_max_disp, gather,
                      mesh_metrics, unzip)
from .topology import Mesh, X_AXIS, Y_AXIS

F32 = torch.float32
SOR_CHUNK = 3   # sweeps per K9 block chunk, getattr(cfg, "sor_chunk", 3)


def _zeros(sh, grid):
    return sh.map(lambda a, b, x: torch.zeros_like(x), grid)


def coords3(sh: Shards, a, b):
    """Shard ``(a, b)``'s global ``(z, row, col)`` indices, int64
    ``[D, 1, 1]``, ``[1, lh, 1]`` and ``[1, 1, lw]``."""
    ox, oy = sh.origin(a, b)
    dev = sh.devices[a][b]
    return (torch.arange(sh.shape[0], device=dev)[:, None, None],
            torch.arange(sh.lh, device=dev)[None, :, None] + ox,
            torch.arange(sh.lw, device=dev)[None, None, :] + oy)


def nbr_sum3(p, pp):
    """The six face neighbours of ``p`` (a shard's ``[D, lh, lw]`` block)
    summed in ``ops.poisson``'s order, the vertical ones with zero ghosts,
    the others from ``pp``, the block with a 1-wide halo."""
    return (((((_shift_zero(p, 0, -1) + _shift_zero(p, 0, 1))
               + pp[:, :-2, 1:-1]) + pp[:, 2:, 1:-1]) + pp[:, 1:-1, :-2])
            + pp[:, 1:-1, 2:])


class Stencils3D:
    """The 3D sharded stencils of one mesh and domain ``(D, H, W)``: grids
    of per-shard blocks in, grids out."""

    def __init__(self, sh: Shards, dx: float):
        self.sh = sh
        self.dx = dx
        self.inv = 1.0 / (2.0 * dx)
        self.fcoords = sh.map(lambda a, b: tuple(
            c.to(F32).expand(sh.shape[0], sh.lh, sh.lw)
            for c in coords3(sh, a, b)))

    def advect_eager(self, fpad, vel, dt, max_disp, no_slip, sign=1.0,
                     return_minmax=False):
        """Backtrace + trilinear gather from ``fpad`` (``max_disp+1``
        halo); global-coordinate clamps, the vertical one to the domain
        only."""
        sh = self.sh
        d, h, w = sh.shape
        k = max_disp + 1

        def one(a, b, f, v):
            gz, gi, gj = self.fcoords[a][b]
            ox, oy = sh.origin(a, b)
            sz_raw = gz - sign * v[0].to(F32) * dt
            si_raw = gi - sign * v[1].to(F32) * dt
            sj_raw = gj - sign * v[2].to(F32) * dt
            sz = torch.clamp(sz_raw, 0.0, d - 1.0)
            si = torch.clamp(torch.clamp(si_raw, gi - max_disp,
                                         gi + max_disp), 0.0, h - 1.0)
            sj = torch.clamp(torch.clamp(sj_raw, gj - max_disp,
                                         gj + max_disp), 0.0, w - 1.0)
            # window row 0 is global row ox - k
            res = sample_linear(f, (sz, si - float(ox) + float(k),
                                    sj - float(oy) + float(k)),
                                no_slip=False, return_minmax=return_minmax)
            out, extra = (res[0], res[1:]) if return_minmax else (res, ())
            if no_slip:
                out = out * (noslip_axis_factor(sz_raw, d)
                             * noslip_axis_factor(si_raw, h)
                             * noslip_axis_factor(sj_raw, w)).to(out.dtype)
            return (out, *extra) if return_minmax else out
        return sh.map(one, fpad, vel)

    def advect_kernel(self, fpad, vel, dt, max_disp, no_slip):
        """K7 in block mode on every shard; ``vel`` None is the velocity
        self-advect, which reads the velocity from ``fpad``'s owned
        cells."""
        sh = self.sh
        vel = [[None] * sh.ny for _ in range(sh.nx)] if vel is None else vel
        return sh.map(lambda a, b, f, v: advect3d_kernel(
            f, v, dt, no_slip, max_disp=max_disp,
            global_offset=sh.origin(a, b), global_shape=sh.shape,
            halo=max_disp + 1), fpad, vel)

    def divergence(self, vel):
        """``ops.fd.divergence`` with reflect-negate ghosts: the vertical
        ones local, the others exchanged, each component along its own
        difference axis only."""
        vx = self.sh.exchange(_channel(vel, 1), 1, -2, X_AXIS, "reflect_neg")
        vy = self.sh.exchange(_channel(vel, 2), 1, -1, Y_AXIS, "reflect_neg")
        return self.sh.map(lambda a, b, v, x, y: (
            (_shift_reflect_neg(v[0], 0) + (x[:, 2:] - x[:, :-2]))
            + (y[:, :, 2:] - y[:, :, :-2])) * self.inv, vel, vx, vy)

    def subtract_gradient(self, vel, p):
        """``ops.fd.subtract_gradient`` with edge-clamped (Neumann)
        ghosts."""
        ppad = self.sh.exchange2(p, 1, ("edge", "edge"))

        def one(a, b, v, pp):
            g0 = _shift_edge_clamp(pp[:, 1:-1, 1:-1], 0) * self.inv
            g1 = (pp[:, 2:, 1:-1] - pp[:, :-2, 1:-1]) * self.inv
            g2 = (pp[:, 1:-1, 2:] - pp[:, 1:-1, :-2]) * self.inv
            return v - torch.stack([g0, g1, g2], dim=0)
        return self.sh.map(one, vel, ppad)

    def _diff_ec(self, grid):
        """``(d0, d1, d2)`` grids: the edge-clamped central differences of
        each block of ``grid`` (``[..., D, lh, lw]``) along the vertical
        axis, rows and columns, unscaled."""
        sh = self.sh
        xp = self.sh.exchange(grid, 1, -2, X_AXIS, "edge")
        yp = self.sh.exchange(grid, 1, -1, Y_AXIS, "edge")
        d0 = sh.map(lambda a, b, x: _shift_edge_clamp(x, x.dim() - 3), grid)
        d1 = sh.map(lambda a, b, x: x[..., 2:, :] - x[..., :-2, :], xp)
        d2 = sh.map(lambda a, b, x: x[..., 2:] - x[..., :-2], yp)
        return d0, d1, d2

    def vorticity(self, vel, eps, dt):
        """``ops.fd.vorticity_confinement`` in 3D, its arithmetic in its
        order."""
        sh, inv = self.sh, self.inv
        dv = self._diff_ec(vel)

        def curl(a, b, d0, d1, d2):
            def d(comp, axis):
                return (d0, d1, d2)[axis][comp] * inv
            return torch.stack([d(2, 1) - d(1, 2), d(0, 2) - d(2, 0),
                                d(1, 0) - d(0, 1)], dim=0)
        w = sh.map(curl, *dv)
        aw = sh.map(lambda a, b, x: torch.sqrt(x[0] * x[0] + x[1] * x[1]
                                               + x[2] * x[2]), w)
        da = self._diff_ec(aw)

        def force(a, b, v, w_, g0, g1, g2):
            tiny = torch.tensor(1e-6, dtype=v.dtype, device=v.device)
            g = torch.stack([g0 * inv, g1 * inv, g2 * inv], dim=0)
            mag = torch.sqrt(g[0] * g[0] + g[1] * g[1] + g[2] * g[2]) + tiny
            n = g / mag
            f = torch.stack([n[1] * w_[2] - n[2] * w_[1],
                             n[2] * w_[0] - n[0] * w_[2],
                             n[0] * w_[1] - n[1] * w_[0]], dim=0)
            return v + (eps * self.dx * dt) * f
        return sh.map(force, vel, w, *da)

    def sor(self, d, iters, omega, halo=1, jacobi=False):
        """Red-black SOR (or Jacobi) with a ``halo``-wide exchange once
        per ``halo`` half-sweeps (iterations) on the extended block: each
        half-sweep invalidates one ring, so the owned block stays exact.
        Global parity and the Neumann diagonal (``poisson.cpp:10-12,
        67-89``)."""
        sh, dx = self.sh, self.dx
        kk = max(1, min(halo, 2 * iters))
        shape = sh.shape

        def consts(a, b, dpad):
            ox, oy = sh.origin(a, b)
            dev = dpad.device
            g = (torch.arange(shape[0], device=dev)[:, None, None],
                 torch.arange(sh.lh + 2 * kk, device=dev)[None, :, None]
                 + (ox - kk),
                 torch.arange(sh.lw + 2 * kk, device=dev)[None, None, :]
                 + (oy - kk))
            in_dom = ((g[1] >= 0) & (g[1] < shape[1]) & (g[2] >= 0)
                      & (g[2] < shape[2])).expand(dpad.shape)
            neg_inv = neg_inv_of(aii3(g, shape), dpad.dtype)
            dxd = torch.where(in_dom, dx * dpad, 0.0)
            return (g[0] + g[1] + g[2]) % 2, neg_inv, in_dom, dxd

        const = sh.map(consts, self.sh.exchange2(d, kk))

        def halves(a, b, pp, start, count):
            parity, neg_inv, in_dom, dxd = const[a][b]
            for m in range(count):
                nb = (((((_shift_zero(pp, 0, -1) + _shift_zero(pp, 0, 1))
                         + _shift_zero(pp, 1, -1)) + _shift_zero(pp, 1, 1))
                       + _shift_zero(pp, 2, -1)) + _shift_zero(pp, 2, 1))
                p_new = (1.0 - omega) * pp + omega * (neg_inv * (dxd - nb))
                mask = in_dom if jacobi else (
                    (parity == (start + m) % 2) & in_dom)
                pp = torch.where(mask, p_new, torch.where(in_dom, pp, 0.0))
            return pp[:, kk:-kk, kk:-kk]

        total = iters if jacobi else 2 * iters
        p = _zeros(sh, d)
        done = 0
        while done < total:
            n_here = min(kk, total - done)
            p = sh.map(lambda a, b, pp: halves(a, b, pp, done, n_here),
                       self.sh.exchange2(p, kk))
            done += n_here
        return p

    def sor_kernel(self, d, iters, omega, chunk=SOR_CHUNK):
        """K9 in block mode: per chunk of ``chunk`` sweeps ONE exchange of
        ``2*chunk`` rings, then ``sor3d_chunk`` on every haloed block from
        the pressure carried over (``sharded_smoke.py:154-173``).  The
        exchanged rings evolve as the neighbours' owned cells do, so the
        continuation is exact: the owned cells equal the whole-grid
        solve's."""
        if chunk < 1:
            raise ValueError(f"sor_chunk={chunk} must be >= 1")
        sh = self.sh
        ck = min(chunk, iters)
        g = 2 * ck
        dg = self.sh.exchange2(d, g)
        p = _zeros(sh, dg)
        p_own = _zeros(sh, d)
        done = 0
        while done < iters:
            kk = min(ck, iters - done)

            def one(a, b, dd, pp):
                ox, oy = sh.origin(a, b)
                full = sor3d_chunk(dd, pp, self.dx, kk, omega,
                                   global_offset=(0, ox - g, oy - g),
                                   global_shape=sh.shape)
                return full[:, g:g + sh.lh, g:g + sh.lw]
            p_own = sh.map(one, dg, p)
            done += kk
            if done < iters:
                p = self.sh.exchange2(p_own, g)
        return p_own

    def multigrid(self, d, cycles, omega_s):
        """Sharded 3D geometric multigrid (the hybrid ladder of
        ``sharded_smoke.py:213-331``): levels stay sharded while every
        shard's block halves cleanly (even, >= 8 a side); below that the
        level is gathered and the rest of the V-cycle runs once,
        replicated, its result sliced back.  Same restriction (2^3 mean),
        linear prolongation, RB smoother and -4x residual scaling as
        ``ops/multigrid.py``."""
        sh, dx = self.sh, self.dx
        home = sh.home
        n_pre = n_post = 2
        plan = []
        dl, hl, wl, lhl, lwl = sh.shape + (sh.lh, sh.lw)
        while (dl % 2 == 0 and lhl % 2 == 0 and lwl % 2 == 0 and lhl >= 8
               and lwl >= 8 and min(dl, hl, wl) > 3):
            plan.append(((dl, hl, wl), lhl, lwl))
            dl, hl, wl, lhl, lwl = dl // 2, hl // 2, wl // 2, lhl // 2, \
                lwl // 2
        rep_shapes = _coarse_shapes((dl, hl, wl), 32)

        def consts(level):
            shape, lhg, lwg = plan[level]

            def one(a, b):
                dev = sh.devices[a][b]
                g = (torch.arange(shape[0], device=dev)[:, None, None],
                     torch.arange(lhg, device=dev)[None, :, None] + a * lhg,
                     torch.arange(lwg, device=dev)[None, None, :] + b * lwg)
                aii = aii3(g, shape)
                return (g[0] + g[1] + g[2]) % 2, neg_inv_of(aii), aii.to(F32)
            return sh.map(one)

        def nbr_sum(p):
            return sh.map(lambda a, b, x, xp: nbr_sum3(x, xp), p,
                          self.sh.exchange2(p, 1))

        def smooth(p, bb, const, sweeps):
            for _ in range(sweeps):
                for color in (0, 1):
                    def upd(a, b, x, rhs, s):
                        parity, neg_inv, _ = const[a][b]
                        x_new = ((1.0 - omega_s) * x
                                 + omega_s * (neg_inv * (rhs - s)))
                        return torch.where(parity == color, x_new, x)
                    p = sh.map(upd, p, bb, nbr_sum(p))
            return p

        def prolong(x):
            # cell-centred linear interpolation per axis (ops.multigrid.
            # _prolong): the vertical neighbours edge-clamped locally, the
            # others through edge-clamped halos
            for axis in range(3):
                if axis == 0:
                    xp = sh.map(lambda a, b, c: torch.cat(
                        [c[:1], c, c[-1:]], dim=0), x)
                else:
                    xp = sh.exchange(x, 1, axis, (X_AXIS, Y_AXIS)[axis - 1],
                                     "edge")

                def interp(a, b, c, cp, axis=axis):
                    n = c.shape[axis]
                    lo, hi = cp.narrow(axis, 0, n), cp.narrow(axis, 2, n)
                    inter = torch.stack([0.75 * c + 0.25 * lo,
                                         0.75 * c + 0.25 * hi], dim=axis + 1)
                    return inter.reshape(c.shape[:axis] + (2 * n,)
                                         + c.shape[axis + 1:])
                x = sh.map(interp, x, xp)
            return x

        def vcycle(p, bb, level):
            const = consts(level)
            p = smooth(p, bb, const, n_pre)

            def coarse_rhs(a, b, x, rhs, s):
                r = s - const[a][b][2] * x - rhs
                dg, lhg, lwg = r.shape
                return -4.0 * r.reshape(dg // 2, 2, lhg // 2, 2, lwg // 2,
                                        2).mean(dim=(1, 3, 5))
            b_c = sh.map(coarse_rhs, p, bb, nbr_sum(p))
            if level + 1 < len(plan):
                e_c = vcycle(_zeros(sh, b_c), b_c, level + 1)
            else:
                g = gather(b_c, home)
                e_rep = _vcycle(torch.zeros_like(g), g, rep_shapes, 0,
                                omega_s, n_pre, n_post, 16)
                ch, cw = g.shape[1] // sh.nx, g.shape[2] // sh.ny
                e_c = sh.map(lambda a, b: e_rep[:, a * ch:(a + 1) * ch,
                                                b * cw:(b + 1) * cw].to(
                    sh.devices[a][b]))
            p = sh.map(lambda a, b, x, e: x + e, p, prolong(e_c))
            return smooth(p, bb, const, n_post)

        bb = sh.map(lambda a, b, x: dx * x, d)
        if not plan:  # too small to shard the ladder: replicate at once
            p_rep = multigrid_solve(gather(bb, home) / dx, dx, cycles=cycles,
                                    omega=omega_s)
            return sh.split(p_rep)
        p = _zeros(sh, d)
        for _ in range(cycles):
            p = vcycle(p, bb, 0)
        return p

    def residual(self, p, div):
        """``ops.poisson.poisson_residual`` with exchanged zero-ghost halos
        and the global-edge Neumann diagonal."""
        sh = self.sh

        def one(a, b, x, xp, dv):
            aii = aii3(coords3(sh, a, b), sh.shape).to(x.dtype)
            return nbr_sum3(x, xp) - aii * x - self.dx * dv
        return sh.map(one, p, self.sh.exchange2(p, 1), div)


def make_sharded_step_3d(cfg: SimConfig, mesh: Mesh,
                         max_disp: int | None = None, donate: bool = True,
                         sor_halo: int = 1, with_metrics: bool = False):
    """Build the sharded 3D ``step(state, impulses) -> state`` (same
    contract as ``parallel.sharded.make_sharded_step``, which dispatches
    here for ``cfg.ndim == 3``).  Supported, as in JAX: advector
    semilag/rk2/maccormack (kernel advection: semilag only), solver
    sor/jacobi/multigrid/sor_pallas.  ``donate`` is accepted for the JAX
    signature and has no effect on eager code."""
    del donate
    if cfg.advector not in ("semilag", "maccormack", "rk2"):
        raise NotImplementedError(
            f"sharded 3D step supports advector='semilag'/'maccormack'/"
            f"'rk2', got {cfg.advector!r}")
    if cfg.solver not in ("sor", "jacobi", "multigrid", "sor_pallas"):
        raise NotImplementedError(
            f"sharded 3D step supports solver='sor'/'jacobi'/'multigrid'/"
            f"'sor_pallas', got {cfg.solver!r} (there is no 3D fused "
            "projection kernel; use solver='sor_pallas' for the kernel 3D "
            "solve)")
    use_kernel_advect = cfg.advect_impl == "pallas"
    if use_kernel_advect and cfg.advector != "semilag":
        raise NotImplementedError(
            "the 3D kernel advection (K7) is semilag-only; use "
            f"advect_impl='jnp' (or 'auto') with advector={cfg.advector!r}")
    max_disp = check_max_disp(cfg, max_disp, use_kernel_advect)
    sh = Shards(mesh, cfg.shape)
    ops = Stencils3D(sh, cfg.dx)
    D, H, W = cfg.shape
    k = max_disp + 1
    dt, iters = cfg.dt, cfg.sor_iters

    def advect_local(field, vel, no_slip, sign=1.0, return_minmax=False):
        fpad = sh.exchange2(field, k)
        if use_kernel_advect:
            # the velocity self-advect reads its velocity from fpad
            return ops.advect_kernel(fpad, None if vel is field else vel, dt,
                                     max_disp, no_slip)
        return ops.advect_eager(fpad, vel, dt, max_disp, no_slip, sign,
                                return_minmax)

    def rk2_local(field, vel, no_slip):
        """Midpoint backtrace (``ops.advect.advect_rk2``, shard-local):
        sample the velocity at x - dt/2·v(x) from a k-halo window, then
        trace the full step through it; both stages clamp to the halo."""
        vpad = sh.exchange2(vel, k)
        fpad = sh.exchange2(field, k)

        def one(a, b, f, v, vp):
            gz, gi, gj = ops.fcoords[a][b]
            ox, oy = sh.origin(a, b)

            def window_coords(cz, ci, cj):
                ci = torch.clamp(torch.clamp(ci, gi - max_disp,
                                             gi + max_disp), 0.0, H - 1.0)
                cj = torch.clamp(torch.clamp(cj, gj - max_disp,
                                             gj + max_disp), 0.0, W - 1.0)
                return (torch.clamp(cz, 0.0, D - 1.0),
                        ci - float(ox) + float(k), cj - float(oy) + float(k))

            v_mid = sample_linear(vp, window_coords(
                gz - 0.5 * dt * v[0].to(F32), gi - 0.5 * dt * v[1].to(F32),
                gj - 0.5 * dt * v[2].to(F32)))
            sz_raw = gz - v_mid[0].to(F32) * dt
            si_raw = gi - v_mid[1].to(F32) * dt
            sj_raw = gj - v_mid[2].to(F32) * dt
            out = sample_linear(f, window_coords(sz_raw, si_raw, sj_raw))
            if no_slip:
                out = out * (noslip_axis_factor(sz_raw, D)
                             * noslip_axis_factor(si_raw, H)
                             * noslip_axis_factor(sj_raw, W)).to(out.dtype)
            return out
        return sh.map(one, fpad, vel, vpad)

    def advect_dispatch(field, vel, no_slip):
        if cfg.advector == "rk2":
            return rk2_local(field, vel, no_slip)
        if cfg.advector != "maccormack":
            return advect_local(field, vel, no_slip)
        phi_hat, cmin, cmax = unzip(advect_local(field, vel, no_slip,
                                                 return_minmax=True), 3)
        phi_back = advect_local(phi_hat, vel, no_slip, sign=-1.0)

        def limit(a, b, f, ph, pb, lo, hi):
            corrected = ph + 0.5 * (f - pb)
            return torch.clamp(corrected, torch.minimum(lo, ph),
                               torch.maximum(hi, ph))
        return sh.map(limit, field, phi_hat, phi_back, cmin, cmax)

    def solve_local(div):
        if cfg.solver == "multigrid":
            return ops.multigrid(div, cfg.mg_cycles, min(cfg.omega, 1.3))
        if cfg.solver == "sor_pallas":
            return ops.sor_kernel(div, iters, cfg.omega)
        jacobi = cfg.solver == "jacobi"
        omega = min(cfg.omega, 1.0) if jacobi else cfg.omega
        return ops.sor(div, iters, omega, sor_halo, jacobi)

    def step(state: SimState, imp: Impulses):
        imps = sh.replicate(imp)
        vel = advect_dispatch(state.velocity, state.velocity, no_slip=True)
        vel = sh.map(lambda a, b, v, i: apply_impulses(v, impulses_in_window(
            i, cfg.shape, (0,) + sh.origin(a, b), (D, sh.lh, sh.lw))),
            vel, imps)
        if cfg.vorticity_eps > 0.0:
            vel = ops.vorticity(vel, cfg.vorticity_eps, dt)
        div = ops.divergence(vel)
        p = solve_local(div)
        vel = ops.subtract_gradient(vel, p)
        color = advect_dispatch(state.color, vel, no_slip=False)
        if cfg.advector != "maccormack":
            color = sh.map(lambda a, b, c: torch.clamp(c, 0.0, 1.0), color)
        new_state = SimState(velocity=vel, color=color, step=state.step + 1)
        if not with_metrics:
            return new_state
        return new_state, mesh_metrics(
            sh, div, ops.divergence(vel), ops.residual(p, div), vel, color,
            float(D * H * W))

    return step
