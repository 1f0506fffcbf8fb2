"""Plain float32 PyTorch reference of one step of an ensemble of independent
dye beds.

It stands alone: it imports nothing of the program and takes from a run
only the step's input state (the member stacks ``velocity`` ``[n, 2, H, W]``
and ``dye`` ``[n, 3, H, W]``, as the program stored them) and the traffic's
flat lists for that step (each poke's member, member-local cell and
velocity).  It works on the member axis and never lays the members out on
one grid: every wall is a member's own.  Each member runs the ESP32
reference's ``loop()``, as ``step_render.py`` does for one grid, without a
frame:

1. self-advect the velocity (semi-Lagrangian, bilinear at the
   member-clamped backtrace, the no-slip discount from the unclamped one);
2. drain the member's pokes: its first ``max_impulses``, positions
   clamped to the member, the last slot wins at a repeated cell;
3. project: divergence with reflected ghosts, ``sor_iters`` red-black SOR
   sweeps from zero in the order of ``step_render.py``'s (the projection
   kernel's), gradient subtract with Neumann ghosts;
4. advect the dye (no discount), clamp to [0, 1], store in the dye dtype.

Where the program advects through its kernel (``advect_impl`` "pallas",
or "auto" on a card once the members together hold 512^2 cells: the
program steps them as one grid of that many cells), the displacement is
clamped to ``advect_max_disp`` cells per axis, which that path states,
and the backtrace is computed at each cell's place on the program's grid
(``tile_origins``): the same value, rounded as the kernel rounds it.  The
red-black colours are the member's own, which are the program's for
members of even height and width; other member shapes are refused.

The elementwise helpers that broadcast over a leading member axis
unchanged (the no-slip discount, the ghosted difference, the stored
dtypes and the control's starting state) are ``step_render.py``'s.  Every
product and sum is its own PyTorch op, rounded on its own, so the
comparison can hold the program to the bit.

``lower=True`` is the control: the same step with the velocity and the
pressure stored in bfloat16 and the float32 dye in bfloat16, the arithmetic
in between in float32.
"""

from __future__ import annotations

import importlib.util
import math
from pathlib import Path

import torch


def _load_step_render():
    path = Path(__file__).with_name("step_render.py")
    spec = importlib.util.spec_from_file_location(
        "bench_port_reference_step_render", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


_SR = _load_step_render()
# each number ``compare`` returns, with the output it judges
NUMBERS = {"velocity_rel": "velocity", "dye_abs": "dye"}
stores = _SR.stores
lower_state = _SR.lower_state


def kernel_advect(sim: dict) -> bool:
    """Whether the configuration's advection takes the clamped path."""
    if sim["advect_impl"] == "pallas":
        return True
    n, h, w = sim["shape"]
    return sim["advect_impl"] == "auto" and n * h * w >= 512 * 512


def tile_origins(sim: dict):
    """Each member's ``(row, column)`` origin on the one grid the program
    steps the members on: ``gh x gw`` tiles of ``H x W``, ``gh`` the
    largest divisor of the member count not above its square root, the
    members row-major over them.  Only the rounding of the advection's
    backtrace, which the kernel computes at a cell's place on that grid,
    depends on it."""
    n, h, w = sim["shape"]
    gh = math.isqrt(n)
    while n % gh:
        gh -= 1
    gw = n // gh
    m = torch.arange(n)
    return (m // gw) * h, (m % gw) * w


def advect(field, vel, dt, no_slip, max_disp, clip01, store, origin=None):
    """Semi-Lagrangian advection of ``field`` ``[n, C, H, W]`` by ``vel``
    ``[n, 2, H, W]``, each member inside its own walls.  With ``origin``
    (``tile_origins``) the backtrace is computed at each cell's place on
    the program's grid and clamped to its member's tile there; without,
    at its place in the member."""
    f = field.to(torch.float32)
    v = vel.to(torch.float32)
    n, c, h, w = f.shape
    dev = v.device
    if origin is None:
        origin = (torch.zeros(n, dtype=torch.long),) * 2
    lo_i = origin[0].to(dev, torch.float32)[:, None, None]
    lo_j = origin[1].to(dev, torch.float32)[:, None, None]
    fi = lo_i + torch.arange(h, device=dev, dtype=torch.float32)[:, None]
    fj = lo_j + torch.arange(w, device=dev, dtype=torch.float32)[None, :]
    si_raw = fi - v[:, 0] * dt
    sj_raw = fj - v[:, 1] * dt
    si, sj = si_raw, sj_raw
    if max_disp is not None:
        si = torch.minimum(torch.maximum(si, fi - max_disp), fi + max_disp)
        sj = torch.minimum(torch.maximum(sj, fj - max_disp), fj + max_disp)
    si = torch.minimum(torch.maximum(si, lo_i), lo_i + (h - 1))
    sj = torch.minimum(torch.maximum(sj, lo_j), lo_j + (w - 1))
    i0 = torch.minimum(torch.maximum(torch.floor(si), lo_i), lo_i + (h - 2))
    j0 = torch.minimum(torch.maximum(torch.floor(sj), lo_j), lo_j + (w - 2))
    di = (si - i0)[:, None]
    dj = (sj - j0)[:, None]
    cell = (i0 - lo_i).long() * w + (j0 - lo_j).long()     # [n, H, W]
    flat = f.reshape(n, c, h * w)

    def at(offset):
        idx = (cell + offset).reshape(n, 1, h * w).expand(n, c, h * w)
        return flat.gather(2, idx).reshape(n, c, h, w)

    top = at(0) * (1.0 - dj) + at(1) * dj
    bottom = at(w) * (1.0 - dj) + at(w + 1) * dj
    acc = top * (1.0 - di) + bottom * di
    if no_slip:
        acc = acc * (_SR._noslip(si_raw - lo_i, h)
                     * _SR._noslip(sj_raw - lo_j, w))[:, None]
    if clip01:
        acc = torch.clamp(acc, 0.0, 1.0)
    return acc.to(store)


def drain(vel, member, pos, val, k):
    """Each member's first ``k`` pokes written into a copy of ``vel``."""
    out = vel.clone()
    h, w = vel.shape[-2:]
    taken, cells = {}, {}
    for m, (i, j), (a, b) in zip(member, pos, val):
        m = int(m)
        if taken.get(m, 0) == k:
            continue
        taken[m] = taken.get(m, 0) + 1
        cell = (m, min(max(int(i), 0), h - 1), min(max(int(j), 0), w - 1))
        cells[cell] = (float(a), float(b))   # a later slot overwrites
    if cells:
        m, i, j = torch.tensor(list(cells), dtype=torch.long,
                               device=vel.device).T
        ab = torch.tensor(list(cells.values()), dtype=torch.float32,
                          device=vel.device)
        out[m, 0, i, j] = ab[:, 0]
        out[m, 1, i, j] = ab[:, 1]
    return out


def divergence(vel, dx):
    """Central differences, the ghost outside a member's wall the negated
    centre: ``[n, H, W]``."""
    flow = None
    for c in (0, 1):
        x, axis = vel[:, c], c + 1
        n = x.shape[axis]
        d = _SR._diff(x, axis, -x.narrow(axis, 0, 1),
                      -x.narrow(axis, n - 1, 1))
        flow = d if flow is None else flow + d
    return flow * (1.0 / (2.0 * dx))


def _neighbour_sum(p):
    n, h, w = p.shape
    zr = torch.zeros((n, 1, w), dtype=p.dtype, device=p.device)
    zc = torch.zeros((n, h, 1), dtype=p.dtype, device=p.device)
    up = torch.cat([zr, p[:, :-1]], dim=1)
    down = torch.cat([p[:, 1:], zr], dim=1)
    left = torch.cat([zc, p[:, :, :-1]], dim=2)
    right = torch.cat([p[:, :, 1:], zc], dim=2)
    return ((up + down) + left) + right


def sor(d, dx, iters, omega, store):
    """Red-black SOR from zero on each member ``[n, H, W]``: the even
    cells, then the odd, per sweep."""
    _, h, w = d.shape
    dev = d.device
    ii = torch.arange(h, device=dev)[:, None]
    jj = torch.arange(w, device=dev)[None, :]
    count = 4 - ((ii == 0).long() + (ii == h - 1).long()
                 + (jj == 0).long() + (jj == w - 1).long())
    lut = torch.tensor([-1.0 / k for k in range(1, 7)],
                       dtype=torch.float64).to(torch.float32).to(dev)
    neg_inv = lut[count - 1]
    parity = (ii + jj) % 2
    p = torch.zeros(d.shape, dtype=store, device=dev)
    for _ in range(iters):
        for colour in (0, 1):
            q = p.to(torch.float32)
            gs = neg_inv * (dx * d - _neighbour_sum(q))
            new = (1.0 - omega) * q + omega * gs
            p = torch.where(parity == colour, new, q).to(store)
    return p.to(torch.float32)


def subtract_gradient(vel, p, dx):
    inv = 1.0 / (2.0 * dx)
    grads = []
    for axis in (1, 2):
        n = p.shape[axis]
        g = _SR._diff(p, axis, p.narrow(axis, 0, 1),
                      p.narrow(axis, n - 1, 1))
        grads.append(g * inv)
    return vel - torch.stack(grads, dim=1)


def step(inputs: dict, member, pos, val, sim: dict, scaling: int,
         lower: bool = False) -> dict:
    """One step of every member from ``inputs`` (``velocity``, ``dye``)
    with the pokes ``member``/``pos``/``val``: ``{"velocity", "dye"}``."""
    _, h, w = sim["shape"]
    if h % 2 or w % 2:
        raise ValueError(f"members of {h}x{w}: the red-black colours are "
                         "the member's own only at even sizes")
    vel_store, dye_store = stores(sim, lower)
    dt, dx = sim["dt"], sim["dx"]
    md, origin = None, None
    if kernel_advect(sim):
        md, origin = sim["advect_max_disp"], tile_origins(sim)
    vel = inputs["velocity"].to(torch.float32)
    vel = advect(vel, vel, dt, True, md, False, vel_store,
                 origin).to(torch.float32)
    vel = drain(vel, member, pos, val, sim["max_impulses"])
    vel = vel.to(vel_store).to(torch.float32)
    p = sor(divergence(vel, dx), dx, sim["sor_iters"], sim["omega"],
            vel_store)
    vel = subtract_gradient(vel, p, dx).to(vel_store).to(torch.float32)
    dye = advect(inputs["dye"], vel, dt, False, md, True, dye_store, origin)
    return {"velocity": vel, "dye": dye}


def compare(got: dict, want: dict) -> dict:
    """The numbers compared for one step: the largest velocity error over
    the largest reference speed component, and the largest dye error, over
    every member.  A NaN or an infinity anywhere reads as infinite."""
    gv = got["velocity"].to(torch.float32)
    wv = want["velocity"].to(torch.float32)
    scale = float(wv.abs().max())
    dv = (gv - wv).abs()
    dc = (got["dye"].to(torch.float32) - want["dye"].to(torch.float32)).abs()
    inf = float("inf")
    vel_rel = float(dv.max()) / scale if scale > 0 else float(dv.max())
    return {"velocity_rel": vel_rel if torch.isfinite(gv).all() else inf,
            "dye_abs": float(dc.max()) if torch.isfinite(dc).all() else inf}
