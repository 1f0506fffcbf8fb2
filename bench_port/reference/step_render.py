"""Plain float32 PyTorch reference of one dye-bed step and its RGB565 frame.

It stands alone: it imports nothing of the program and takes from a run
only the step's input state (velocity and dye as the program stored them)
and the traffic's impulse lists for that step.  One step is the ESP32
reference's ``loop()`` and ``draw_routine``:

1. self-advect the velocity (semi-Lagrangian, bilinear at the
   domain-clamped backtrace, the no-slip discount from the unclamped one);
2. drain the impulse queue: positions clamped to the grid, the last slot
   wins at a repeated cell;
3. project: divergence with reflected ghosts, ``sor_iters`` red-black SOR
   sweeps from zero (``-1/a_ii`` by double division rounded to float32,
   neighbour sums ``((up + down) + left) + right``), gradient subtract
   with Neumann ghosts;
4. advect the dye (no discount), clamp to [0, 1], store in the dye dtype;
5. render: bilinear upscale by ``s`` (fractions ``a/s`` as float32
   divisions), pack the top 5/6/5 bits, byte-swapped.

Where the configuration routes the advection to the kernel (the port's
rule: ``advect_impl`` "pallas", or "auto" from 512^2 up) the displacement
is clamped to ``advect_max_disp`` cells per axis, which that path states.

Every product and sum is its own PyTorch op, rounded on its own, in the
order listed, so the comparison can hold the program to the bit.

``lower=True`` is the control: the same step with every stored field one
precision down (velocity and pressure in bfloat16, the dye in bfloat16
for a float32 dye and in float8 e4m3 for a bfloat16 one), the arithmetic
in between in float32.  It stands in for the tempting change of halving
what the step stores; the comparison must call it wrong.
"""

from __future__ import annotations

import numpy as np
import torch

# each number ``compare`` returns, with the output it judges
NUMBERS = {"velocity_rel": "velocity", "dye_abs": "dye", "frame_pct": "frame"}
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_LOWER = {torch.float32: torch.bfloat16, torch.bfloat16: torch.float8_e4m3fn}
# source rows of the frame rendered at once, to bound the upscale's memory
RENDER_ROWS = 1024


def kernel_advect(sim: dict) -> bool:
    """Whether the configuration's advection takes the clamped path."""
    if sim["advect_impl"] == "pallas":
        return True
    h, w = sim["shape"]
    return sim["advect_impl"] == "auto" and h * w >= 512 * 512


def _noslip(raw: torch.Tensor, n: int) -> torch.Tensor:
    under = raw < 0
    over = raw >= n - 1
    overshoot = torch.where(under, -raw, raw - (n - 1))
    return torch.where(under | over,
                       torch.where(overshoot < 0.5, 1.0 - 2.0 * overshoot,
                                   torch.zeros_like(raw)),
                       torch.ones_like(raw))


def advect(field, vel, dt, no_slip, max_disp, clip01, store):
    """Semi-Lagrangian advection of ``field`` ``[C, H, W]`` by ``vel``."""
    f = field.to(torch.float32)
    v = vel.to(torch.float32)
    h, w = v.shape[-2:]
    fi = torch.arange(h, device=v.device, dtype=torch.float32)[:, None]
    fj = torch.arange(w, device=v.device, dtype=torch.float32)[None, :]
    fi, fj = fi.expand(h, w), fj.expand(h, w)
    si_raw = fi - v[0] * dt
    sj_raw = fj - v[1] * dt
    si, sj = si_raw, sj_raw
    if max_disp is not None:
        si = torch.minimum(torch.maximum(si, fi - max_disp), fi + max_disp)
        sj = torch.minimum(torch.maximum(sj, fj - max_disp), fj + max_disp)
    si = torch.clamp(si, 0.0, h - 1.0)
    sj = torch.clamp(sj, 0.0, w - 1.0)
    i0 = torch.clamp(torch.floor(si), 0.0, h - 2.0)
    j0 = torch.clamp(torch.floor(sj), 0.0, w - 2.0)
    di = si - i0
    dj = sj - j0
    ii, jj = i0.long(), j0.long()
    top = f[:, ii, jj] * (1.0 - dj) + f[:, ii, jj + 1] * dj
    bottom = f[:, ii + 1, jj] * (1.0 - dj) + f[:, ii + 1, jj + 1] * dj
    acc = top * (1.0 - di) + bottom * di
    if no_slip:
        acc = acc * (_noslip(si_raw, h) * _noslip(sj_raw, w))
    if clip01:
        acc = torch.clamp(acc, 0.0, 1.0)
    return acc.to(store)


def drain(vel, pos, val, k):
    """The first ``k`` impulses written into a copy of ``vel``."""
    out = vel.clone()
    h, w = vel.shape[-2:]
    for (i, j), (a, b) in list(zip(pos, val))[:k]:
        i = min(max(int(i), 0), h - 1)
        j = min(max(int(j), 0), w - 1)
        out[0, i, j] = float(a)
        out[1, i, j] = float(b)
    return out


def _diff(x, axis, ghost_lo, ghost_hi):
    n = x.shape[axis]
    ext = torch.cat([ghost_lo, x, ghost_hi], dim=axis)
    return ext.narrow(axis, 2, n) - ext.narrow(axis, 0, n)


def divergence(vel, dx):
    """Central differences, the ghost outside a wall the negated centre."""
    flow = None
    for axis in (0, 1):
        x = vel[axis]
        n = x.shape[axis]
        d = _diff(x, axis, -x.narrow(axis, 0, 1), -x.narrow(axis, n - 1, 1))
        flow = d if flow is None else flow + d
    return flow * (1.0 / (2.0 * dx))


def _neighbour_sum(p):
    h, w = p.shape
    zr = torch.zeros((1, w), dtype=p.dtype, device=p.device)
    zc = torch.zeros((h, 1), dtype=p.dtype, device=p.device)
    up = torch.cat([zr, p[:-1]], dim=0)
    down = torch.cat([p[1:], zr], dim=0)
    left = torch.cat([zc, p[:, :-1]], dim=1)
    right = torch.cat([p[:, 1:], zc], dim=1)
    return ((up + down) + left) + right


def sor(d, dx, iters, omega, store):
    """Red-black SOR from zero: the even cells, then the odd, per sweep."""
    h, w = d.shape
    dev = d.device
    ii = torch.arange(h, device=dev)[:, None]
    jj = torch.arange(w, device=dev)[None, :]
    count = 4 - ((ii == 0).long() + (ii == h - 1).long()
                 + (jj == 0).long() + (jj == w - 1).long())
    lut = torch.tensor([-1.0 / k for k in range(1, 7)],
                       dtype=torch.float64).to(torch.float32).to(dev)
    neg_inv = lut[count - 1]
    parity = (ii + jj) % 2
    p = torch.zeros((h, w), dtype=store, device=dev)
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
    for axis in (0, 1):
        n = p.shape[axis]
        g = _diff(p, axis, p.narrow(axis, 0, 1), p.narrow(axis, n - 1, 1))
        grads.append(g * inv)
    return vel - torch.stack(grads, dim=0)


def pack_rgb565(rgb):
    """``[3, H, W]`` unit floats -> byte-swapped RGB565 words (int32)."""
    def chan(c, bits):
        q = (c.to(torch.float32) * float(1 << bits)).to(torch.int32)
        return torch.clamp(q, 0, (1 << bits) - 1)

    word = (chan(rgb[0], 5) << 11) | (chan(rgb[1], 6) << 5) | chan(rgb[2], 5)
    return ((word << 8) | (word >> 8)) & 0xFFFF


def render(dye, s):
    """The ``[(H-1)*s, (W-1)*s]`` frame as int32 words, rendered in blocks
    of ``RENDER_ROWS`` source rows."""
    c = dye.to(torch.float32)
    _, h, w = c.shape
    if s == 1:
        return pack_rgb565(c[:, :-1, :-1])
    t = torch.from_numpy(np.arange(s, dtype=np.float32)
                         / np.float32(s)).to(c.device)
    tr = t[None, None, :, None]
    tc = t[None, None, None, :]
    out = torch.empty(((h - 1) * s, (w - 1) * s), dtype=torch.int32,
                      device=c.device)
    for r0 in range(0, h - 1, RENDER_ROWS):
        r1 = min(r0 + RENDER_ROWS, h - 1)
        src = c[:, r0:r1 + 1]
        rows = src[:, :-1, None, :] * (1 - tr) + src[:, 1:, None, :] * tr
        rows = rows.reshape(3, (r1 - r0) * s, w)
        up = rows[:, :, :-1, None] * (1 - tc) + rows[:, :, 1:, None] * tc
        out[r0 * s:r1 * s] = pack_rgb565(
            up.reshape(3, (r1 - r0) * s, (w - 1) * s))
    return out


def stores(sim: dict, lower: bool = False):
    """The dtypes the step stores the velocity and the dye in."""
    dye = _DTYPES[sim["color_dtype"]]
    if lower:
        return torch.bfloat16, _LOWER[dye]
    return torch.float32, dye


def lower_state(inputs: dict, sim: dict) -> dict:
    """The program's stored ``velocity`` and ``dye`` as ``lower=True``
    stores them: the control's starting state."""
    vel_store, dye_store = stores(sim, lower=True)
    return {"velocity": inputs["velocity"].to(vel_store).float(),
            "dye": inputs["dye"].to(dye_store)}


def step(inputs: dict, pos, val, sim: dict, scaling: int,
         lower: bool = False) -> dict:
    """One step from ``inputs`` (``velocity``, ``dye``) with the impulses
    ``pos``/``val``: ``{"velocity", "dye", "frame"}``, the frame as int32
    RGB565 words."""
    vel_store, dye_store = stores(sim, lower)
    dt, dx = sim["dt"], sim["dx"]
    md = sim["advect_max_disp"] if kernel_advect(sim) else None
    vel = inputs["velocity"].to(torch.float32)
    vel = advect(vel, vel, dt, True, md, False, vel_store).to(torch.float32)
    vel = drain(vel, pos, val, sim["max_impulses"])
    vel = vel.to(vel_store).to(torch.float32)
    p = sor(divergence(vel, dx), dx, sim["sor_iters"], sim["omega"],
            vel_store)
    vel = subtract_gradient(vel, p, dx).to(vel_store).to(torch.float32)
    dye = advect(inputs["dye"], vel, dt, False, md, True, dye_store)
    return {"velocity": vel, "dye": dye, "frame": render(dye, scaling)}


def _frame_words(frame: torch.Tensor) -> torch.Tensor:
    if frame.dtype == torch.uint16:
        frame = frame.view(torch.int16)
    return frame.to(torch.int32) & 0xFFFF


def compare(got: dict, want: dict) -> dict:
    """The numbers compared for one step: the largest velocity error over
    the largest reference speed component, the largest dye error, and the
    share of frame pixels whose word differs, in percent.  A NaN or an
    infinity anywhere reads as infinite."""
    gv = got["velocity"].to(torch.float32)
    wv = want["velocity"].to(torch.float32)
    scale = float(wv.abs().max())
    dv = (gv - wv).abs()
    dc = (got["dye"].to(torch.float32) - want["dye"].to(torch.float32)).abs()
    inf = float("inf")
    vel_rel = float(dv.max()) / scale if scale > 0 else float(dv.max())
    numbers = {
        "velocity_rel": vel_rel if torch.isfinite(gv).all() else inf,
        "dye_abs": float(dc.max()) if torch.isfinite(dc).all() else inf,
    }
    gf, wf = _frame_words(got["frame"]), _frame_words(want["frame"])
    if gf.shape != wf.shape:
        numbers["frame_pct"] = inf
    else:
        numbers["frame_pct"] = 100.0 * float((gf != wf).float().mean())
    return numbers
