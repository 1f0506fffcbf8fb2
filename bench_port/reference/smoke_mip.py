"""Plain float32 PyTorch reference of one step of the 3D smoke plume and
its top-down MIP frame.

It stands alone: it imports nothing of the program and takes from a run
only the step's input state (velocity, density and temperature as the
program stored them) and the traffic's impulse lists for that step.  One
step is the buoyant smoke of Fedkiw, Stam & Jensen (2001) on a
stable-fluids projection (Stam 1999), in the program's order:

1. self-advect the velocity: semi-Lagrangian, trilinear at the
   domain-clamped backtrace, the displacement clamped to
   ``advect_max_disp`` cells per axis (the advection kernel's rule, which
   the configuration routes to), the no-slip discount from the unclamped
   backtrace;
2. advect density and temperature through the velocity step 1 returned,
   with no discount;
3. inject at the spherical source and add the buoyancy
   ``(alpha*T - beta*rho) * dt`` against axis 0 (low indices are up),
   each scalar op rounded in the scalars' storage dtype;
4. drain the impulse queue: positions clamped to the grid, the last slot
   wins at a repeated cell;
5. project: divergence with reflected ghosts, ``sor_iters`` red-black SOR
   sweeps from zero at ``omega`` (``-1/a_ii`` by double division rounded
   to float32, neighbour sums in axis order, minus then plus), gradient
   subtract with Neumann ghosts;
6. dissipate the scalars (none at ``dissipation`` 0);
7. render: the maximum of the stored density along axis 0 (NaN
   propagating), the heat ramp ``clip(3t - k, 0, 1)``, the top 5/6/5
   bits packed and byte-swapped.

Every product and sum is its own PyTorch op, rounded on its own, in the
order listed, so the comparison can hold the program to the bit.

``lower=True`` is the control: the same step with every stored field one
precision down (velocity and pressure in bfloat16, density and
temperature in float8 e4m3 for bfloat16 scalars), the arithmetic in
between in float32.  It stands in for the tempting change of halving
what the step stores; the comparison must call it wrong.
"""

from __future__ import annotations

import torch

# a float32 product or sum of this file must not run in TF32
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# each number ``compare`` returns, with the output it judges
NUMBERS = {"velocity_rel": "velocity", "density_abs": "density",
           "temperature_rel": "temperature", "frame_pct": "frame"}
# the drag queue's slots a step (the program's ``SmokeConfig.max_impulses``)
SLOTS = 16
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_LOWER = {torch.float32: torch.bfloat16, torch.bfloat16: torch.float8_e4m3fn}


def stores(sim: dict, lower: bool = False):
    """The dtypes the step stores the velocity and the scalars in."""
    vel, scalars = _DTYPES[sim["dtype"]], _DTYPES[sim["scalar_dtype"]]
    if lower:
        return _LOWER[vel], _LOWER[scalars]
    return vel, scalars


def _rounded(x: torch.Tensor, store) -> torch.Tensor:
    return x.to(store).to(torch.float32)


def _noslip(raw: torch.Tensor, n: int) -> torch.Tensor:
    under = raw < 0
    over = raw >= n - 1
    overshoot = torch.where(under, -raw, raw - (n - 1))
    return torch.where(under | over,
                       torch.where(overshoot < 0.5, 1.0 - 2.0 * overshoot,
                                   torch.zeros_like(raw)),
                       torch.ones_like(raw))


def advect(field, vel, dt, no_slip, max_disp):
    """Semi-Lagrangian advection of ``field`` ``[C, D, H, W]`` by ``vel``
    ``[3, D, H, W]``, in float32."""
    f = field.to(torch.float32)
    d, h, w = vel.shape[-3:]
    dev = vel.device
    grid = torch.meshgrid(*(torch.arange(n, device=dev).to(torch.float32)
                            for n in (d, h, w)), indexing="ij")
    raw = [grid[k] - vel[k] * dt for k in range(3)]
    src = []
    for x, r, n in zip(grid, raw, (d, h, w)):
        s = torch.minimum(torch.maximum(r, x - max_disp), x + max_disp)
        src.append(torch.clamp(s, 0.0, n - 1.0))
    lo = [torch.clamp(torch.floor(s), 0.0, n - 2.0)
          for s, n in zip(src, (d, h, w))]
    dz, di, dj = (s - x for s, x in zip(src, lo))
    one_m_dj = 1.0 - dj
    z0, i0, j0 = (x.long() for x in lo)

    def column(a, b):
        return (f[:, z0 + a, i0 + b, j0] * one_m_dj
                + f[:, z0 + a, i0 + b, j0 + 1] * dj)

    acc = column(0, 0) * ((1.0 - dz) * (1.0 - di))
    acc = acc + column(0, 1) * ((1.0 - dz) * di)
    acc = acc + column(1, 0) * (dz * (1.0 - di))
    acc = acc + column(1, 1) * (dz * di)
    if no_slip:
        acc = acc * (_noslip(raw[0], d) * _noslip(raw[1], h)
                     * _noslip(raw[2], w))
    return acc


def source_mask(sim: dict, device) -> torch.Tensor:
    """The spherical source, 1 inside and 0 outside, in float32: squared
    distances summed in float64, axis by axis."""
    shape = sim["shape"]
    rad = sim["source_radius"] * min(shape)
    dist2 = None
    for axis, (n, frac) in enumerate(zip(shape, sim["source_center"])):
        x = torch.arange(n, dtype=torch.float64, device=device) - frac * n
        view = [1, 1, 1]
        view[axis] = n
        sq = (x * x).view(view)
        dist2 = sq if dist2 is None else dist2 + sq
    return (dist2 <= rad * rad).to(torch.float32)


def drain(vel, pos, val, k):
    """The first ``k`` impulses written into ``vel`` in order, so the last
    of a repeated cell stays."""
    dims = vel.shape[1:]
    for p, v in list(zip(pos, val))[:k]:
        cell = tuple(min(max(int(x), 0), n - 1) for x, n in zip(p, dims))
        for c in range(3):
            vel[(c,) + cell] = float(v[c])
    return vel


def _diff(x, axis, ghost_lo, ghost_hi):
    n = x.shape[axis]
    ext = torch.cat([ghost_lo, x, ghost_hi], dim=axis)
    return ext.narrow(axis, 2, n) - ext.narrow(axis, 0, n)


def divergence(vel, dx):
    """Central differences, the ghost outside a wall the negated centre."""
    flow = None
    for axis in range(3):
        x = vel[axis]
        n = x.shape[axis]
        g = _diff(x, axis, -x.narrow(axis, 0, 1), -x.narrow(axis, n - 1, 1))
        flow = g if flow is None else flow + g
    return flow * (1.0 / (2.0 * dx))


def _neighbour_sum(p):
    total = None
    for axis in range(3):
        n = p.shape[axis]
        zero = torch.zeros_like(p.narrow(axis, 0, 1))
        for nb in (torch.cat([zero, p.narrow(axis, 0, n - 1)], dim=axis),
                   torch.cat([p.narrow(axis, 1, n - 1), zero], dim=axis)):
            total = nb if total is None else total + nb
    return total


def sor(d, dx, iters, omega, store):
    """Red-black SOR from zero: the even cells, then the odd, per sweep."""
    dev = d.device
    idx = [torch.arange(n, device=dev).view([n if a == b else 1
                                             for b in range(3)])
           for a, n in enumerate(d.shape)]
    count = sum(2 - (x == 0).long() - (x == n - 1).long()
                for x, n in zip(idx, d.shape))
    lut = torch.tensor([-1.0 / k for k in range(1, 7)],
                       dtype=torch.float64).to(torch.float32).to(dev)
    neg_inv = lut[count - 1]
    parity = (idx[0] + idx[1] + idx[2]) % 2
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
    for axis in range(3):
        n = p.shape[axis]
        g = _diff(p, axis, p.narrow(axis, 0, 1), p.narrow(axis, n - 1, 1))
        grads.append(g * inv)
    return vel - torch.stack(grads, dim=0)


def render(density):
    """The MIP along axis 0 as byte-swapped RGB565 words (int32)."""
    t = torch.amax(density.to(torch.float32), dim=0)
    rgb = [torch.clamp(3.0 * t - k, 0.0, 1.0) if k else
           torch.clamp(3.0 * t, 0.0, 1.0) for k in (0.0, 1.0, 2.0)]

    def chan(c, bits):
        q = (c * float(1 << bits)).to(torch.int32)
        return torch.clamp(q, 0, (1 << bits) - 1)

    word = (chan(rgb[0], 5) << 11) | (chan(rgb[1], 6) << 5) | chan(rgb[2], 5)
    return ((word << 8) | (word >> 8)) & 0xFFFF


def lower_state(inputs: dict, sim: dict) -> dict:
    """The program's stored inputs as ``lower=True`` stores them: the
    control's starting state."""
    vel_store, sc_store = stores(sim, lower=True)
    return {"velocity": inputs["velocity"].to(vel_store).float(),
            "density": inputs["density"].to(sc_store),
            "temperature": inputs["temperature"].to(sc_store)}


def step(inputs: dict, pos, val, sim: dict, scaling: int,
         lower: bool = False) -> dict:
    """One step from ``inputs`` (``velocity``, ``density``,
    ``temperature``) with the impulses ``pos``/``val`` (``(z, i, j)``
    cells, ``(v_z, v_i, v_j)`` cells/s): ``{"velocity", "density",
    "temperature", "frame"}``, the frame as int32 RGB565 words."""
    if scaling != 1:
        raise ValueError("the plume's frame is rendered at scaling 1")
    if sim["vorticity_eps"] or sim["solver"] != "sor":
        raise ValueError("this reference steps the RB-SOR plume without "
                         "vorticity confinement")
    vel_store, sc_store = stores(sim, lower)
    dt, dx, md = sim["dt"], sim["dx"], sim["advect_max_disp"]
    vel = inputs["velocity"].to(torch.float32)
    vel = _rounded(advect(vel, vel, dt, True, md), vel_store)
    scal = torch.stack([inputs["density"].to(torch.float32),
                        inputs["temperature"].to(torch.float32)])
    scal = _rounded(advect(scal, vel, dt, False, md), sc_store)
    rho, temp = scal[0], scal[1]

    src = source_mask(sim, vel.device)
    rho = _rounded(rho + _rounded(src * (dt * sim["source_density"]),
                                  sc_store), sc_store)
    rho = torch.clamp(rho, max=1.0)
    temp = _rounded(temp + _rounded(src * (dt * sim["source_temperature"]),
                                    sc_store), sc_store)
    buoy = (sim["buoyancy_alpha"] * temp - sim["buoyancy_beta"] * rho) * dt
    vel[0] = vel[0] - buoy
    vel = _rounded(drain(vel, pos, val, SLOTS), vel_store)

    p = sor(divergence(vel, dx), dx, sim["sor_iters"], sim["omega"],
            vel_store)
    vel = _rounded(subtract_gradient(vel, p, dx), vel_store)
    if sim["dissipation"] > 0:
        decay = 1.0 - sim["dissipation"] * dt
        rho = _rounded(rho * decay, sc_store)
        temp = _rounded(temp * decay, sc_store)
    rho, temp = rho.to(sc_store), temp.to(sc_store)
    return {"velocity": vel, "density": rho, "temperature": temp,
            "frame": render(rho)}


def _frame_words(frame: torch.Tensor) -> torch.Tensor:
    if frame.dtype == torch.uint16:
        frame = frame.view(torch.int16)
    return frame.to(torch.int32) & 0xFFFF


def _relative(got, want):
    """The largest error over the largest reference magnitude (the error
    itself where the reference is 0); infinite where ``got`` is not
    finite."""
    g, w = got.to(torch.float32), want.to(torch.float32)
    if not torch.isfinite(g).all():
        return float("inf")
    err, scale = float((g - w).abs().max()), float(w.abs().max())
    return err / scale if scale > 0 else err


def compare(got: dict, want: dict) -> dict:
    """The numbers compared for one step: the velocity's and the
    temperature's largest error relative to the reference's largest
    magnitude (the temperature grows with no bound at the source), the
    density's largest error, and the share of frame words that differ, in
    percent.  A NaN or an infinity anywhere reads as infinite."""
    gd = got["density"].to(torch.float32)
    dd = (gd - want["density"].to(torch.float32)).abs()
    numbers = {
        "velocity_rel": _relative(got["velocity"], want["velocity"]),
        "density_abs": float(dd.max()) if torch.isfinite(dd).all()
        else float("inf"),
        "temperature_rel": _relative(got["temperature"],
                                     want["temperature"]),
    }
    gf, wf = _frame_words(got["frame"]), _frame_words(want["frame"])
    if gf.shape != wf.shape:
        numbers["frame_pct"] = float("inf")
    else:
        numbers["frame_pct"] = 100.0 * float((gf != wf).float().mean())
    return numbers
