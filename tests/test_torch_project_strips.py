"""The schedule of K1's one-launch route, on the CPU.

``csrc/project.cu``'s window route cuts the owned cells into column strips
and each strip into row segments (``ops/cuda/project.py:strip_plan``); a
block walks each segment down its rows, and each step runs the drain and
``dx * div`` of the incoming row, half-sweep ``k'`` on the row ``k'`` above
it (from registers holding each stage's last two rows, the horizontal
neighbour from the next lane), and the gradient of the row ``2*iters + 1``
above it.  ``_emulate`` is that kernel's index arithmetic in numpy, lane
for lane: the strips, the segments with their ``2*iters + 1``-row overlap,
the row lag, the rows above the trapezoid computed from ring slots not yet
written (NaN here), the doubled ring of ``dx * div``, the row flags as bit
masks, the chunk edges of the shuffles, the drain list of each block
and the cells held at 0 outside the domain.  Stitched over every block it
must equal the whole-grid ``project_fused_reference`` bit for bit: impulses
on the strip and segment seams, ragged strips and segments, blocks of a
larger domain, iters 0, 1, 10 and 15.  (Member tiles take the trapezoid
route, whose windows ``test_torch_project_windows.py`` holds.)  The
emulation holds a block's threads as one row of plane columns: a thread's
neighbour across a warp's edge, which the kernel passes through shared
memory, is the row's next column here.
"""

import numpy as np
import pytest
import torch

from esp32_fluid_simulation_tpu_torch import SimConfig, Impulses
from esp32_fluid_simulation_tpu_torch.ops.cuda.modes import Block
from esp32_fluid_simulation_tpu_torch.ops.cuda.project import (
    STRIP_COLUMNS, project_fused_reference, strip_plan)

torch.set_num_threads(1)

F = np.float32
W_LO, W_HI, OUT = 1, 2, 4  # kWallLo, kWallHi, kOutside
P = STRIP_COLUMNS // 2     # a block's plane columns, one a thread


def _neg_inv(n_walls):
    """rb_neg_inv: -1/a_ii, double divisions rounded to float."""
    return np.array([-1.0, -1.0 / 2.0, -1.0 / 3.0, -1.0 / 4.0],
                    dtype=np.float64).astype(F)[4 - 1 - np.asarray(n_walls)]


def _walls(gx, n):
    """(lo, hi) of global coordinate gx: the domain's walls (n cells)."""
    return gx == 0, gx == n - 1


def _side(x, direction):
    """x in the lane one plane column left (-1) or right (+1), 0 beyond."""
    y = np.zeros_like(x)
    if direction < 0:
        y[1:] = x[:-1]
    else:
        y[:-1] = x[1:]
    return y


def _drain_list(impulses, gh, gw, r0, r1, c0, c1):
    """load_drain: clamped slots, active, in rows [r0, r1] x cols [c0, c1],
    the last active slot at a cell winning."""
    if impulses is None:
        return {}
    pos = impulses.pos.numpy()
    vel = impulses.velocity.numpy().astype(F)
    act = impulses.active.numpy()
    keep = {}
    for t in range(len(pos)):
        pi = min(max(int(pos[t, 0]), 0), gh - 1)
        pj = min(max(int(pos[t, 1]), 0), gw - 1)
        if act[t] and r0 <= pi <= r1 and c0 <= pj <= c1:
            keep[(pi, pj)] = vel[t]
    return keep


def _drained(d, v, gi, gj, ch):
    """``drained`` for each lane: the drain list's value at (gi, gj[m])."""
    if not d:
        return v
    v = v.copy()
    for (pi, pj), val in d.items():
        if pi == gi:
            v[gj == pj] = val[ch]
    return v


def _emulate(vel, iters, impulses, n_strips, n_segs, geom=None,
             halo=0, dx=1.0, omega=1.96):
    """project_tile_kernel over every block: (velocity, pressure) of the
    owned cells, NaN where no block wrote."""
    vel = vel.numpy()
    _, H, W = vel.shape
    bh, bw = H - 2 * halo, W - 2 * halo
    assert -(-bw // n_strips) + 2 * (2 * iters + 1) <= 2 * P, \
        "a window wider than the block's columns"
    out = np.full((2, bh, bw), np.nan, F)
    p_out = np.full((bh, bw), np.nan, F)
    saved = np.seterr(all="ignore")  # the garbage above the trapezoid
    try:
        _blocks(vel, out, p_out, iters, impulses, n_strips, n_segs,
                geom or (0, 0, H, W), halo, dx, omega)
    finally:
        np.seterr(**saved)
    return torch.from_numpy(out), torch.from_numpy(p_out)


def _blocks(vel, out, p_out, iters, impulses, n_strips, n_segs,
            geom, halo, dx, omega):
    """Every block of ``_emulate``, writing into ``out`` and ``p_out``."""
    _, H, W = vel.shape
    oi, oj, GH, GW = geom
    block_mode = halo > 0
    kmax = 20 if iters <= 10 else 30  # kStripKmaxA / kStripKmaxB
    K = 2 * iters
    R, NR, off = K + 1, K + 2, kmax - K
    inv2dx, one_m_w = F(1.0 / (2.0 * dx)), F(1.0 - omega)
    dx, omega = F(dx), F(omega)
    bh, bw = H - 2 * halo, W - 2 * halo
    m = np.arange(P)
    for sx in range(n_strips):
        for sy in range(n_segs):
            u0 = sx * (bw // n_strips) + min(sx, bw % n_strips)
            tw = bw // n_strips + (sx < bw % n_strips)
            t0 = sy * (bh // n_segs) + min(sy, bh % n_segs)
            ts = bh // n_segs + (sy < bh % n_segs)
            i0, i1 = halo + t0, halo + t0 + ts
            aj0 = halo + u0 - R
            wj0 = aj0 + oj
            d = _drain_list(impulses, GH, GW, i0 - K - 1 + oi, i1 + K + oi,
                            wj0 - 1, wj0 + 2 * P)
            # the lane's cells (e, m): flags, -1/a_ii of the column walls,
            # owned columns, array and global columns
            b = 2 * m[None, :] + np.arange(2)[:, None]
            j = aj0 + b
            gj = j + oj
            inside = (b < tw + 2 * R) & (j >= 0) & (j < W) & (gj >= 0) & (
                gj < GW)
            lo, hi = _walls(gj, GW)
            cf = np.where(inside, lo * W_LO | hi * W_HI, OUT)
            negc = _neg_inv((cf & W_LO) + ((cf & W_HI) >> 1))
            negw = _neg_inv(1 + (cf & W_LO) + ((cf & W_HI) >> 1))
            owned = (b >= R) & (b < R + tw)
            jc = np.clip(j, 0, W - 1)
            # the columns beside the first and the last thread's cells
            je = np.array([aj0 - 1, aj0 + 2 * P])

            def row(plane, r, jc=jc):
                return vel[plane, min(max(r, 0), H - 1)][jc]

            h1 = np.zeros((kmax + 1, P), F)
            h2 = np.zeros((kmax + 1, P), F)
            h3 = np.zeros(P, F)
            tau0 = i0 - K
            vxa = np.stack([_drained(d, row(0, tau0 - 1)[e], tau0 - 1 + oi,
                                     gj[e], 0) for e in range(2)])
            vxb = np.stack([_drained(d, row(0, tau0)[e], tau0 + oi, gj[e], 0)
                            for e in range(2)])
            # the ring of dx * div, doubled; slots not yet written hold
            # garbage; bit j of the masks: row tau - j's flags
            dring = np.full((2 * (kmax + 2), 2, P), np.nan, F)
            mlo = mhi = mout = 0
            sl = 0
            for n in range(ts + 2 * K + 1):
                tau = tau0 + n
                S = (tau + oi + wj0 + 1) & 1
                rg = tau - K - 1
                grad = n >= 2 * K + 1
                vxn, vy = row(0, tau + 1), row(1, tau)
                vye = row(1, tau, np.clip(je, 0, W - 1))
                gx, gy = row(0, rg), row(1, rg)
                # 1. the half-sweeps
                cur = np.zeros((kmax + 1, P), F)
                for k in range(1, kmax + 1):
                    q = sl + NR + off - k
                    dq = dring[q, (k - 1) & 1]
                    wlo = (mlo << off >> k) & 1
                    whi = (mhi << off >> k) & 1
                    rout = (mout << off >> k) & 1
                    here = h1[k - 1]
                    side = _side(here, -1 if S == 0 else 1)
                    up, dn = h2[k - 1], cur[k - 1]
                    lf, rt = (here, side) if S else (side, here)
                    pc = h2[k - 2] if k >= 2 else np.zeros(P, F)
                    c = cf[S]
                    neg = negw[S] if wlo or whi else negc[S]
                    nb = ((up + dn) + lf) + rt
                    v = one_m_w * pc + omega * (neg * (dq - nb))
                    cur[k] = np.where((c & OUT) | rout | (k <= off), F(0), v)
                # 2. the gradient of row rg
                if grad:
                    rf = ((mlo >> (K + 1)) & 1) * W_LO | (
                        (mhi >> (K + 1)) & 1) * W_HI
                    p0 = (rg + oi + wj0) & 1
                    plane1 = (h2[kmax], h1[kmax], cur[kmax])
                    plane0 = (h3, h2[kmax - 1], h1[kmax - 1])
                    a_up, a_c, a_dn = plane0 if p0 else plane1
                    b_up, b_c, b_dn = plane1 if p0 else plane0
                    a_l, b_r = _side(a_c, -1), _side(b_c, 1)
                    for e in range(2):
                        pc = a_c if e else b_c
                        p_im1 = pc if rf & W_LO else (b_up if e else a_up)
                        p_ip1 = pc if rf & W_HI else (b_dn if e else a_dn)
                        p_jm1 = np.where(cf[e] & W_LO, pc, b_c if e else a_l)
                        p_jp1 = np.where(cf[e] & W_HI, pc, b_r if e else a_c)
                        vxc = _drained(d, gx[e], rg + oi, gj[e], 0)
                        vyc = _drained(d, gy[e], rg + oi, gj[e], 1)
                        cols = j[e][owned[e]] - halo
                        out[0, rg - halo, cols] = (
                            vxc - (p_ip1 - p_im1) * inv2dx)[owned[e]]
                        out[1, rg - halo, cols] = (
                            vyc - (p_jp1 - p_jm1) * inv2dx)[owned[e]]
                        p_out[rg - halo, cols] = pc[owned[e]]
                # 3. the drain and dx * div of row tau
                gi = tau + oi
                rf = OUT
                if 0 <= tau < H and 0 <= gi < GH:
                    lo, hi = _walls(gi, GH)
                    rf = lo * W_LO | hi * W_HI
                mlo |= bool(rf & W_LO)
                mhi |= bool(rf & W_HI)
                mout |= bool(rf & OUT)
                p0 = (gi + wj0) & 1
                vyd = np.stack([_drained(d, vy[e], gi, gj[e], 1)
                                for e in range(2)])
                vxn = np.stack([_drained(d, vxn[e], gi + 1, gj[e], 0)
                                for e in range(2)])
                vyed = _drained(d, vye, gi, je + oj, 1)
                vy_l, vy_r = _side(vyd[1], -1), _side(vyd[0], 1)
                vy_l[0], vy_r[-1] = vyed
                for e in range(2):
                    c = cf[e]
                    vxc, vyc = vxb[e], vyd[e]
                    t_up = (-vxc if rf & W_LO else
                            np.zeros(P, F) if block_mode and tau == 0 else vxa[e])
                    t_dn = (-vxc if rf & W_HI else
                            np.zeros(P, F) if block_mode and tau == H - 1
                            else vxn[e])
                    t_lf = np.where(c & W_LO, -vyc, np.where(
                        (j[e] == 0) & block_mode, F(0), vyd[0] if e else vy_l))
                    t_rt = np.where(c & W_HI, -vyc, np.where(
                        (j[e] == W - 1) & block_mode, F(0),
                        vy_r if e else vyd[1]))
                    div = ((-t_up + t_dn) + (-t_lf + t_rt)) * inv2dx
                    v = np.where((rf | c) & OUT, F(0), dx * div)
                    dring[sl, (p0 + e) & 1] = dring[sl + NR, (p0 + e) & 1] = v
                # 4. move down a step
                h3 = h2[kmax - 1].copy()
                h2, h1 = h1, cur
                vxa, vxb = vxb, vxn
                sl = 0 if sl + 1 == NR else sl + 1
                mlo, mhi, mout = (x << 1 & 0xffffffff for x in (mlo, mhi, mout))


# (grid, iters, (strips, segments) or None: strip_plan at 40 blocks, block
# of a larger domain (origin, domain) or None)
CASES = {
    "61x81-iters0": ((61, 81), 0, (3, 4), None),
    "61x81-iters1-ragged": ((61, 81), 1, (4, 5), None),
    "61x81-iters10-plan": ((61, 81), 10, None, None),
    "61x81-iters10-ragged": ((61, 81), 10, (2, 7), None),
    "61x81-iters15": ((61, 81), 15, (2, 3), None),
    "64x96-iters0": ((64, 96), 0, (5, 3), None),
    "64x96-iters1": ((64, 96), 1, (3, 8), None),
    "64x96-iters10-plan": ((64, 96), 10, None, None),
    "64x96-iters10-narrow": ((64, 96), 10, (5, 3), None),
    "64x96-iters15-ragged": ((64, 96), 15, (3, 5), None),
    "61x81-iters15-one-row-segments": ((61, 81), 15, (2, 61), None),
    "64x96-iters1-plan": ((64, 96), 1, None, None),
    "64x96-iters10-block": ((32, 48), 10, (2, 3), ((32, 48), (64, 96))),
    "64x96-iters1-block-corner": ((32, 48), 1, (3, 2), ((0, 48), (64, 96))),
}


def _impulses(shape, seams):
    """Slots on the strip and segment seams, one row or column off them,
    a duplicate (the last active slot wins) and one out of range
    (clamped)."""
    (r, c) = seams
    cells = [(r, c), (r - 1, 3), (r, c), (shape[0] - 2, c - 1),
             (r // 2, c + 1), (shape[0] + 5, -3), (r + 1, shape[1] - 1)]
    vels = [(90.0, -45.0), (33.0, 44.0), (-60.0, 120.0), (7.0, 8.0),
            (-25.0, 15.0), (5.0, 5.0), (11.0, -12.0)]
    return Impulses.from_lists(SimConfig(shape=shape, max_impulses=8), cells,
                               vels, device="cpu")


@pytest.mark.parametrize("with_impulses", [True, False],
                         ids=["impulses", "no-impulses"])
@pytest.mark.parametrize("case", list(CASES))
def test_strip_schedule_matches_the_whole_grid(case, with_impulses):
    shape, iters, plan, block = CASES[case]
    g = 2 * iters + 2
    if block is None:
        bh, bw = shape
        domain = shape
    else:
        (bh, bw), ((ox, oy), domain) = shape, block
    n_strips, n_segs = plan or strip_plan(bh, bw, iters, 40)
    rng = np.random.default_rng(sum(shape) + iters)
    vel = torch.from_numpy(rng.normal(0, 40, (2,) + domain).astype(F))
    seams = ((bh // n_segs) + (block[0][0] if block else 0),
             (bw // n_strips) + (block[0][1] if block else 0))
    impulses = _impulses(domain, seams) if with_impulses else None
    if block is None:
        want_v, want_p = project_fused_reference(vel, 1.0, iters, 1.96,
                                                 impulses)
        got_v, got_p = _emulate(vel, iters, impulses, n_strips, n_segs)
    else:
        pad = torch.nn.functional.pad(vel, (g, g, g, g))
        vpad = pad[:, ox:ox + bh + 2 * g, oy:oy + bw + 2 * g].contiguous()
        blk = Block(ox, oy, *domain, g, bh, bw)
        want_v, want_p = project_fused_reference(vpad, 1.0, iters, 1.96,
                                                 impulses, None, blk)
        got_v, got_p = _emulate(vpad, iters, impulses, n_strips, n_segs,
                                (*blk.origin, *domain), g)
    assert torch.equal(got_v, want_v)
    assert torch.equal(got_p, want_p)


@pytest.mark.parametrize("shape, iters, blocks, want", [
    ((4096, 4096), 10, 1056, (20, 53)),
    ((4096, 4096), 15, 1056, (22, 48)),
    ((61, 81), 10, 1320, (1, 61)),
    ((256, 256), 1, 8, (2, 4)),
], ids=["config0", "iters15", "small", "few-blocks"])
def test_strip_plan(shape, iters, blocks, want):
    """The plan of a shape: the fewest strips whose windows fit the lanes,
    cut evenly (4096 columns at iters 10 into 20 strips of 204-205, not
    19 x 214 + 30), and segments for the blocks asked."""
    bh, bw = shape
    n_strips, n_segs = strip_plan(bh, bw, iters, blocks)
    assert (n_strips, n_segs) == want
    widths = {bw // n_strips + (s < bw % n_strips) for s in range(n_strips)}
    assert max(widths) - min(widths) <= 1
    assert max(widths) + 2 * (2 * iters + 1) <= STRIP_COLUMNS
