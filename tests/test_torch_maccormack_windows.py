"""The window schedule of K5's one-launch route, on the CPU.

``csrc/advect.cu``'s ``maccormack_tile_kernel`` gives each thread block a
``TH x TW`` tile of the output.  The block works out its reach per axis
from its own cells' velocities (``maccormack_reach``), computes ``phi_hat``
(the forward pass) only on the tile +- that reach, clipped to the domain
or to the member tiles the tile touches, and runs the backward pass and
the limiter of its cells from that window.  This test runs the same
schedule with plain tensor ops: per tile, ``phi_hat`` is kept on the
window and set to NaN everywhere else, the backward pass of the plain
version samples it, and the tiles are stitched.  A tap outside the window
(even at weight 0) turns a cell into NaN, so the stitched result equals
``advect_maccormack_reference`` bit for bit only if every tile's window
holds all its taps.  The forward pass and the extrema are pointwise, so
they are taken from the whole grid.  The kernel's tile is 32 x 32; the
schedule does not depend on it, and 16 x 64 tiles run here too.

A NaN velocity has no answer in the plain version (it keeps the NaN, as
JAX's ``jnp.clip`` does), while the kernel's CFL clamp drops it.  Those
cases hold the window schedule to the whole-grid schedule of the same K2,
``_kernel_k2``, a model of the kernel's clamp: the CPU's view of holding
the window route to the two-launch route.
"""

import numpy as np
import pytest
import torch

from esp32_fluid_simulation_tpu_torch.ops.advect import noslip_axis_factor
from esp32_fluid_simulation_tpu_torch.ops.cuda.advect import (
    advect_maccormack_reference, advect_reference, maccormack_reach)

torch.set_num_threads(1)

DT = 1 / 30.
MD = 12

# (grid, channels, dtype, no_slip, member tile, output tile, velocity):
# velocity "reach" has |v|*dt beyond max_disp on some cells, "calm" stays
# within a few cells, "nan" is "calm" with a NaN and an inf cell (and a
# field of its own), "zero" has reach 0 (the window is the tile +- 1)
CASES = {
    "f32-2ch-noslip": ((61, 81), 2, torch.float32, True, None, (16, 64),
                       "reach"),
    "f32-1ch": ((61, 81), 1, torch.float32, False, None, (32, 32), "calm"),
    "f32-3ch-noslip-calm": ((64, 96), 3, torch.float32, True, None,
                            (16, 64), "calm"),
    "bf16-3ch": ((61, 81), 3, torch.bfloat16, False, None, (16, 64),
                 "reach"),
    "bf16-1ch-noslip": ((61, 81), 1, torch.bfloat16, True, None, (32, 32),
                        "calm"),
    "bf16-2ch-nan": ((61, 81), 2, torch.bfloat16, False, None, (16, 64),
                     "nan"),
    "f32-2ch-noslip-nan": ((64, 96), 2, torch.float32, True, None, (32, 32),
                           "nan"),
    "f32-2ch-zero": ((61, 81), 2, torch.float32, True, None, (16, 64),
                     "zero"),
    "f32-2ch-odd-members": ((34, 63), 2, torch.float32, True, (17, 21),
                           (16, 64), "reach"),
    "bf16-3ch-odd-members": ((34, 63), 3, torch.bfloat16, False, (17, 21),
                             (32, 32), "calm"),
    "bf16-3ch-even-members": ((64, 96), 3, torch.bfloat16, False, (32, 48),
                              (16, 64), "reach"),
    "f32-1ch-noslip-even-members-nan": ((64, 96), 1, torch.float32, True,
                                        (16, 24), (32, 32), "nan"),
}


def _inputs(shape, channels, dtype, velocity, seed):
    rng = np.random.default_rng(seed)
    sigma = {"reach": 200.0, "calm": 30.0, "nan": 30.0, "zero": 0.0}
    vel = (sigma[velocity] * rng.standard_normal((2,) + shape)).astype(
        np.float32)
    if velocity == "nan":
        vel[0, shape[0] // 2, shape[1] // 3] = np.nan
        vel[1, 3, shape[1] - 5] = np.inf
    vel = torch.from_numpy(vel)
    if channels == 2 and dtype == torch.float32 and velocity != "nan":
        return vel, vel
    field = rng.random((channels,) + shape, dtype=np.float32) * 2 - 0.5
    return torch.from_numpy(field).to(dtype), vel


def _kernel_k2(field, vel, dt, no_slip, max_disp, return_minmax=False,
               member=None):
    """K2 as ``csrc/advect.cu`` computes it for any velocity.  Its CFL clamp
    (``fmaxf``/``fminf``) drops a NaN displacement, so the source clamps to
    x - max_disp, and its no-slip test passes a NaN coordinate.  Built on
    the plain version: a NaN displacement is replaced by one beyond the
    clamp, and the no-slip factor is applied from the NaN coordinate.  On
    finite velocities it is the plain version."""
    v = torch.where(torch.isnan(vel), torch.full_like(vel, (max_disp + 1) / dt),
                    vel)
    got = advect_reference(field.to(torch.float32), v, dt, False, max_disp,
                           return_minmax=return_minmax, member=member)
    acc = got[0] if return_minmax else got
    if no_slip:
        h, w = vel.shape[-2:]
        mh, mw = member or (h, w)
        fi = torch.arange(h, dtype=torch.float32)[:, None].expand(h, w)
        fj = torch.arange(w, dtype=torch.float32)[None, :].expand(h, w)
        lo_i = (torch.arange(h)[:, None] // mh * mh).to(torch.float32)
        lo_j = (torch.arange(w)[None, :] // mw * mw).to(torch.float32)
        acc = acc * (noslip_axis_factor(fi - vel[0] * dt - lo_i, mh)
                     * noslip_axis_factor(fj - vel[1] * dt - lo_j, mw))
    if return_minmax:
        return tuple(x.to(field.dtype) for x in (acc,) + got[1:])
    return acc.to(field.dtype)


def _span(t0, t1, m, n):
    """The rows (columns) of the member tiles that cells t0 .. t1-1 touch,
    or the whole axis of n without members."""
    if m is None:
        return 0, n
    return t0 // m * m, (t1 - 1) // m * m + m


def _windowed(field, vel, no_slip, member, tile, shrink=0,
              k2=advect_reference, reach_vel=None):
    """K5 through the window schedule with the K2 ``k2``, stitched;
    ``shrink`` cuts each tile's reach and ``reach_vel`` replaces the
    velocities it is taken from (to show that the reach is needed).  A tile
    of the whole grid is the two-launch schedule."""
    reach_vel = vel if reach_vel is None else reach_vel
    h, w = field.shape[-2:]
    phi_hat, cmin, cmax = k2(field, vel, DT, no_slip, MD, return_minmax=True,
                             member=member)
    mh, mw = member or (None, None)
    out = torch.empty_like(field)
    for t0 in range(0, h, tile[0]):
        for u0 in range(0, w, tile[1]):
            t1, u1 = min(t0 + tile[0], h), min(u0 + tile[1], w)
            ri, rj = maccormack_reach(reach_vel[:, t0:t1, u0:u1], DT, MD)
            ri, rj = ri - shrink, rj - shrink
            lo_i, hi_i = _span(t0, t1, mh, h)
            lo_j, hi_j = _span(u0, u1, mw, w)
            wi0, wi1 = max(t0 - ri, lo_i), min(t1 + ri, hi_i)
            wj0, wj1 = max(u0 - rj, lo_j), min(u1 + rj, hi_j)
            window = torch.full_like(phi_hat, float("nan"))
            window[:, wi0:wi1, wj0:wj1] = phi_hat[:, wi0:wi1, wj0:wj1]
            back = k2(window, -vel, DT, no_slip, MD, member=member)
            own = (slice(None), slice(t0, t1), slice(u0, u1))
            ph = phi_hat[own]
            corrected = ph + 0.5 * (field[own] - back[own])
            out[own] = torch.clamp(corrected, torch.minimum(cmin[own], ph),
                                   torch.maximum(cmax[own], ph))
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_windows_stitch_to_the_reference(case):
    shape, channels, dtype, no_slip, member, tile, velocity = CASES[case]
    field, vel = _inputs(shape, channels, dtype, velocity,
                         sum(shape) + channels)
    if velocity == "nan":
        # the window route against the two-launch route, both on the
        # kernel's clamp
        want = _windowed(field, vel, no_slip, member, shape, k2=_kernel_k2)
        got = _windowed(field, vel, no_slip, member, tile, k2=_kernel_k2)
    else:
        want = advect_maccormack_reference(field, vel, DT, no_slip, MD,
                                           member=member)
        got = _windowed(field, vel, no_slip, member, tile)
    assert got.dtype == want.dtype == dtype
    assert not torch.isnan(want).any()
    assert torch.equal(got, want)


@pytest.mark.parametrize("member", [None, (17, 21)])
def test_kernel_k2_model_is_the_plain_version(member):
    """On finite velocities (the CFL clamp binding on some cells) the NaN
    cases' model of K2 is the plain version, bit for bit."""
    for velocity, channels, dtype, no_slip in (
            ("reach", 2, torch.float32, True),
            ("calm", 3, torch.bfloat16, False),
            ("reach", 1, torch.bfloat16, True)):
        field, vel = _inputs((34, 63), channels, dtype, velocity, channels)
        for want, got in zip(
                advect_reference(field, vel, DT, no_slip, MD,
                                 return_minmax=True, member=member),
                _kernel_k2(field, vel, DT, no_slip, MD, return_minmax=True,
                           member=member)):
            assert torch.equal(got, want)


def test_a_nan_velocity_takes_the_full_reach():
    """A NaN cell's source clamps to x - max_disp in both passes, so its
    tile needs the full reach: a schedule that took the NaN for a velocity
    at rest would leave that tap outside the window."""
    rng = np.random.default_rng(5)
    field = torch.from_numpy(rng.random((2, 64, 96), dtype=np.float32))
    vel = torch.zeros((2, 64, 96))
    vel[0, 40, 50] = float("nan")
    want = _windowed(field, vel, True, None, (64, 96), k2=_kernel_k2)
    got = _windowed(field, vel, True, None, (16, 64), k2=_kernel_k2)
    assert not torch.isnan(want).any()
    assert torch.equal(got, want)
    blind = _windowed(field, vel, True, None, (16, 64), k2=_kernel_k2,
                      reach_vel=torch.nan_to_num(vel, nan=0.0))
    assert torch.isnan(blind).any()


def test_the_reach_is_tight():
    """One cell less of reach leaves taps outside some window (where the
    CFL clamp makes a displacement a whole number of cells): the schedule
    test above can see a short window."""
    field, vel = _inputs((61, 81), 2, torch.float32, "reach", 7)
    got = _windowed(field, vel, True, None, (16, 64), shrink=1)
    assert torch.isnan(got).any()


def test_reach_counts_the_clamp_and_nan():
    """``min(ceil(max |v*dt|), max_disp) + 1`` per axis; a NaN or inf
    displacement counts as ``max_disp``."""
    vel = torch.zeros((2, 4, 5))
    assert maccormack_reach(vel, DT, MD) == (1, 1)
    vel[0, 1, 2] = -2.5 / DT
    vel[1, 3, 4] = 6.5 / DT
    assert maccormack_reach(vel, DT, MD) == (4, 8)
    vel[1, 0, 0] = 1e4
    assert maccormack_reach(vel, DT, MD) == (4, MD + 1)
    vel[1, 0, 0] = 0.0
    vel[0, 2, 2] = float("nan")
    assert maccormack_reach(vel, DT, MD) == (MD + 1, 8)
    vel[0, 2, 2] = float("-inf")
    assert maccormack_reach(vel, DT, MD) == (MD + 1, 8)
