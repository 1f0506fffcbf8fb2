"""The launch plan of K10, the smoke MIP render, on the CPU.

``render/cuda_smoke.py``'s ``mip_plan`` chooses the route (16-byte loads of
8 bf16 or 4 f32 pixels, or one pixel a thread), the depth segments and the
grid, and ``csrc/smoke_mip.cu`` follows it: each thread folds its segment's
planes into running maxima seeded with -inf (a NaN once seen stays, a NaN
tap is taken), the segments' maxima are combined in order with the same
rule, and each live thread maps, packs and stores its pixel group.  This
test applies the same plan with plain tensor ops and holds the result to
``render_smoke_mip_reference`` and to the JAX ``render_smoke`` (its jnp
path on the CPU), bit for bit, on inputs that reach every branch: one
plane, fewer planes than segments, a depth that is not a multiple of
them, ``H*W`` not a multiple of the vector, a storage offset, NaN in one
segment, in several and in the first plane, signed zeros, ``vmax != 1``,
both ``bswap`` values, float32 and bfloat16.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from esp32_fluid_simulation_tpu.render import smoke as j_smoke
from esp32_fluid_simulation_tpu_torch.interop import tensor_to_numpy
from esp32_fluid_simulation_tpu_torch.render import heat_colormap
from esp32_fluid_simulation_tpu_torch.render.cuda_smoke import (
    SEGMENTS, MipPlan, mip_plan, render_smoke_mip_reference)
from esp32_fluid_simulation_tpu_torch.render.upscale import pack_rgb565
from mip_cases import MIP_CASES, mip_case

torch.set_num_threads(1)


def _nan_max(m, v):
    """The kernel's fold: keep m once it is NaN, take v if it is NaN."""
    return torch.where(torch.isnan(m) | (v <= m), m, v)


def _scheduled(density, plan, bswap, vmax):
    """K10 as the plan runs it: per-segment maxima of each pixel, combined
    in segment order, mapped and packed, and stored thread by thread."""
    d, h, w = density.shape
    npix = h * w
    cols = density.reshape(d, npix).to(torch.float32)
    parts = []
    for s in range(plan.segments):
        m = torch.full((npix,), float("-inf"))
        for z in range(min(d, s * plan.seg_len),
                       min(d, (s + 1) * plan.seg_len)):
            m = _nan_max(m, cols[z])
        parts.append(m)
    m = parts[0]
    for part in parts[1:]:
        m = _nan_max(m, part)
    t = m * float(np.float32(1.0 / vmax))
    words = pack_rgb565(heat_colormap(t), bswap=bswap).view(torch.int16)
    threads = torch.arange(plan.blocks * plan.threads_x)
    live = threads[threads * plan.vec < npix]
    pix = (live[:, None] * plan.vec + torch.arange(plan.vec)).reshape(-1)
    # a live group is whole, and every pixel is stored exactly once
    assert int(pix.max()) < npix
    assert torch.equal(torch.bincount(pix, minlength=npix),
                       torch.ones(npix, dtype=torch.int64))
    assert threads.numel() * plan.vec - npix == plan.tail
    out = torch.zeros(npix, dtype=torch.int16)
    out[pix] = words[pix]
    return out.view(torch.uint16).view(h, w)


def _jax_render(density, bswap, vmax):
    x = tensor_to_numpy(density)
    if density.dtype == torch.bfloat16:
        x = x.view(jnp.bfloat16)
    return np.asarray(j_smoke.render_smoke(jnp.asarray(x), bswap=bswap,
                                           vmax=vmax))


@pytest.mark.parametrize("bswap", [True, False])
@pytest.mark.parametrize("case", list(MIP_CASES))
def test_plan_matches_the_reference_and_jax(case, bswap):
    vol, vmax = mip_case(case)
    plan = mip_plan(vol)
    assert plan.route == MIP_CASES[case][-1]
    assert plan.segments * plan.seg_len >= vol.shape[0]
    got = _scheduled(vol, plan, bswap, vmax)
    want = render_smoke_mip_reference(vol, bswap, vmax)
    assert got.dtype == want.dtype == torch.uint16
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))
    np.testing.assert_array_equal(tensor_to_numpy(got),
                                  _jax_render(vol, bswap, vmax))
    nan = torch.isnan(vol.float()).any(0)
    assert (got.view(torch.int16)[nan] == 0).all()


def test_plan_geometry():
    """The route, the vector width, the segments and the tail."""
    vol = torch.empty((256, 256, 256), dtype=torch.bfloat16)
    plan = mip_plan(vol)
    assert plan == MipPlan(8, 256 // SEGMENTS, SEGMENTS, plan.threads_x,
                           256 * 256 // (8 * plan.threads_x), 0)
    assert mip_plan(vol.float()).vec == 4
    odd = mip_plan(torch.empty((3, 13, 129)))
    assert odd.vec == 1 and odd.seg_len == 1
    assert odd.tail == odd.blocks * odd.threads_x - 13 * 129
    assert 0 <= odd.tail < odd.threads_x


def test_a_short_plan_is_seen():
    """Segments that miss the last plane leave its maxima out: the schedule
    test above can see a plan that does not cover the depth."""
    vol, _ = mip_case("d-not-a-multiple-f32")
    vol.mul_(0.5)
    vol[-1] = 0.9                 # the last plane holds every maximum
    plan = mip_plan(vol)
    short = plan._replace(seg_len=(vol.shape[0] - 1) // plan.segments)
    want = render_smoke_mip_reference(vol)
    assert torch.equal(_scheduled(vol, plan, True, 1.0).view(torch.int16),
                       want.view(torch.int16))
    assert not torch.equal(_scheduled(vol, short, True, 1.0)
                           .view(torch.int16), want.view(torch.int16))
