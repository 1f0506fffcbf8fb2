"""The CUDA kernels against their plain PyTorch versions on the card.

Marked ``gpu``: they need a CUDA device and ``nvcc`` and skip without them
(the check happens in a fixture, never at import).  On a GPU machine, where
JAX (which ``tests/conftest.py`` imports) need not be installed:

    python -m pytest tests/test_torch_cuda.py -q --noconftest

Each kernel is built with ``--fmad=false`` and must equal its plain version
bit for bit; ``chip_smoke.py`` repeats these checks at the production
shapes.
"""

import numpy as np
import pytest
import torch

from esp32_fluid_simulation_tpu_torch import SimConfig, Impulses
from esp32_fluid_simulation_tpu_torch.ops.cuda.advect import (
    advect_kernel, advect_reference)
from esp32_fluid_simulation_tpu_torch.ops.cuda.project import (
    project_fused, project_fused_reference)
from esp32_fluid_simulation_tpu_torch.render.cuda_upscale import (
    render_rgb565_kernel, render_rgb565_reference)

pytestmark = pytest.mark.gpu

SHAPE = (61, 81)


@pytest.fixture
def rng():
    return np.random.default_rng(1234)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


def _on(x, dev):
    return torch.from_numpy(np.asarray(x)).to(dev)


def _bits(t):
    return t.view(torch.int16) if t.element_size() == 2 else t


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_advect_kernel_bit_equal(cuda, rng, dtype):
    vel = _on((200 * rng.standard_normal((2,) + SHAPE)).astype(np.float32),
              cuda)
    before = advect_kernel.launches
    got = advect_kernel(vel, vel, 1 / 30, True, max_disp=12,
                        self_advect=True)
    assert advect_kernel.launches == before + 1
    assert torch.equal(got, advect_reference(vel, vel, 1 / 30, True, 12))
    dye = _on(rng.random((3,) + SHAPE, dtype=np.float32) * 2 - 0.5,
              cuda).to(dtype)
    for bswap in (True, False):
        c, f = advect_kernel(dye, vel, 1 / 30, False, clip01=True,
                             rgb565=True, bswap=bswap)
        rc, rf = advect_reference(dye, vel, 1 / 30, False, clip01=True,
                                  rgb565=True, bswap=bswap)
        assert torch.equal(_bits(c), _bits(rc))
        assert torch.equal(_bits(f), _bits(rf))


def test_project_kernel_bit_equal(cuda, rng):
    cfg = SimConfig(shape=SHAPE)
    vel = _on(rng.normal(0, 40, (2,) + SHAPE).astype(np.float32), cuda)
    imp = Impulses.from_lists(
        cfg, [(20, 30), (20, 30), (40, 50), (99, -3)],
        [(90.0, -45.0), (33.0, 44.0), (-60.0, 120.0), (7.0, 8.0)],
        device=cuda)
    for impulses in (imp, None):
        v, p = project_fused(vel, 1.0, 10, 1.96, impulses=impulses)
        rv, rp = project_fused_reference(vel, 1.0, 10, 1.96, impulses)
        assert torch.equal(v, rv) and torch.equal(p, rp)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_render_kernel_bit_equal(cuda, rng, dtype):
    c = rng.random((3,) + SHAPE, dtype=np.float32)
    c[:, ::7, ::5] = 1.0
    c[:, 1::9, ::3] = 0.0
    color = _on(c, cuda).to(dtype)
    for s in (2, 3, 4):
        for bswap in (True, False):
            for unit_range in (False, True):
                got = render_rgb565_kernel(color, s, bswap, unit_range)
                want = render_rgb565_reference(color, s, bswap, unit_range)
                assert torch.equal(_bits(got), _bits(want))
