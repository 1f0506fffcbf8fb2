"""The volumes that K10, the smoke MIP render, is held on.

One table for the CPU schedule test (``test_torch_mip_schedule.py``), the
card's tests (``test_torch_cuda.py``) and ``chip_smoke.py`` phase 1b.
Together they reach every branch of ``csrc/smoke_mip.cu`` and its launch
plan: one plane, fewer planes than depth segments, a depth that is not a
multiple of them, ``H*W`` not a multiple of the vector width (8 bf16 or 4
f32 pixels), a storage offset that breaks the 16-byte alignment and one
that keeps it, NaN in one segment, in several and in the first plane,
signed zeros, and ``vmax != 1``; ``route`` is the route ``mip_plan``
takes on a 16-byte aligned allocation.  Imports nothing of JAX.
"""

import numpy as np
import torch

from esp32_fluid_simulation_tpu_torch.render.cuda_smoke import SEGMENTS

F32, BF16 = torch.float32, torch.bfloat16
# name: (shape, dtype, storage offset in elements, what else, route)
MIP_CASES = {
    "d1-bf16": ((1, 128, 128), BF16, 0, None, "vector"),
    "d1-f32": ((1, 8, 10), F32, 0, None, "vector"),
    "d-below-segments-f32": ((3, 128, 128), F32, 0, None, "vector"),
    "d-not-a-multiple-bf16": ((13, 128, 136), BF16, 0, None, "vector"),
    "d-not-a-multiple-f32": ((21, 12, 20), F32, 0, None, "vector"),
    "hw-tail-bf16": ((7, 13, 129), BF16, 0, None, "scalar"),
    "hw-tail-f32": ((7, 13, 129), F32, 0, None, "scalar"),
    "hw-mod-4-bf16": ((9, 6, 10), BF16, 0, None, "scalar"),
    "hw-mod-4-f32": ((9, 6, 10), F32, 0, None, "vector"),
    "offset-bf16": ((10, 128, 128), BF16, 1, None, "scalar"),
    "offset-f32": ((10, 128, 128), F32, 1, None, "scalar"),
    "offset-16-bytes-bf16": ((10, 128, 128), BF16, 8, None, "vector"),
    "offset-16-bytes-f32": ((10, 128, 128), F32, 4, None, "vector"),
    "nan-one-segment-bf16": ((40, 128, 128), BF16, 0, "nan-one", "vector"),
    "nan-several-segments-f32": ((40, 128, 128), F32, 0, "nan-several",
                                 "vector"),
    "nan-first-plane-bf16": ((17, 128, 128), BF16, 0, "nan-first",
                             "vector"),
    "nan-scalar-f32": ((7, 13, 129), F32, 0, "nan-several", "scalar"),
    "signed-zero-f32": ((12, 64, 64), F32, 0, "zeros", "vector"),
    "signed-zero-bf16": ((12, 64, 64), BF16, 0, "zeros", "vector"),
    "vmax-bf16": ((24, 128, 128), BF16, 0, "vmax", "vector"),
    "vmax-scalar-f32": ((24, 13, 129), F32, 0, "vmax", "scalar"),
}


def mip_case(name, device="cpu"):
    """(volume, vmax) of case ``name``, made from a seed with numpy; the
    volume lies ``offset`` elements into its storage on ``device``."""
    shape, dtype, offset, what, _ = MIP_CASES[name]
    rng = np.random.default_rng(sum(shape) + offset)
    d, h, w = shape
    x = 1.2 * rng.random(shape, dtype=np.float32)
    seg_len = -(-d // SEGMENTS)
    if what == "nan-one":
        x[2 * seg_len + 1, 3, 5] = np.nan
    elif what == "nan-several":
        x[0, 1, 2] = x[seg_len, 1, 2] = x[d - 1, 1, 2] = np.nan
        x[seg_len + 1, 4, 7] = x[3 * seg_len, 6, 3] = np.nan
    elif what == "nan-first":
        x[0, 5, 9] = x[0, 0, 0] = np.nan
    elif what == "zeros":
        # +0 and -0 as the column maxima, negative values below them
        x = -x
        for zero in (0.0, -0.0):
            x[rng.integers(0, d, 40), rng.integers(0, h, 40),
              rng.integers(0, w, 40)] = zero
        x[:, 0, :] = -0.0
        x[d // 2, 0, ::2] = 0.0
    storage = torch.zeros(offset + x.size, dtype=dtype, device=device)
    vol = storage[offset:].view(shape)
    vol.copy_(torch.from_numpy(x).to(dtype))
    return vol, (0.7 if what == "vmax" else 1.0)
