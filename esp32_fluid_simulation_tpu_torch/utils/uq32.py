"""UQ32 fixed-point parity helpers (a copy of
``esp32_fluid_simulation_tpu/utils/uq32.py``: numpy only).

The reference stores dye as unsigned Q0.32 fixed point — the full uint32
range maps onto [0, 1) — so the top 5/6/5 bits of a channel are directly the
RGB565 component (``uq32.h:8-16``, ``.ino:170-172``).  float->UQ32 rounds via
``raw(x + 0.5f)`` (``uq32.h:13``); UQ32->float is a plain cast.

The framework stores dye as unit-scale float (quantization error 2^-33 is
below float32 epsilon, so UQ32 round-tripping is numerically invisible);
these helpers exist to *prove* that equivalence in tests and to emulate the
bit-exact RGB565 packing.
"""

from __future__ import annotations

import numpy as np

TWO32 = 4294967296.0  # 2**32


def float_to_uq32(x: np.ndarray) -> np.ndarray:
    """Unit-scale float -> UQ32 raw, reproducing ``raw(x + 0.5f)`` rounding
    (``uq32.h:13``) on the raw (2^32-scaled) value."""
    raw = np.asarray(x, np.float64) * TWO32 + 0.5
    return np.clip(np.floor(raw), 0, TWO32 - 1).astype(np.uint64).astype(np.uint32)


def uq32_to_float(raw: np.ndarray) -> np.ndarray:
    """UQ32 raw -> unit-scale float (exact cast then rescale, ``uq32.h:15``)."""
    return (np.asarray(raw, np.float64) / TWO32).astype(np.float32)


def uq32_top_bits(raw: np.ndarray, bits: int) -> np.ndarray:
    """Top ``bits`` of a UQ32 raw value — the RGB565 component extraction
    (``.ino:170-172``)."""
    return (np.asarray(raw, np.uint32) >> np.uint32(32 - bits)).astype(np.int32)
