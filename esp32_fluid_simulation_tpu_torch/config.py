"""Simulation configuration (counterpart of ``esp32_fluid_simulation_tpu/config.py``).

The same frozen dataclass with the same fields, defaults, checks and JSON
form, so one ``examples/*.json`` file loads in both packages.  The solver
and advection names ``"fused_pallas"`` and ``"pallas"`` are kept so the JSON
stays shared; in this package they select the hand-written CUDA kernels
(``ops/cuda``), which run their plain PyTorch versions on CPU tensors.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Tuple

import torch

# Reference constants (ESP32-fluid-simulation.ino:15-16, 24-26, 36-38).
REF_SCALING = 4
REF_SCREEN_HEIGHT = 240
REF_SCREEN_WIDTH = 320
REF_N_ROWS = REF_SCREEN_HEIGHT // REF_SCALING + 1  # 61 (incl. lerp endpoint)
REF_N_COLS = REF_SCREEN_WIDTH // REF_SCALING + 1   # 81
REF_DT = 1.0 / 30.0
REF_SOR_ITERS = 10
REF_SOR_OMEGA = 1.96

_DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float64": torch.float64,
}


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """Static simulation parameters.

    ``shape`` is the node-grid shape ``(H, W)`` for 2D or ``(D, H, W)`` for 3D.
    Axis 0 is the reference's ``i`` axis and axis 1 its ``j`` axis; velocity
    channel 0 moves along axis 0, channel 1 along axis 1.
    """

    shape: Tuple[int, ...] = (REF_N_ROWS, REF_N_COLS)
    dt: float = REF_DT
    dx: float = 1.0
    sor_iters: int = REF_SOR_ITERS
    omega: float = REF_SOR_OMEGA
    solver: str = "sor"          # sor | sor_adaptive | jacobi | sor_pallas
    #                            # | multigrid | fused_pallas
    sor_tol: float = 1e-3
    sor_check_every: int = 2
    advector: str = "semilag"    # semilag | rk2 | maccormack
    advect_impl: str = "auto"    # auto | jnp | pallas (pallas: the CUDA kernel)
    advect_max_disp: int = 12    # CFL clamp (cells/step) for the kernel path
    advect_sample_dtype: str = "float32"
    vorticity_eps: float = 0.0   # >0 enables vorticity confinement
    dtype: str = "float32"       # compute dtype for fields
    color_dtype: str = "float32"  # dye storage dtype
    scaling: int = REF_SCALING   # render upscale factor
    max_impulses: int = 16       # static impulse-buffer length per step
    mg_levels: int = 0
    mg_cycles: int = 2
    domain_tile: Tuple[int, int] | None = None

    def __post_init__(self):
        if len(self.shape) not in (2, 3):
            raise ValueError(f"shape must be 2D or 3D, got {self.shape}")
        if self.solver not in ("sor", "sor_adaptive", "jacobi", "sor_pallas",
                               "multigrid", "fused_pallas"):
            raise ValueError(f"unknown solver {self.solver!r}")
        if self.advector not in ("semilag", "rk2", "maccormack"):
            raise ValueError(f"unknown advector {self.advector!r}")
        if self.dtype not in _DTYPES or self.color_dtype not in _DTYPES:
            raise ValueError(f"unknown dtype {self.dtype!r}/{self.color_dtype!r}")
        if self.solver == "sor_adaptive" and (
                self.sor_check_every < 1 or self.sor_tol <= 0.0):
            raise ValueError(
                "sor_adaptive needs sor_check_every >= 1 and sor_tol > 0 "
                f"(got {self.sor_check_every}, {self.sor_tol})")
        if self.advect_impl not in ("auto", "jnp", "pallas"):
            raise ValueError(f"unknown advect_impl {self.advect_impl!r}")
        if self.advect_sample_dtype not in ("float32", "bfloat16"):
            raise ValueError(
                f"unknown advect_sample_dtype {self.advect_sample_dtype!r}")
        if self.domain_tile is not None:
            object.__setattr__(self, "domain_tile",
                               tuple(self.domain_tile))
            if self.ndim != 2:
                raise ValueError("domain_tile requires a 2D grid")
            mh, mw = self.domain_tile
            if self.shape[0] % mh or self.shape[1] % mw:
                raise ValueError(
                    f"domain_tile {self.domain_tile} must divide the grid "
                    f"{self.shape}")
            if self.advector != "semilag" or self.solver not in (
                    "sor", "fused_pallas", "jacobi"):
                raise ValueError(
                    "domain_tile supports advector='semilag' with "
                    "solver='sor'/'jacobi'/'fused_pallas'")
            if self.vorticity_eps > 0.0:
                raise ValueError("domain_tile does not support vorticity "
                                 "confinement yet")

    # -- derived -----------------------------------------------------------
    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def torch_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]

    @property
    def torch_color_dtype(self) -> torch.dtype:
        return _DTYPES[self.color_dtype]

    @property
    def render_shape(self) -> Tuple[int, int]:
        """Pixel shape after upscale: ``(H-1)*s x (W-1)*s`` (the last node
        row/col are lerp endpoints only)."""
        h, w = self.shape[-2], self.shape[-1]
        s = self.scaling
        return ((h - 1) * s, (w - 1) * s)

    @property
    def clamps_dye(self) -> bool:
        """True when ``step`` clamps the dye to [0, 1] every step."""
        return self.advector in ("semilag", "rk2")

    # -- (de)serialization --------------------------------------------------
    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self))

    @classmethod
    def from_json(cls, s: str) -> "SimConfig":
        d = json.loads(s)
        d["shape"] = tuple(d["shape"])
        return cls(**d)


def reference_config(**overrides) -> SimConfig:
    """The exact reference workload (BASELINE config 1)."""
    return SimConfig(**overrides)
