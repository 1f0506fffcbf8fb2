"""Checkpoint / resume and raw field dumps (counterpart of
``esp32_fluid_simulation_tpu/utils/checkpoint.py:50-89``).

A checkpoint is the JAX package's npz layout: ``velocity``, ``color``,
``step`` (int32) and ``config`` (the config JSON as bytes), so one file
loads in either package.  A bfloat16 field goes in as its raw 16-bit words
with numpy dtype ``V2``, the bytes JAX writes for it.  The loader reads
such a field from a file of either package as bfloat16, as the config's
dtype says; JAX's own loader cannot (``TypeError: Dtype |V2 is not a valid
JAX array type``).  The orbax checkpoints of the JAX module (``:28-47``)
are not ported.

``dump_arr`` / ``load_arr`` write and read the reference harness's
``sim_*.arr`` raw dumps with a JSON sidecar (``.gitignore:4-8``).
"""

from __future__ import annotations

import json
import os
from typing import Tuple

import numpy as np
import torch

from ..config import SimConfig
from ..state import SimState

_BF16_WORDS = np.dtype("V2")   # how numpy holds a bfloat16 array it cannot name


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """Host copy of ``t``; bfloat16 as its raw words (dtype ``V2``)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(_BF16_WORDS)
    return t.numpy()


def _from_numpy(a: np.ndarray, dtype: str, device) -> torch.Tensor:
    """``a`` as a tensor on ``device``; raw 2-byte words (``V2``) are read
    as bfloat16, which ``dtype`` (the config's name for the field's dtype)
    must then be."""
    if a.dtype.kind == "V":
        if a.dtype.itemsize != 2 or dtype != "bfloat16":
            raise ValueError(f"raw {a.dtype} field for a {dtype!r} config")
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.int16))
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def save_checkpoint(path: str, state: SimState, cfg: SimConfig) -> None:
    """Atomic npz checkpoint of {velocity, color, step} + config JSON."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp.npz"
    with open(tmp, "wb") as f:
        np.savez(
            f,
            velocity=_to_numpy(state.velocity),
            color=_to_numpy(state.color),
            step=np.asarray(int(state.step), np.int32),
            config=np.frombuffer(cfg.to_json().encode(), dtype=np.uint8),
        )
    os.replace(tmp, path)


def load_checkpoint(path: str, device="cuda") -> Tuple[SimState, SimConfig]:
    """The state (on ``device``) and config of a checkpoint written by
    either package."""
    with np.load(path) as z:
        cfg = SimConfig.from_json(bytes(z["config"]).decode())
        state = SimState(
            velocity=_from_numpy(z["velocity"], cfg.dtype, device),
            color=_from_numpy(z["color"], cfg.color_dtype, device),
            step=int(z["step"]),
        )
    return state, cfg


def dump_arr(path: str, arr: torch.Tensor) -> None:
    """Raw little-endian dump with a JSON sidecar (shape/dtype) — the
    ``sim_*.arr`` + ``sim_params.json`` workflow (``.gitignore:4-8``).
    A bfloat16 tensor dumps its raw words with dtype ``"bfloat16"`` in the
    sidecar, as JAX's does."""
    a = _to_numpy(arr)
    name = "bfloat16" if arr.dtype == torch.bfloat16 else str(a.dtype)
    if a.dtype == _BF16_WORDS:
        a = a.view(np.uint16)
    a.astype(a.dtype.newbyteorder("<")).tofile(path)
    with open(path + ".json", "w") as f:
        json.dump({"shape": list(a.shape), "dtype": name}, f)


def load_arr(path: str) -> np.ndarray:
    """A dump as numpy; a ``"bfloat16"`` dump comes back as float32 (exact:
    numpy has no bfloat16)."""
    with open(path + ".json") as f:
        meta = json.load(f)
    if meta["dtype"] == "bfloat16":
        words = np.fromfile(path, dtype="<u2").astype(np.uint32) << 16
        return words.view(np.float32).reshape(meta["shape"])
    a = np.fromfile(path, dtype=np.dtype(meta["dtype"]).newbyteorder("<"))
    return a.reshape(meta["shape"])
