"""Structured per-step metrics (counterpart of
``esp32_fluid_simulation_tpu/utils/metrics.py``).

``step_with_metrics`` computes the metrics on the device (divergence
extrema pre/post projection, Poisson residual norm, max speed,
finiteness) as 0-dim tensors; the logger fetches them and writes a JSON
line per logged step.
"""

from __future__ import annotations

import json
import time
from typing import Dict, Optional

import torch


class MetricsLogger:
    """Append-only JSONL metrics log.

    ``log`` accepts the metrics dict from ``make_step_with_metrics`` and
    fetches it with one device-to-host copy (the values stacked into one
    float64 vector, exact for float32 and bool), not one sync per key.
    """

    def __init__(self, path: Optional[str] = None, every: int = 1):
        self.path = path
        self.every = max(1, every)
        self._fh = open(path, "a") if path else None
        self.history = []

    def log(self, step: int, metrics: Dict, extra: Optional[Dict] = None):
        if step % self.every:
            return None
        values = [torch.as_tensor(v) for v in metrics.values()]
        dev = values[0].device if values else "cpu"
        fetched = torch.stack([v.to(dev, torch.float64).reshape(())
                               for v in values]).cpu().tolist()
        row = {"step": int(step), "time": time.time()}
        for k, v, x in zip(metrics, values, fetched):
            row[k] = bool(x) if v.dtype == torch.bool else float(x)
        if extra:
            row.update(extra)
        self.history.append(row)
        if self._fh:
            self._fh.write(json.dumps(row) + "\n")
            self._fh.flush()
        return row

    def close(self):
        if self._fh:
            self._fh.close()
            self._fh = None


def summarize(history) -> Dict:
    """Aggregate a metrics history: last values + extrema of the run."""
    if not history:
        return {}
    out = {"steps": len(history), "last": history[-1]}
    keys = [k for k in history[-1] if k not in ("step", "time")]
    for k in keys:
        vals = [row[k] for row in history if k in row
                and isinstance(row[k], float)]
        if vals:
            out[f"max_{k}"] = max(vals)
    return out
