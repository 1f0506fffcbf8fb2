"""The port's measurement helpers against the JAX package (CPU).

* ``utils/roofline.py``: ``step_traffic_bytes`` equals JAX's exactly (the
  same float arithmetic, stage by stage) for ``SimConfig()`` and every
  ``examples/config*.json``, fused and composed; ``speed_of_light`` is those
  bytes over the H100's 3.35 TB/s (rtol 1e-12: one division's rounding),
  with JAX's keys (``"gpu"`` where JAX has ``"tpu"``), and the counterpart
  of ``tests/test_cli.py::test_roofline_estimates`` holds;
* ``utils/profiling.py``: ``chain_time`` returns a positive time on CPU
  tensors and, on a chain whose every application sleeps 10 ms, a time of
  that order (at least 5 ms: the 1-application run differenced away, its
  scheduling jitter allowed for);
  ``trace`` writes a Chrome trace that holds the traced ops.
"""

import json
import time
from pathlib import Path

import pytest
import torch

from esp32_fluid_simulation_tpu import SimConfig as JSimConfig
from esp32_fluid_simulation_tpu.utils import roofline as jroofline
from esp32_fluid_simulation_tpu_torch import (Impulses, SimConfig,
                                              init_state, make_step)
from esp32_fluid_simulation_tpu_torch.utils import (GPU_SPECS, chain_time,
                                                    speed_of_light, trace)
from esp32_fluid_simulation_tpu_torch.utils.roofline import step_traffic_bytes

EXAMPLES = sorted((Path(__file__).resolve().parent.parent / "examples")
                  .glob("config*.json"))
CONFIGS = [None] + EXAMPLES          # None: SimConfig()
H100_BYTES_PER_S = 3.35e12


def _configs(path):
    if path is None:
        return SimConfig(), JSimConfig()
    text = path.read_text()
    return SimConfig.from_json(text), JSimConfig.from_json(text)


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("path", CONFIGS,
                         ids=lambda p: "default" if p is None else p.stem)
def test_step_traffic_bytes_equals_jax(path, fused):
    cfg, jcfg = _configs(path)
    assert step_traffic_bytes(cfg, fused) == jroofline.step_traffic_bytes(
        jcfg, fused)


@pytest.mark.parametrize("path", CONFIGS,
                         ids=lambda p: "default" if p is None else p.stem)
def test_speed_of_light_is_bytes_over_h100_bandwidth(path):
    cfg, jcfg = _configs(path)
    sol = speed_of_light(cfg, "h100")
    jsol = jroofline.speed_of_light(jcfg, "v5e")
    assert set(sol) == (set(jsol) - {"tpu"}) | {"gpu"}
    assert sol["gpu"] == "h100" and sol["fused"] is True
    assert sol["bytes_per_step"] == jsol["bytes_per_step"]
    assert sol["ideal_ms_per_step"] == pytest.approx(
        1e3 * sol["bytes_per_step"] / H100_BYTES_PER_S, rel=1e-12)
    assert sol["ideal_fps"] == pytest.approx(
        1e3 / sol["ideal_ms_per_step"], rel=1e-12)
    assert sol["per_stage_bytes"] == jsol["per_stage_bytes"]


def test_roofline_estimates():
    """``tests/test_cli.py::test_roofline_estimates`` on the H100; no TPU
    spec is left."""
    cfg = SimConfig(shape=(4096, 4096), scaling=1)
    fused = speed_of_light(cfg, "h100", fused=True)
    composed = speed_of_light(cfg, "h100", fused=False)
    assert fused["ideal_fps"] > composed["ideal_fps"] > 60
    assert fused["bytes_per_step"] < composed["bytes_per_step"]
    assert list(GPU_SPECS) == ["h100"]
    assert GPU_SPECS["h100"].hbm_gbps * 1e9 == H100_BYTES_PER_S
    for tpu in jroofline.TPU_SPECS:
        with pytest.raises(KeyError):
            speed_of_light(cfg, tpu)


def test_chain_time_cpu_step():
    cfg = SimConfig(shape=(17, 25), sor_iters=4)
    step = make_step(cfg)
    imp = Impulses.from_lists(cfg, [(8, 12)], [(40.0, -20.0)], device="cpu")
    t = chain_time(lambda s: step(s, imp), init_state(cfg, device="cpu"), 3)
    assert 0.0 < t < 10.0


def test_chain_time_differences_the_single_run():
    def slow(x):
        time.sleep(0.01)
        return {"t": x["t"] + 1, "tag": x["tag"]}

    t = chain_time(slow, {"tag": "a", "t": torch.zeros(2)}, 4)
    assert 0.005 <= t < 0.5
    with pytest.raises(ValueError, match="n >= 2"):
        chain_time(slow, {"tag": "a", "t": torch.zeros(2)}, 1)
    with pytest.raises(ValueError, match="no tensor"):
        chain_time(slow, (1.0,), 3)


def test_chain_time_settles_over_a_whole_chain():
    """A cost that the first chain of n pays on its later applications (as
    the caching allocator grows when two results are live at once) stays
    out of the reading: ``chain_time`` settles with a whole chain."""
    reached = set()

    def growing(x):
        depth = int(x[0])  # applications since x0
        time.sleep(0.05 if depth >= 1 and depth not in reached else 0.01)
        reached.add(depth)
        return x + 1

    t = chain_time(growing, torch.zeros(2), 4)
    assert 0.005 <= t < 0.03


def test_chain_time_repeats_until_two_readings_agree():
    """One disturbed run (a 0.2 s stall in the first timed chain) does not
    make the reading: ``chain_time`` repeats until two agree."""
    calls = {"n": 0}

    def stalled(x):
        calls["n"] += 1
        # calls 1-4 settle, 5 is the 1-chain, 6-9 the first 4-chain
        time.sleep(0.21 if calls["n"] == 7 else 0.01)
        return x + 1

    t = chain_time(stalled, torch.zeros(2), 4)
    assert 0.005 <= t < 0.03


def test_trace_writes_a_chrome_trace(tmp_path):
    x = torch.arange(64, dtype=torch.float32)
    with trace(str(tmp_path / "tr")) as prof:
        y = torch.cumsum(x * 2.0, dim=0)
    assert float(y[-1]) == 2.0 * sum(range(64))
    assert any("cumsum" in e.key for e in prof.key_averages())
    files = list((tmp_path / "tr").glob("trace_*.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any("cumsum" in str(e.get("name", "")) for e in events)
