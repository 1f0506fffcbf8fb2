"""The port's runner (``run.py``) and demo on the CPU: the port's side of
every case of ``tests/test_cli.py`` but the roofline (``utils/roofline.py``
is not ported), checkpoints that resume across the two packages, a
bfloat16 dye that resumes bit for bit, and the demo's three modes."""

import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch

from esp32_fluid_simulation_tpu.run import main as jrun_main
from esp32_fluid_simulation_tpu.utils.checkpoint import (
    load_checkpoint as jload_checkpoint)
from esp32_fluid_simulation_tpu_torch import (SimConfig, init_state,
                                              make_step, render_rgb8)
from esp32_fluid_simulation_tpu_torch import demo
from esp32_fluid_simulation_tpu_torch.io_host.touch import scripted_swirl
from esp32_fluid_simulation_tpu_torch.run import main as run_main
from esp32_fluid_simulation_tpu_torch.utils.checkpoint import (
    load_arr, load_checkpoint)

CPU = ["--device", "cpu"]


def _last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _read_ppm(path):
    magic, w, h, _, rest = Path(path).read_bytes().split(maxsplit=4)
    assert magic == b"P6"
    return np.frombuffer(rest, np.uint8).reshape(int(h), int(w), 3)


def test_cli_basic_run_and_frame(tmp_path, capsys):
    frame = str(tmp_path / "last.ppm")
    run_main(CPU + ["--grid", "17", "25", "--steps", "5", "--frame", frame])
    out = _last_json(capsys)
    assert out == {"steps_done": 5, "final_step": 5}
    cfg = SimConfig(shape=(17, 25))
    st = init_state(cfg, device="cpu")
    step = make_step(cfg)
    for t in range(5):
        st = step(st, scripted_swirl(cfg, t, device="cpu"))
    want = render_rgb8(st.color, s=cfg.scaling).permute(1, 2, 0).numpy()
    np.testing.assert_array_equal(_read_ppm(frame), want)


def test_cli_config_save_and_load(tmp_path, capsys):
    cfg_path = str(tmp_path / "sim_params.json")
    run_main(CPU + ["--grid", "17", "25", "--solver", "jacobi", "--steps",
                    "2", "--save-config", cfg_path])
    capsys.readouterr()
    run_main(CPU + ["--config", cfg_path, "--steps", "2"])
    assert _last_json(capsys)["final_step"] == 2
    saved = json.loads(Path(cfg_path).read_text())
    assert saved["solver"] == "jacobi" and saved["shape"] == [17, 25]


def test_cli_checkpoint_resume(tmp_path, capsys):
    ck = str(tmp_path / "ckpt.npz")
    run_main(CPU + ["--grid", "17", "25", "--steps", "6",
                    "--checkpoint", ck, "--checkpoint-every", "3"])
    capsys.readouterr()
    state, cfg = load_checkpoint(ck, device="cpu")
    assert state.step == 6 and cfg.shape == (17, 25)
    run_main(CPU + ["--resume", ck, "--steps", "4"])
    assert _last_json(capsys)["final_step"] == 10


def test_cli_bfloat16_dye_resumes_bit_for_bit(tmp_path, capsys):
    """A bf16 dye (config 0's ``color_dtype``) checkpoints and resumes to
    the uninterrupted run's state, bit for bit."""
    cfg = SimConfig(shape=(17, 25), color_dtype="bfloat16")
    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(cfg.to_json())
    ck, ck2 = str(tmp_path / "a.npz"), str(tmp_path / "b.npz")
    run_main(CPU + ["--config", str(cfg_path), "--steps", "4",
                    "--checkpoint", ck, "--checkpoint-every", "2"])
    run_main(CPU + ["--resume", ck, "--steps", "3", "--checkpoint", ck2,
                    "--checkpoint-every", "3"])
    capsys.readouterr()
    got, gcfg = load_checkpoint(ck2, device="cpu")
    want = init_state(cfg, device="cpu")
    step = make_step(cfg)
    for t in range(7):
        want = step(want, scripted_swirl(cfg, t, device="cpu"))
    assert gcfg == cfg and got.step == 7
    assert got.color.dtype == torch.bfloat16
    assert torch.equal(got.velocity, want.velocity)
    assert torch.equal(got.color, want.color)


@pytest.mark.parametrize("writer,color_dtype", [
    ("jax", "float32"), ("port", "float32"), ("jax", "bfloat16")])
def test_cli_resumes_across_packages(tmp_path, capsys, writer, color_dtype):
    """Each runner resumes the other's checkpoint; a bf16 dye only in the
    port, as the JAX loader raises on it."""
    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(SimConfig(shape=(17, 25),
                                  color_dtype=color_dtype).to_json())
    ck = str(tmp_path / "ckpt.npz")
    first, then = (jrun_main, run_main) if writer == "jax" else (
        run_main, jrun_main)
    first((CPU if writer == "port" else [])
          + ["--config", str(cfg_path), "--steps", "3", "--checkpoint", ck,
             "--checkpoint-every", "3"])
    capsys.readouterr()
    if color_dtype == "bfloat16":
        with pytest.raises(TypeError):
            jload_checkpoint(ck)
    then((CPU if writer == "jax" else []) + ["--resume", ck, "--steps", "2"])
    assert _last_json(capsys)["final_step"] == 5


def test_cli_metrics_and_dumps(tmp_path, capsys):
    mpath = str(tmp_path / "metrics.jsonl")
    dump = str(tmp_path / "fields")
    run_main(CPU + ["--grid", "17", "25", "--steps", "6", "--metrics",
                    mpath, "--metrics-every", "2", "--dump-fields", dump,
                    "--dump-every", "3"])
    out = _last_json(capsys)
    rows = [json.loads(line) for line in open(mpath)]
    assert len(rows) == 3 and [r["step"] for r in rows] == [2, 4, 6]
    assert {"div_pre_max", "div_post_max", "poisson_residual_l2",
            "max_speed", "finite"} <= set(rows[0])
    assert all(r["finite"] for r in rows)
    assert out["metrics"]["step"] == 6
    v = load_arr(os.path.join(dump, "sim_velocity_000006.arr"))
    assert v.shape == (2, 17, 25) and np.isfinite(v).all()
    c = load_arr(os.path.join(dump, "sim_color_000003.arr"))
    assert c.shape == (3, 17, 25)


def test_cli_watchdog(tmp_path, capsys):
    run_main(CPU + ["--grid", "17", "25", "--steps", "4", "--watchdog"])
    out = _last_json(capsys)
    assert out["watchdog_resets"] == 0 and out["final_step"] == 4


def test_cli_conflicting_flags_rejected(tmp_path):
    ck = str(tmp_path / "c.npz")
    run_main(CPU + ["--grid", "17", "25", "--steps", "2", "--checkpoint", ck,
                    "--checkpoint-every", "2"])
    with pytest.raises(SystemExit):
        run_main(CPU + ["--resume", ck, "--grid", "33", "41", "--steps",
                        "1"])
    with pytest.raises(SystemExit):
        run_main(CPU + ["--grid", "17", "25", "--steps", "1", "--watchdog",
                        "--metrics", str(tmp_path / "m.jsonl")])


@pytest.mark.parametrize("steps", [1, 3])
def test_cli_ensemble(tmp_path, capsys, steps):
    """BASELINE config 4 through the CLI: the ensemble step (1 step) and
    its rollout (more)."""
    frame = str(tmp_path / "member0.ppm")
    run_main(CPU + ["--grid", "17", "25", "--steps", str(steps),
                    "--ensemble", "4", "--frame", frame])
    out = _last_json(capsys)
    assert out == {"steps_done": steps, "ensemble": 4, "final_step": steps}
    assert _read_ppm(frame).shape == (16 * 4, 24 * 4, 3)


def test_cli_ensemble_rejects_incompatible_flags():
    with pytest.raises(SystemExit):
        run_main(CPU + ["--grid", "17", "25", "--steps", "1", "--ensemble",
                        "4", "--watchdog"])


def test_entry_points_default_to_cuda():
    import inspect
    from esp32_fluid_simulation_tpu_torch.io_host import pipeline, server
    from esp32_fluid_simulation_tpu_torch.run import build_parser
    assert build_parser().parse_args([]).device == "cuda"
    for fn in (pipeline.SimPipeline, server.SimServer, server.serve,
               load_checkpoint):
        assert inspect.signature(fn).parameters["device"].default == "cuda"


@pytest.mark.parametrize("mode,prefix,frames", [
    ([], "frame_", 2),
    (["--pipeline"], "pipe_", 6),
    (["--smoke3d", "--grid3d", "12", "16", "16"], "smoke_", 2),
    (["--smoke3d", "--smoke-view", "slice", "--grid3d", "12", "16", "16"],
     "smoke_", 2),
])
def test_demo_writes_frames(tmp_path, capsys, mode, prefix, frames):
    out = tmp_path / "out"
    got = demo.main(mode + ["--frames", "6", "--every", "3", "--out",
                            str(out), "--device", "cpu"])
    files = sorted(out.glob(prefix + "*.ppm"))
    assert got == frames == len(files)
    assert all(_read_ppm(f).ndim == 3 for f in files)
