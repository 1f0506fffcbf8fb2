"""The port's native host runtime, three-thread pipeline and web shell on
the CPU: the port's side of every case of ``tests/test_native.py``, the
pipeline's frames against JAX's ``SimPipeline``, the race of the JAX
pipeline (a last frame lost when the sim stops first) held shut over 50
runs, and an HTTP round trip on a free port."""

import io
import json
import random
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import esp32_fluid_simulation_tpu as J
from esp32_fluid_simulation_tpu.io_host.pipeline import (
    SimPipeline as JSimPipeline)
from esp32_fluid_simulation_tpu.render import pack_rgb565 as jpack_rgb565
from esp32_fluid_simulation_tpu_torch import SimConfig
from esp32_fluid_simulation_tpu_torch.io_host import native
from esp32_fluid_simulation_tpu_torch.io_host.native import (
    DragQueue, FrameHandshake, FramePacer, rgb565_to_rgb888, load_library)
from esp32_fluid_simulation_tpu_torch.io_host.pipeline import SimPipeline
from esp32_fluid_simulation_tpu_torch.io_host.server import serve
from esp32_fluid_simulation_tpu_torch.render import render_rgb8
from esp32_fluid_simulation_tpu_torch.render.upscale import (decimate_mean,
                                                             render_rgbx)

ROOT = Path(__file__).resolve().parents[1]


def test_library_builds_into_the_build_directory():
    lib = load_library()
    assert Path(lib._name) == native.LIB_PATH
    assert native.LIB_PATH.parent == ROOT / "build" / "native"
    assert native.LIB_PATH.exists()


def test_drag_queue_fifo_and_lossy():
    q = DragQueue(capacity=4)
    for k in range(6):  # 2 more than capacity -> dropped (xQueueSend(,0))
        q.try_push(k, k + 1, float(k), -float(k))
    assert q.dropped == 2
    out = q.drain()
    assert [d[0] for d in out] == [0, 1, 2, 3]
    assert out[1] == (1, 2, 1.0, -1.0)
    assert q.drain() == []
    assert q.try_push(9, 9, 1.0, 1.0)
    assert q.drain()[0][0] == 9


def test_drag_queue_threaded():
    q = DragQueue(capacity=64)
    got = []

    def producer():
        for k in range(500):
            while not q.try_push(k, 0, 0.0, 0.0):
                time.sleep(0)

    def consumer():
        deadline = time.time() + 30
        while len(got) < 500 and time.time() < deadline:
            got.extend(d[0] for d in q.drain())

    t1 = threading.Thread(target=producer)
    t2 = threading.Thread(target=consumer)
    t2.start()
    t1.start()
    t1.join(timeout=30)
    t2.join(timeout=30)
    assert not t1.is_alive() and not t2.is_alive()
    assert got == list(range(500))


def test_handshake_rendezvous():
    h = FrameHandshake()
    assert h.producer_acquire(timeout_ms=100)   # primed (.ino:243)
    assert not h.consumer_acquire(timeout_ms=50)
    h.producer_publish()
    assert h.consumer_acquire(timeout_ms=100)
    assert not h.producer_acquire(timeout_ms=50)
    h.consumer_release()
    assert h.producer_acquire(timeout_ms=100)


def test_pacer_rate():
    p = FramePacer(fps=200.0)
    t0 = time.time()
    for _ in range(20):
        p.wait()
    dt = time.time() - t0
    assert 0.07 < dt < 0.5  # ~100 ms nominal, generous upper bound


def test_rgb565_roundtrip():
    from esp32_fluid_simulation_tpu_torch.render import pack_rgb565
    rgb = np.random.default_rng(0).random((3, 16, 24)).astype(np.float32)
    frame = pack_rgb565(torch.from_numpy(rgb), bswap=True)
    np.testing.assert_array_equal(
        frame.numpy(), np.asarray(jpack_rgb565(jnp.asarray(rgb), bswap=True)))
    out = rgb565_to_rgb888(frame.numpy(), swapped=True)
    assert out.shape == (16, 24, 3)
    np.testing.assert_allclose(out[..., 0] / 255.0, rgb[0], atol=0.05)
    np.testing.assert_allclose(out[..., 1] / 255.0, rgb[1], atol=0.03)
    np.testing.assert_allclose(out[..., 2] / 255.0, rgb[2], atol=0.05)


def test_full_pipeline():
    frames = []
    cfg = SimConfig(shape=(17, 25), sor_iters=4)
    pipe = SimPipeline(cfg, lambda rgb, n: frames.append(rgb), fps=500.0,
                       device="cpu")
    pipe.push_drag(8, 12, 150.0, -100.0)
    delivered = pipe.run(n_frames=6)
    assert delivered == 6 == len(frames)
    assert frames[0].shape == (16 * 4, 24 * 4, 3)
    assert not np.array_equal(frames[0], frames[-1])


def test_pipeline_never_loses_the_last_frame():
    """The JAX consumer breaks on the stop flag right after a frame, so a
    frame published just before the sim thread stops is lost
    (``pipeline.py:105-106``); the port's consumer empties the slot first.
    A sink that sleeps 1-5 ms makes the sim finish while the consumer is
    busy, in 50 runs of 6 frames."""
    cfg = SimConfig(shape=(17, 25), sor_iters=2)
    rnd = random.Random(3)

    def sink(rgb, n):
        time.sleep(rnd.uniform(0.001, 0.005))

    delivered = [SimPipeline(cfg, sink, fps=1000.0, device="cpu").run(6)
                 for _ in range(50)]
    assert delivered == [6] * 50


def test_pipeline_frames_match_jax():
    """The same drag, drained at frame 0 in both, gives the same frames.
    Tolerance: equal, or one RGB565 step on fewer than 0.1% of the pixels
    (the jitted JAX step and the eager port round differently in f32)."""
    cfg = SimConfig(shape=(17, 25), sor_iters=4)
    jcfg = J.SimConfig(shape=(17, 25), sor_iters=4)
    ours, theirs = {}, {}
    pipe = SimPipeline(cfg, lambda rgb, n: ours.setdefault(n, rgb),
                       fps=500.0, device="cpu")
    jpipe = JSimPipeline(jcfg, lambda rgb, n: theirs.setdefault(n, rgb),
                         fps=500.0)
    for p in (pipe, jpipe):
        p.push_drag(8, 12, 150.0, -100.0)
    assert pipe.run(n_frames=6) == 6
    jpipe.run(n_frames=6)
    # the JAX pipeline may lose its last frame (its race): compare the
    # frames it delivered
    assert len(theirs) >= 5
    for n, want in theirs.items():
        got = ours[n]
        words = [(x[..., 0] >> 3, x[..., 1] >> 2, x[..., 2] >> 3)
                 for x in (got.astype(np.int32), want.astype(np.int32))]
        step = max(int(np.abs(a - b).max()) for a, b in zip(*words))
        off = np.mean(np.any(got != want, axis=-1))
        assert step <= 1 and off < 1e-3, (n, step, off)


def test_pipeline_sink_exception_does_not_hang():
    def bad_sink(rgb, n):
        raise RuntimeError("disk full")

    cfg = SimConfig(shape=(17, 25), sor_iters=2)
    pipe = SimPipeline(cfg, bad_sink, fps=500.0, device="cpu")
    t0 = time.time()
    with pytest.raises(RuntimeError, match="disk full"):
        pipe.run(n_frames=10)
    assert time.time() - t0 < 60  # must terminate, not deadlock


def test_http_server_roundtrip():
    """The web shell on a free port: drags in over HTTP, frames out."""
    cfg = SimConfig(shape=(17, 25), sor_iters=4)
    sim, httpd = serve(cfg, port=0, fps=120.0, device="cpu")
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()

    def get(path):
        return urllib.request.urlopen(base + path, timeout=10).read()

    try:
        deadline = time.time() + 60
        while time.time() < deadline:
            stats = json.loads(get("/stats"))
            if stats["steps"] > 3:
                break
            time.sleep(0.1)
        assert stats["steps"] > 3 and stats["shape"] == [17, 25]
        req = urllib.request.Request(
            base + "/drag", method="POST",
            data=json.dumps({"from": [0.4, 0.5], "to": [0.6, 0.5]}).encode())
        assert urllib.request.urlopen(req, timeout=10).status == 204
        f1 = get("/frame")
        time.sleep(0.3)
        f2 = get("/frame")
        assert len(f1) > 100 and f1 != f2  # frames advance
        assert sim.mime == "image/jpeg" and f1[:2] == b"\xff\xd8"
        page = get("/")
        assert b"/stream" in page and b"pointerdown" in page
        with pytest.raises(urllib.error.HTTPError):
            get("/nothing")
    finally:
        sim.stop()
        httpd.shutdown()
        httpd.server_close()
        for th in sim.threads + (t,):
            th.join(timeout=30)
    assert not any(th.is_alive() for th in sim.threads)


def test_stream_decimation_frame_size():
    """``stream_decim`` renders a d:1 mean-pooled view at scale 1."""
    cfg = SimConfig(shape=(61, 81), sor_iters=2)
    sim, httpd = serve(cfg, port=0, fps=500.0, stream_decim=4, device="cpu")
    try:
        sim.attach(1)
        jpeg, _ = sim.next_frame(0, timeout=30)
    finally:
        sim.stop()
        httpd.server_close()
        for th in sim.threads:
            th.join(timeout=30)
    from PIL import Image
    assert Image.open(io.BytesIO(jpeg)).size == (81 // 4 - 1, 61 // 4 - 1)


def test_jpeg_encode_rgb8():
    from esp32_fluid_simulation_tpu_torch.io_host.native import (
        jpeg_available, jpeg_encode_rgb8)
    if not jpeg_available():
        pytest.skip("libfluidhost built without libjpeg")
    rng = np.random.default_rng(1)
    base = rng.random((6, 8, 3))
    rgb = (np.kron(base, np.ones((20, 20, 1))) * 255).astype(np.uint8)
    data = jpeg_encode_rgb8(rgb, quality=85)
    assert data[:2] == b"\xff\xd8" and data[-2:] == b"\xff\xd9"
    from PIL import Image
    back = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    assert back.shape == rgb.shape
    assert np.abs(back.astype(int) - rgb.astype(int)).mean() < 8


def test_jpeg_encode_rgbx_matches_rgb8():
    from esp32_fluid_simulation_tpu_torch.io_host.native import (
        jpeg_available, jpeg_rgbx_available, jpeg_encode_rgb8,
        jpeg_encode_rgbx)
    if not (jpeg_available() and jpeg_rgbx_available()):
        pytest.skip("libfluidhost built without libjpeg JCS_EXT_RGBX")
    rng = np.random.default_rng(2)
    color = torch.from_numpy(rng.random((3, 13, 17)).astype(np.float32))
    rgb = render_rgb8(color, s=4).permute(1, 2, 0).contiguous().numpy()
    rgbx = render_rgbx(color, s=4).numpy()
    assert jpeg_encode_rgbx(rgbx, 90) == jpeg_encode_rgb8(rgb, 90)


def test_render_rgbx_matches_rgb8():
    rng = np.random.default_rng(3)
    color = torch.from_numpy(rng.random((3, 13, 17)).astype(np.float32))
    rgb8 = render_rgb8(color, s=4).numpy()
    rgbx = render_rgbx(color, s=4).numpy()
    np.testing.assert_array_equal(rgbx & 0xFF, rgb8[0])
    np.testing.assert_array_equal((rgbx >> 8) & 0xFF, rgb8[1])
    np.testing.assert_array_equal((rgbx >> 16) & 0xFF, rgb8[2])


def test_decimate_mean():
    rng = np.random.default_rng(4)
    x = rng.random((3, 12, 20)).astype(np.float32)
    got = decimate_mean(torch.from_numpy(x), 4).numpy()
    want = x.reshape(3, 3, 4, 5, 4).mean(axis=(2, 4))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(decimate_mean(torch.from_numpy(x), 1)
                                  .numpy(), x)


def test_decimate_mean_non_divisible():
    rng = np.random.default_rng(5)
    x = rng.random((3, 61, 81)).astype(np.float32)
    got = decimate_mean(torch.from_numpy(x), 2).numpy()
    assert got.shape == (3, 30, 40)
    want = x[:, :60, :80].reshape(3, 30, 2, 40, 2).mean(axis=(2, 4))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
