"""Interactive web shell: the CYD touchscreen + LCD reborn as a browser tab
(counterpart of ``esp32_fluid_simulation_tpu/io_host/server.py``).

The reference's user surface is a 320x240 touch LCD: drag a finger, dye
swirls (``touch_routine``/``draw_routine``).  Here a tiny dependency-free
HTTP server streams the rendered frames as MJPEG (multipart) and accepts
pointer drags back, feeding them through the same native lossy drag queue ->
impulse path as the scripted schedules.

Run:  python -m esp32_fluid_simulation_tpu_torch.io_host.server --port 8000
then open http://localhost:8000/ and drag on the canvas (``--device cpu``
runs it without a GPU).
"""

from __future__ import annotations

import argparse
import io
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import torch

from ..config import SimConfig
from ..state import Impulses
from ..models.stable_fluids import init_state
from ..models import make_step
from ..render.upscale import render_rgb565, decimate_mean
from .native import (DragQueue, FramePacer, jpeg_available, jpeg_encode_rgb8,
                     rgb565_to_rgb888)
from .pipeline import FrameFetcher, device_context

_PAGE = """<!doctype html>
<title>tpu-fluid</title>
<style>body{background:#111;color:#eee;font-family:monospace;text-align:center}
img{image-rendering:pixelated;border:1px solid #444;touch-action:none}</style>
<h3>tpu-fluid &mdash; drag to stir</h3>
<img id="v" src="/stream" width="%WIDTH%" height="%HEIGHT%">
<p id="s"></p>
<script>
const img = document.getElementById('v');
let last = null, lastT = 0, down = false;
function cell(e) {
  const r = img.getBoundingClientRect();
  return [ (e.clientX - r.left) / r.width, (e.clientY - r.top) / r.height ];
}
function send(p, q, ms) {
  fetch('/drag', {method: 'POST',
                  body: JSON.stringify({from: p, to: q, ms: ms})});
}
img.addEventListener('pointerdown', e => {
  down = true; last = cell(e); lastT = e.timeStamp;
});
img.addEventListener('pointermove', e => {
  if (!down) return;
  const c = cell(e);
  send(last, c, e.timeStamp - lastT); last = c; lastT = e.timeStamp;
});
addEventListener('pointerup', () => { down = false; last = null; });
</script>
"""

# steps between two completed-step readings of sim_fps: each reading waits
# for the device, so it is amortized over K steps
RATE_EVERY = 32


class SimServer:
    """Sim producer + encoder consumer, pipelined like the reference.

    The reference's sim loop never waits on rendering: ``loop()`` hands the
    color buffer to ``draw_routine`` through a semaphore pair and
    immediately starts the next step (``.ino:285-288``).  Here the sim
    thread only enqueues device work and drops the not yet copied device
    frame into a 1-slot latest-wins handoff; a dedicated encoder thread
    pays the device->host copy (``FrameFetcher``: on its own stream, after
    the frame's event) AND the JPEG encode.  Latest-wins (instead of the
    reference's blocking 1-slot handshake) is the same lossy-queue policy
    as the drag queue: the stream shows the newest frame, the sim never
    stalls.

    ``stream_decim``: N > 1 renders the stream from an on-device
    N:1-decimated dye field, so a 4096^2 sim can stream a 1024^2 window
    without copying 32 MB a frame to the host (``.ino``'s 4x upscale in
    reverse — the LCD is smaller than the sim, so was the reference's).
    """

    def __init__(self, cfg: SimConfig, fps: float = 30.0,
                 stream_decim: int = 1, encode_duty: float = 0.5,
                 device="cuda"):
        self.cfg = cfg
        self.fps = fps
        self.device = torch.device(device)
        self.stream_decim = max(1, int(stream_decim))
        # Encoder duty-cycle cap: the frame copy and the JPEG encode share
        # the host's cores with the sim thread's launches (1-core serving
        # hosts), so the consumer sleeps t_work*(1/duty - 1) between
        # frames; the stream degrades (latest-wins drops) instead of the
        # sim (.ino:285-288).
        self.encode_duty = min(max(encode_duty, 0.05), 1.0)
        self.queue = DragQueue(16)
        step = make_step(cfg, donate=False)
        d = self.stream_decim

        def _step_render(st, imp):
            # the frame crosses to the host as RGB565 — the reference's
            # own display format (.ino:164-176), 2 bytes a pixel; the
            # native consumer expands 565->888 off the GIL before the JPEG
            st = step(st, imp)
            color = decimate_mean(st.color, d)
            return st, render_rgb565(color, s=cfg.scaling if d == 1 else 1,
                                     bswap=False,
                                     unit_range=cfg.clamps_dye)

        self._step_render = _step_render
        self._frame_jpeg = b""
        self._frame_lock = threading.Condition()
        self._frame_no = 0
        # 1-slot latest-wins handoff sim -> encoder: (device frame, its
        # event), not yet copied: the encoder pays the copy
        self._raw_slot = None
        self._raw_no = 0
        self._raw_lock = threading.Condition()
        self._clients_lock = threading.Lock()
        self._stop = threading.Event()
        self.steps_done = 0
        self.frames_encoded = 0
        self.frames_dropped = 0
        self.sim_fps = 0.0
        self.encode_fps = 0.0
        self.clients = 0          # attached /stream + in-flight /frame
        self.mime = "image/jpeg"

    def attach(self, k: int):
        """Count ``k`` (+1 or -1) /stream or /frame clients."""
        with self._clients_lock:
            self.clients += k

    # -- input ------------------------------------------------------------
    def drag(self, frm, to, ms=None):
        """Fractional screen coords -> sim-frame drag (the x/y swap of
        .ino:258-267 happens here: screen row fraction -> axis 0).

        Velocity = delta cells * 1000/ms, ms being the client-measured time
        between pointer events — the reference's drag formula with a
        measured poll period (.ino:80-86)."""
        h, w = self.cfg.shape[-2], self.cfg.shape[-1]
        i0, j0 = frm[1] * (h - 1), frm[0] * (w - 1)
        i1, j1 = to[1] * (h - 1), to[0] * (w - 1)
        period_ms = min(max(float(ms) if ms else 1000.0 / self.fps, 1.0),
                        1000.0)
        scale = 1000.0 / period_ms
        self.queue.try_push(int(round(i1)), int(round(j1)),
                            (i1 - i0) * scale, (j1 - j0) * scale)

    # -- sim loop ---------------------------------------------------------
    def _encode(self, frame565):
        # ``frame565``: [H, W] uint16 RGB565 (unswapped).  Two GIL-free
        # native calls — 565->888 expand + libjpeg-turbo encode; PIL, then
        # raw PPM, where the library was built without libjpeg.
        rgb = rgb565_to_rgb888(frame565, swapped=False)
        if jpeg_available():
            self.mime = "image/jpeg"
            return jpeg_encode_rgb8(rgb, quality=85)
        try:
            from PIL import Image
            buf = io.BytesIO()
            Image.fromarray(rgb).save(buf, format="JPEG", quality=85)
            self.mime = "image/jpeg"
            return buf.getvalue()
        except ImportError:  # raw PPM fallback (correctly labeled)
            self.mime = "image/x-portable-pixmap"
            h, w, _ = rgb.shape
            return b"P6\n%d %d\n255\n" % (w, h) + rgb.tobytes()

    def run_sim(self, n_frames=None):
        try:
            with device_context(self.device):
                self._run_sim(n_frames)
        finally:
            # a step/encode exception must stop the server visibly instead
            # of freezing /stream on a stale frame
            self._stop.set()
            with self._raw_lock:
                self._raw_lock.notify_all()
            with self._frame_lock:
                self._frame_lock.notify_all()

    def run_encoder(self):
        """Encoder thread: device->host copy + JPEG, off the sim thread
        (the draw_routine role, ``.ino:99-191``)."""
        seen = 0
        t_last = None
        fetcher = FrameFetcher()
        try:
            while not self._stop.is_set():
                with self._raw_lock:
                    while self._raw_no <= seen and not self._stop.is_set():
                        self._raw_lock.wait(1.0)
                    if self._stop.is_set():
                        break
                    slot = self._raw_slot
                    self.frames_dropped += self._raw_no - seen - 1
                    seen = self._raw_no
                if self.clients == 0 and self._frame_no > 0:
                    # headless: nobody is watching — skip the copy AND the
                    # encode; one initial frame is always kept for a late
                    # /frame
                    continue
                t_w0 = time.time()
                jpeg = self._encode(fetcher.fetch(*slot))
                t_work = time.time() - t_w0
                now = time.time()
                if t_last is not None:
                    inst = 1.0 / max(now - t_last, 1e-6)
                    self.encode_fps = (0.8 * self.encode_fps + 0.2 * inst
                                       if self.encode_fps else inst)
                t_last = now
                with self._frame_lock:
                    self._frame_jpeg = jpeg
                    self._frame_no += 1
                    self.frames_encoded += 1
                    self._frame_lock.notify_all()
                if self.encode_duty < 1.0 and not self._stop.is_set():
                    # capped: a first frame that waited out the kernels'
                    # build must not idle the encoder for as long again
                    time.sleep(min(t_work * (1.0 / self.encode_duty - 1.0),
                                   2.0))
        finally:
            self._stop.set()
            with self._frame_lock:
                self._frame_lock.notify_all()

    def _run_sim(self, n_frames=None):
        state = init_state(self.cfg, device=self.device)
        pacer = FramePacer(self.fps)
        none = Impulses.none(self.cfg, device=self.device)   # reused
        t_last = None
        while not self._stop.is_set():
            drags = self.queue.drain(self.cfg.max_impulses)
            # queue entries are already sim-frame (i, j, vi, vj)
            imp = (Impulses.from_lists(
                       self.cfg, [(i, j) for i, j, _, _ in drags],
                       [(vi, vj) for _, _, vi, vj in drags],
                       device=self.device)
                   if drags else none)
            state, img = self._step_render(state, imp)
            ready = FrameFetcher.mark(img)
            # sim_fps is rated by COMPLETED device steps: every K frames
            # the thread waits for the last frame's event
            if self.steps_done % RATE_EVERY == RATE_EVERY - 1:
                if ready is not None:
                    ready.synchronize()
                now = time.time()
                if t_last is not None:
                    inst = RATE_EVERY / max(now - t_last, 1e-6)
                    self.sim_fps = (0.7 * self.sim_fps + 0.3 * inst
                                    if self.sim_fps else inst)
                t_last = now
            with self._raw_lock:
                self._raw_slot = (img, ready)   # latest wins
                self._raw_no += 1
                self._raw_lock.notify_all()
            self.steps_done += 1
            if n_frames and self.steps_done >= n_frames:
                break
            pacer.wait()

    def next_frame(self, after, timeout=60.0):
        """Block until a frame newer than ``after`` exists (the first frame
        waits out the kernels' build); returns (bytes, frame_no)."""
        deadline = time.time() + timeout
        with self._frame_lock:
            while (self._frame_no <= after or not self._frame_jpeg) \
                    and not self._stop.is_set():
                remaining = deadline - time.time()
                if remaining <= 0 or not self._frame_lock.wait(remaining):
                    break
            return self._frame_jpeg, self._frame_no

    def stop(self):
        self._stop.set()


def make_handler(sim: SimServer):
    if sim.stream_decim > 1:
        d = sim.stream_decim
        h, w = sim.cfg.shape[-2], sim.cfg.shape[-1]
        ho, wo = h // d - 1, w // d - 1   # mean-pool floors, render crops 1
    else:
        ho, wo = sim.cfg.render_shape

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def do_GET(self):
            if self.path == "/":
                page = (_PAGE.replace("%WIDTH%", str(wo))
                        .replace("%HEIGHT%", str(ho))).encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/html")
                self.send_header("Content-Length", str(len(page)))
                self.end_headers()
                self.wfile.write(page)
            elif self.path == "/frame":
                sim.attach(1)
                try:
                    # ask for a frame NEWER than the current one: with
                    # client-gated encoding the newest published frame may
                    # be the stale initial one; attaching as a client wakes
                    # the encoder for the next raw frame
                    frame, _ = sim.next_frame(sim._frame_no, timeout=10.0)
                finally:
                    sim.attach(-1)
                self.send_response(200)
                self.send_header("Content-Type", sim.mime)
                self.send_header("Content-Length", str(len(frame)))
                self.end_headers()
                self.wfile.write(frame)
            elif self.path == "/stream":
                self.send_response(200)
                self.send_header(
                    "Content-Type",
                    "multipart/x-mixed-replace; boundary=frame")
                self.end_headers()
                seen = -1
                sim.attach(1)
                try:
                    while not sim._stop.is_set():
                        frame, seen = sim.next_frame(seen)
                        if not frame:
                            continue
                        self.wfile.write(b"--frame\r\n")
                        self.wfile.write(b"Content-Type: " + sim.mime.encode() + b"\r\n")
                        self.wfile.write(
                            b"Content-Length: %d\r\n\r\n" % len(frame))
                        self.wfile.write(frame)
                        self.wfile.write(b"\r\n")
                except (BrokenPipeError, ConnectionResetError):
                    pass
                finally:
                    sim.attach(-1)
            elif self.path == "/stats":
                body = json.dumps({
                    "steps": sim.steps_done,
                    "queue_dropped": sim.queue.dropped,
                    "shape": list(sim.cfg.shape),
                    "sim_fps": round(sim.sim_fps, 2),
                    "encode_fps": round(sim.encode_fps, 2),
                    "frames_encoded": sim.frames_encoded,
                    "frames_dropped": sim.frames_dropped,
                    "stream_decim": sim.stream_decim,
                    "clients": sim.clients,
                }).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            else:
                self.send_error(404)

        def do_POST(self):
            if self.path == "/drag":
                n = int(self.headers.get("Content-Length", 0))
                msg = json.loads(self.rfile.read(n))
                sim.drag(msg["from"], msg["to"], msg.get("ms"))
                self.send_response(204)
                self.end_headers()
            else:
                self.send_error(404)

    return Handler


def serve(cfg: SimConfig, port: int = 8000, fps: float = 30.0,
          n_frames=None, stream_decim: int = 1, encode_duty: float = 0.5,
          device="cuda"):
    """Start the sim and encoder threads and bind the HTTP server on
    127.0.0.1:``port`` (0 picks a free port: read it from
    ``httpd.server_address``); the caller runs ``httpd.serve_forever``.
    Returns ``(sim, httpd)``; ``sim.threads`` are the two threads, which
    end after ``sim.stop()``."""
    sim = SimServer(cfg, fps=fps, stream_decim=stream_decim,
                    encode_duty=encode_duty, device=device)
    httpd = ThreadingHTTPServer(("127.0.0.1", port), make_handler(sim))
    sim_thread = threading.Thread(target=sim.run_sim, args=(n_frames,),
                                  daemon=True, name="sim")
    enc_thread = threading.Thread(target=sim.run_encoder, daemon=True,
                                  name="encoder")
    sim_thread.start()
    enc_thread.start()
    sim.threads = (sim_thread, enc_thread)
    return sim, httpd


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="esp32_fluid_simulation_tpu_torch.io_host.server")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--grid", type=int, nargs=2, default=[61, 81])
    ap.add_argument("--scaling", type=int, default=4)
    ap.add_argument("--fps", type=float, default=30.0)
    ap.add_argument("--solver", default=None,
                    help="override solver (e.g. fused_pallas at >=2048^2)")
    ap.add_argument("--advect-impl", default=None)
    ap.add_argument("--color-dtype", default=None)
    ap.add_argument("--stream-decim", type=int, default=1,
                    help="N: stream an on-device N:1 mean-pooled view "
                         "(production grids; the full sim state is "
                         "untouched)")
    ap.add_argument("--encode-duty", type=float, default=0.5,
                    help="encoder duty-cycle cap in (0, 1]: fraction of "
                         "wall time the frame consumer may spend copying+"
                         "encoding (protects the sim on busy hosts)")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the simulation (cpu runs it "
                         "without a GPU)")
    args = ap.parse_args(argv)
    kw = dict(shape=tuple(args.grid), scaling=args.scaling)
    if args.solver:
        kw["solver"] = args.solver
    if args.advect_impl:
        kw["advect_impl"] = args.advect_impl
    if args.color_dtype:
        kw["color_dtype"] = args.color_dtype
    cfg = SimConfig(**kw)
    sim, httpd = serve(cfg, port=args.port, fps=args.fps,
                       stream_decim=args.stream_decim,
                       encode_duty=args.encode_duty, device=args.device)
    print(f"serving on http://127.0.0.1:{httpd.server_address[1]}/")
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        sim.stop()


if __name__ == "__main__":
    main()
