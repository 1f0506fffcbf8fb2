"""The interactive host pipeline: the reference's three-task FreeRTOS
architecture around the device step (counterpart of
``esp32_fluid_simulation_tpu/io_host/pipeline.py``).

Reference mapping (SURVEY.md §3):
  touch_routine (.ino:63-96)  -> an input thread pushing drags into the
                                 native lossy DragQueue at its own rate;
  loop()        (.ino:249-289)-> the sim thread: drain queue -> impulses ->
                                 step + render, enqueued on the device;
  draw_routine  (.ino:99-191) -> the consumer thread: copy the rendered
                                 frame to the host, convert natively, hand
                                 to a sink (file/display).

The two-semaphore 1-slot handshake (.ino:58-59) lives in C++
(``FrameHandshake``).  Frame N is copied to the host while frame N+1
computes: the sim thread records a CUDA event after each frame, and the
consumer's copy waits for that event on a stream of its own
(``FrameFetcher``), not behind the sim thread's next step on the device's
default stream.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Callable, Optional

import numpy as np
import torch

from ..config import SimConfig
from ..state import Impulses
from ..models.stable_fluids import init_state
from ..models import make_step_render
from .native import DragQueue, FrameHandshake, FramePacer, rgb565_to_rgb888


def device_context(device: torch.device):
    """The context that makes ``device`` current on this thread (a new
    thread starts on CUDA device 0); a no-op off CUDA."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


class FrameFetcher:
    """Device-to-host frame copies that overlap the producer's next step.

    The producing thread calls ``mark(frame)`` right after the frame's
    work is enqueued; the consuming thread calls ``fetch(frame, event)``,
    which copies on its own stream once that event has passed, into a
    pinned host buffer, and waits for that copy alone."""

    def __init__(self):
        self._stream = None
        self._host = None

    @staticmethod
    def mark(frame: torch.Tensor) -> Optional[torch.cuda.Event]:
        """An event recorded after ``frame``'s work on its device's current
        stream (None for a CPU tensor, which is ready when returned)."""
        if not frame.is_cuda:
            return None
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(frame.device))
        return event

    def fetch(self, frame: torch.Tensor,
              ready: Optional[torch.cuda.Event]) -> np.ndarray:
        """``frame`` on the host.  A CUDA frame lands in a reused pinned
        buffer: the array is valid until the next ``fetch``."""
        if ready is None:
            return frame.numpy()
        if self._stream is None:
            self._stream = torch.cuda.Stream(device=frame.device)
        if (self._host is None or self._host.shape != frame.shape
                or self._host.dtype != frame.dtype):
            self._host = torch.empty(frame.shape, dtype=frame.dtype,
                                     pin_memory=True)
        with torch.cuda.stream(self._stream):
            self._stream.wait_event(ready)
            self._host.copy_(frame, non_blocking=True)
            # the sim thread's allocator must not reuse the frame's memory
            # before this stream's copy has read it
            frame.record_stream(self._stream)
        self._stream.synchronize()
        return self._host.numpy()


class SimPipeline:
    """Producer/consumer sim+render pipeline with native synchronization.

    frame_sink(rgb888: np.ndarray [H,W,3], step: int) is called on the
    consumer thread for every frame.  The state lives on ``device``.
    """

    def __init__(self, cfg: SimConfig, frame_sink: Callable,
                 fps: Optional[float] = None, queue_depth: int = 10,
                 device="cuda"):
        self.cfg = cfg
        self.frame_sink = frame_sink
        self.fps = fps if fps is not None else 1.0 / cfg.dt
        self.device = torch.device(device)
        self.queue = DragQueue(queue_depth)
        self.handshake = FrameHandshake()
        self._frame_slot = None
        self._stop = threading.Event()
        # at scaling==1 on the kernel path the RGB565 pack rides the
        # dye-advect store
        self._step_render_fn = make_step_render(cfg, donate=False)
        self._frames_done = 0

    # -- input side (touch_routine's role) --------------------------------
    def push_drag(self, i: int, j: int, vi: float, vj: float) -> bool:
        """Non-blocking, lossy (.ino:85). Sim-frame coords."""
        return self.queue.try_push(i, j, vi, vj)

    # -- threads ----------------------------------------------------------
    def _sim_thread(self, n_frames: int):
        try:
            with device_context(self.device):
                self._simulate(n_frames)
        except Exception as e:  # surfaced by run()
            self._error = self._error or e
        finally:
            self._stop.set()
            self.handshake.producer_publish()  # unblock consumer shutdown

    def _simulate(self, n_frames: int):
        state = init_state(self.cfg, device=self.device)
        pacer = FramePacer(self.fps)
        for _ in range(n_frames):
            if self._stop.is_set():
                break
            drags = self.queue.drain(self.cfg.max_impulses)
            # queue entries are already sim-frame (i, j, vi, vj)
            imp = (Impulses.from_lists(
                       self.cfg, [(i, j) for i, j, _, _ in drags],
                       [(vi, vj) for _, _, vi, vj in drags],
                       device=self.device)
                   if drags else Impulses.none(self.cfg, device=self.device))
            state, frame = self._step_render_fn(state, imp)
            ready = FrameFetcher.mark(frame)
            # 1-slot publish: wait until the consumer took the previous
            # frame; poll the stop flag so a dead consumer can't wedge us
            while not self.handshake.producer_acquire(timeout_ms=200):
                if self._stop.is_set():
                    return
            self._frame_slot = (frame, ready)
            self.handshake.producer_publish()
            pacer.wait()

    def _consumer_thread(self):
        n = 0
        fetcher = FrameFetcher()
        try:
            while True:
                # the timeout bounds a wait on a publish that a binary
                # semaphore merged with the one before it
                self.handshake.consumer_acquire(timeout_ms=200)
                slot = self._frame_slot
                if slot is None:
                    # _stop is honoured only with the slot empty: the
                    # last frame published is delivered
                    if self._stop.is_set():
                        break
                    continue
                self._frame_slot = None
                self.handshake.consumer_release()
                rgb = rgb565_to_rgb888(fetcher.fetch(*slot))
                self.frame_sink(rgb, n)
                n += 1
        except Exception as e:  # surfaced by run(); must not hang the sim
            self._error = self._error or e
        finally:
            # a frame_sink exception must not strand the producer in
            # producer_acquire: flag the stop and free the slot
            self._stop.set()
            self.handshake.consumer_release()
            self._frames_done = n

    # -- run --------------------------------------------------------------
    def run(self, n_frames: int) -> int:
        """Run the pipeline for ``n_frames``; returns frames delivered.
        Re-raises the first exception of either thread, if any."""
        self._error = None
        sim = threading.Thread(target=self._sim_thread, args=(n_frames,),
                               name="sim")
        consumer = threading.Thread(target=self._consumer_thread,
                                    name="draw")
        consumer.start()
        sim.start()
        sim.join()
        consumer.join(timeout=60)
        if consumer.is_alive():
            raise RuntimeError("the frame consumer did not stop")
        if self._error is not None:
            raise self._error
        return self._frames_done

    def stop(self):
        self._stop.set()
