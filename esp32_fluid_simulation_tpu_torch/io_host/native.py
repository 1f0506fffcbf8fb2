"""ctypes bindings for the native host runtime (counterpart of
``esp32_fluid_simulation_tpu/io_host/native.py``).

The port keeps its own copy of the C++ source, ``native/fluidhost.cpp``,
and builds it on first use with ``make`` into ``build/native/`` at the
repository root (git-ignored): the compiler writes a temporary file in
that directory, which is then renamed into place, so processes that build
at once never load a half-written library.  It is rebuilt when the source
is newer than the library.  See fluidhost.cpp for the mapping to the
reference's FreeRTOS primitives.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

_NATIVE_DIR = Path(__file__).resolve().parents[1] / "native"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
LIB_PATH = BUILD_DIR / "libfluidhost.so"
_build_lock = threading.Lock()
_lib = None


class _Drag(ctypes.Structure):
    _fields_ = [("i", ctypes.c_int32), ("j", ctypes.c_int32),
                ("vi", ctypes.c_float), ("vj", ctypes.c_float)]


def _build():
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run(["make", "-s", "-B", f"OUT={tmp}"], cwd=_NATIVE_DIR,
                       check=True)
        os.replace(tmp, LIB_PATH)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the port's libfluidhost.so."""
    global _lib
    if _lib is not None:
        return _lib
    with _build_lock:
        if _lib is not None:
            return _lib
        src = _NATIVE_DIR / "fluidhost.cpp"
        if (not LIB_PATH.exists()
                or LIB_PATH.stat().st_mtime < src.stat().st_mtime):
            _build()
        lib = ctypes.CDLL(str(LIB_PATH))

        lib.fh_queue_create.restype = ctypes.c_void_p
        lib.fh_queue_create.argtypes = [ctypes.c_uint32]
        lib.fh_queue_destroy.argtypes = [ctypes.c_void_p]
        lib.fh_queue_try_push.restype = ctypes.c_int
        lib.fh_queue_try_push.argtypes = [
            ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_float, ctypes.c_float]
        lib.fh_queue_drain.restype = ctypes.c_int
        lib.fh_queue_drain.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(_Drag), ctypes.c_int]
        lib.fh_queue_dropped.restype = ctypes.c_uint64
        lib.fh_queue_dropped.argtypes = [ctypes.c_void_p]

        lib.fh_handshake_create.restype = ctypes.c_void_p
        lib.fh_handshake_destroy.argtypes = [ctypes.c_void_p]
        for name in ("fh_producer_acquire", "fh_consumer_acquire"):
            fn = getattr(lib, name)
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.c_void_p, ctypes.c_int64]
        lib.fh_producer_publish.argtypes = [ctypes.c_void_p]
        lib.fh_consumer_release.argtypes = [ctypes.c_void_p]

        lib.fh_pacer_create.restype = ctypes.c_void_p
        lib.fh_pacer_create.argtypes = [ctypes.c_double]
        lib.fh_pacer_destroy.argtypes = [ctypes.c_void_p]
        lib.fh_pacer_wait.restype = ctypes.c_int
        lib.fh_pacer_wait.argtypes = [ctypes.c_void_p]

        lib.fh_rgb565_to_rgb888.argtypes = [
            ctypes.POINTER(ctypes.c_uint16), ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int64, ctypes.c_int]

        lib.fh_jpeg_available.restype = ctypes.c_int
        lib.fh_jpeg_rgbx_available.restype = ctypes.c_int
        if lib.fh_jpeg_available():
            lib.fh_jpeg_encode_rgb8.restype = ctypes.c_int64
            lib.fh_jpeg_encode_rgb8.argtypes = [
                ctypes.POINTER(ctypes.c_uint8), ctypes.c_int32,
                ctypes.c_int32, ctypes.c_int32,
                ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64]
        lib.fh_jpeg_encode_rgbx.restype = ctypes.c_int64
        lib.fh_jpeg_encode_rgbx.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64]
        _lib = lib
    return _lib


class DragQueue:
    """Bounded lossy SPSC drag queue (``xQueueCreate(10, ...)``, .ino:49)."""

    def __init__(self, capacity: int = 10):
        self._lib = load_library()
        self._q = self._lib.fh_queue_create(capacity)

    def try_push(self, i: int, j: int, vi: float, vj: float) -> bool:
        return bool(self._lib.fh_queue_try_push(self._q, i, j, vi, vj))

    def drain(self, max_n: int = 64):
        buf = (_Drag * max_n)()
        n = self._lib.fh_queue_drain(self._q, buf, max_n)
        return [(buf[k].i, buf[k].j, buf[k].vi, buf[k].vj) for k in range(n)]

    @property
    def dropped(self) -> int:
        return int(self._lib.fh_queue_dropped(self._q))

    def __del__(self):
        try:
            self._lib.fh_queue_destroy(self._q)
        except Exception:
            pass


class FrameHandshake:
    """1-slot producer/consumer rendezvous (color semaphores, .ino:58-59)."""

    def __init__(self):
        self._lib = load_library()
        self._h = self._lib.fh_handshake_create()

    def producer_acquire(self, timeout_ms: int = -1) -> bool:
        return bool(self._lib.fh_producer_acquire(self._h, timeout_ms))

    def producer_publish(self):
        self._lib.fh_producer_publish(self._h)

    def consumer_acquire(self, timeout_ms: int = -1) -> bool:
        return bool(self._lib.fh_consumer_acquire(self._h, timeout_ms))

    def consumer_release(self):
        self._lib.fh_consumer_release(self._h)

    def __del__(self):
        try:
            self._lib.fh_handshake_destroy(self._h)
        except Exception:
            pass


class FramePacer:
    """Absolute-deadline frame pacing (.ino:16,94)."""

    def __init__(self, fps: float):
        self._lib = load_library()
        self._p = self._lib.fh_pacer_create(fps)

    def wait(self) -> int:
        """Sleep to the next deadline; returns missed periods."""
        return self._lib.fh_pacer_wait(self._p)

    def __del__(self):
        try:
            self._lib.fh_pacer_destroy(self._p)
        except Exception:
            pass


def jpeg_available() -> bool:
    """True when libfluidhost was built against libjpeg(-turbo)."""
    return bool(load_library().fh_jpeg_available())


def jpeg_encode_rgb8(rgb: np.ndarray, quality: int = 85) -> bytes:
    """Native JPEG encode of an ``[H, W, 3]`` uint8 array, off the GIL.

    The MJPEG server's frame encoder: a single C call into libjpeg-turbo
    in place of PIL's per-frame Python work.  Raises ``RuntimeError`` if the library was built without JPEG support
    (check ``jpeg_available()``; the server falls back to PIL)."""
    lib = load_library()
    if not lib.fh_jpeg_available():
        raise RuntimeError("libfluidhost built without libjpeg")
    rgb = np.ascontiguousarray(rgb, dtype=np.uint8)
    h, w, c = rgb.shape
    assert c == 3, rgb.shape
    cap = rgb.size + 4096         # JPEG of photographic data is far smaller
    out = np.empty(cap, np.uint8)
    n = lib.fh_jpeg_encode_rgb8(
        rgb.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        w, h, quality,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), cap)
    if n < 0:                     # worst-case incompressible: retry exact
        cap = -n
        out = np.empty(cap, np.uint8)
        n = lib.fh_jpeg_encode_rgb8(
            rgb.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            w, h, quality,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), cap)
    if n <= 0:
        raise RuntimeError("fh_jpeg_encode_rgb8 failed")
    return out[:n].tobytes()


def jpeg_rgbx_available() -> bool:
    """True when the RGBX fast path (libjpeg-turbo JCS_EXT_RGBX) is in."""
    return bool(load_library().fh_jpeg_rgbx_available())


def jpeg_encode_rgbx(rgbx: np.ndarray, quality: int = 85) -> bytes:
    """Native JPEG encode of a packed ``[H, W]`` uint32 RGBX plane
    (little-endian ``R | G<<8 | B<<16``; top byte ignored).

    Consumer for ``render.upscale.render_rgbx`` — the full-color wire
    format (the server default is RGB565 + ``rgb565_to_rgb888`` +
    ``jpeg_encode_rgb8``, half the device->host bytes).  libjpeg-turbo
    consumes the 4-byte pixels directly (JCS_EXT_RGBX, SIMD path)."""
    lib = load_library()
    if not lib.fh_jpeg_rgbx_available():
        raise RuntimeError("libfluidhost built without JCS_EXT_RGBX")
    rgbx = np.ascontiguousarray(rgbx, dtype=np.uint32)
    h, w = rgbx.shape
    cap = rgbx.size * 4 + 4096
    out = np.empty(cap, np.uint8)
    ptr = rgbx.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
    n = lib.fh_jpeg_encode_rgbx(
        ptr, w, h, quality,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), cap)
    if n < 0:
        cap = -n
        out = np.empty(cap, np.uint8)
        n = lib.fh_jpeg_encode_rgbx(
            ptr, w, h, quality,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), cap)
    if n <= 0:
        raise RuntimeError("fh_jpeg_encode_rgbx failed")
    return out[:n].tobytes()


def rgb565_to_rgb888(frame: np.ndarray, swapped: bool = True) -> np.ndarray:
    """Native RGB565 -> RGB888 (the display path of .ino:164-176, inverted)."""
    lib = load_library()
    frame = np.ascontiguousarray(frame, dtype=np.uint16)
    out = np.empty(frame.shape + (3,), np.uint8)
    lib.fh_rgb565_to_rgb888(
        frame.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        frame.size, 1 if swapped else 0)
    return out
