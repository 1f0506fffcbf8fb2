"""Build and load the package's CUDA kernels.

All of ``csrc/*.cu`` is compiled by ``nvcc`` into one shared library with a
plain C interface and loaded with ``ctypes`` — no PyTorch headers, so a
build takes seconds.  Each source compiles in its own ``nvcc`` process, all
started together, and one more links the objects.  The build happens at first use, never on import, into
``build/kernels/`` beside the package (git-ignored).  The library's file
name carries a hash of the sources, the shared headers (``csrc/*.cuh``)
and the flags, so an edited file builds anew and an unchanged tree is
reused.  The compiler writes to a temporary
file that is then renamed into place, so processes building at once do not
see each other's half-written output.

``--fmad=false`` keeps every product and sum rounded on its own, so each
kernel matches its plain PyTorch version to the bit.

Every C entry point returns ``cudaGetLastError()`` after its launches.
The kernel wrappers reach the library through one path, ``launch`` (and
``query`` for the entries that answer the host): it loads the library,
makes the launch's device current where it is not, passes tensors as their
pointers and the device's current stream last, and raises on a nonzero
code.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-Xptxas", "-v", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    # field, vel, overlay, out, frame, lo, hi, C, H, W, field_bf16, dt,
    # max_disp, mh, mw, ox, oy, halo, GH, GW, no_slip, clip01, bswap,
    # minmax, stack, stream
    "fluid_advect": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _I,
                     _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P),
    # field, phi_hat, cmin, cmax, vel, out, C, H, W, field_bf16, dt,
    # max_disp, mh, mw, no_slip, stream
    "fluid_maccormack_correct": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F,
                                 _I, _I, _I, _I, _P),
    # field, vel, out, C, H, W, field_bf16, dt, max_disp, mh, mw, no_slip,
    # stream (-1: the window does not fit, nothing launched)
    "fluid_maccormack": (_P, _P, _P, _I, _I, _I, _I, _F, _I, _I, _I, _I, _P),
    # vel, vel_out, p, dxd, ipos, ivel, iact, n_imp, H, W, mh, mw, oi, oj,
    # GH, GW, halo, p_out, dx, inv2dx, iters, omega, one_m_w, stream
    "fluid_project": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                      _I, _I, _I, _P, _F, _F, _I, _F, _F, _P),
    # vel, vel_out, p_out, ipos, ivel, iact, n_imp, H, W, mh, mw, oi, oj,
    # GH, GW, halo, dx, inv2dx, iters, omega, one_m_w, n_strips, n_segs,
    # stream
    "fluid_project_window": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                             _I, _I, _I, _I, _F, _F, _I, _F, _F, _I, _I, _P),
    # iters -> resident blocks per SM of the window route (0: refused)
    "fluid_project_window_blocks": (_I,),
    # vel, vel_out, p_out, ipos, ivel, iact, n_imp, H, W, mh, mw, oi, oj,
    # GH, GW, halo, dx, inv2dx, iters, omega, one_m_w, tile_h, tile_w,
    # threads_y, stack, stream
    "fluid_project_trapezoid": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                _I, _I, _I, _I, _I, _F, _F, _I, _F, _F, _I,
                                _I, _I, _I, _P),
    # pos, vel, active, out, n, K, gw, mh, mw, plane, stream
    "fluid_member_overlay": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    # color, out, H, W, color_bf16, s, bswap, unit_range, stream
    "fluid_render_rgb565": (_P, _P, _I, _I, _I, _I, _I, _I, _P),
    # field, vel, out, C, D, H, W, field_bf16, vel_bf16, dt, max_disp,
    # no_slip, ox, oy, halo, GH, GW, stream
    "fluid_advect3d": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _I, _I, _I,
                       _I, _I, _I, _I, _P),
    # rho, temp, vel, out, mask, D, H, W, dt, max_disp, no_slip, rho_in,
    # temp_in, alpha, beta, stream
    "fluid_advect3d_source": (_P, _P, _P, _P, _P, _I, _I, _I, _F, _I, _I, _F,
                              _F, _F, _F, _P),
    # vel, out, D, H, W, inv2dx, stream
    "fluid_divergence3d": (_P, _P, _I, _I, _I, _F, _P),
    # vel, p, out, D, H, W, inv2dx, stream
    "fluid_subtract_gradient3d": (_P, _P, _P, _I, _I, _I, _F, _P),
    # d, p_in, p_out, D, H, W, oz, oi, oj, GD, GH, GW, dx, h0, depth,
    # omega, one_m_w, tile_h, tile_w, zchunk, vec, stream
    "fluid_sor3d_pass": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _F,
                         _I, _I, _F, _F, _I, _I, _I, _I, _P),
    # tile_h, tile_w, depth -> a block's threads (0: refused)
    "fluid_sor3d_pass_threads": (_I, _I, _I),
    # d, p, dxd, H, W, mh, mw, oi, oj, GH, GW, halo, p_out, dx, iters,
    # omega, one_m_w, stream
    "fluid_sor": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P, _F, _I,
                  _F, _F, _P),
    # d, p_out, H, W, mh, mw, oi, oj, GH, GW, halo, dx, iters, omega,
    # one_m_w, tile_h, tile_w, threads_y, stream
    "fluid_sor_window": (_P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _F, _I,
                         _F, _F, _I, _I, _I, _P),
    # density, out, D, H, W, density_bf16, vec, seg_len, threads_x,
    # segments, inv_vmax, bswap, stream
    "fluid_smoke_mip": (_P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _F, _I, _P),
}
# Each entry's buffer arguments by position (a launch entry's stream, last,
# aside): the launch path passes a tensor there as its data pointer
_BUFFERS = {name: tuple(k for k, t in enumerate(argtypes[:-1]) if t is _P)
            for name, argtypes in _SIGNATURES.items()}


class KernelLibrary:
    """The loaded library, with the build's wall time and compiler log."""

    def __init__(self, path: Path, build_seconds: float, log: str):
        self.path = path
        self.build_seconds = build_seconds
        self.log = log
        self._lib = ctypes.CDLL(str(path))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(self._lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int

    def call(self, name: str, *args) -> None:
        """Call entry ``name``; raise if it reports a CUDA error."""
        err = getattr(self._lib, name)(*args)
        if err != 0:
            raise RuntimeError(f"{name} failed with CUDA error {err}")

    def value(self, name: str, *args) -> int:
        """Call query entry ``name`` and return what it returns."""
        return getattr(self._lib, name)(*args)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME or put nvcc on PATH)")
    return path


def _source_key(srcs) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in list(srcs) + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


@functools.lru_cache(maxsize=1)
def load() -> KernelLibrary:
    """Build (if needed) and load the kernel library; cached per process."""
    srcs = sorted(CSRC.glob("*.cu"))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    target = BUILD_DIR / f"libfluidkernels-{_source_key(srcs)}.so"
    t0 = time.perf_counter()
    log = ""
    if not target.exists():
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
            log = _compile_and_link(srcs, Path(tmp), target)
    return KernelLibrary(target, time.perf_counter() - t0, log)


def _compile_and_link(srcs, tmp: Path, target: Path) -> str:
    """One ``nvcc -c`` per source, run at once, then one link; the library
    is renamed into place only when every step succeeded."""
    nvcc = _nvcc()
    objs = [tmp / f"{src.stem}.o" for src in srcs]
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj),
                               str(src)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for src, obj in zip(srcs, objs)]
    log = ""
    failed = []
    for src, proc in zip(srcs, procs):
        out, _ = proc.communicate()
        log += out
        if proc.returncode != 0:
            failed.append(f"{src.name} ({proc.returncode})")
    if failed:
        raise RuntimeError(f"nvcc failed on {', '.join(failed)}:\n{log}")
    lib = tmp / target.name
    res = subprocess.run([nvcc, "-shared", "-o", str(lib), *map(str, objs)],
                         capture_output=True, text=True)
    log += res.stdout + res.stderr
    if res.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({res.returncode}):\n{log}")
    os.replace(lib, target)
    return log


def _invoke(entry: str, device: torch.device, args, stream: bool) -> int:
    """What entry ``entry`` returns, called with ``device`` current: a
    tensor in a buffer argument as its data pointer (None is a null
    pointer) and, with ``stream``, the device's current stream last."""
    args = list(args)
    for k in _BUFFERS[entry]:
        if args[k] is not None:
            args[k] = args[k].data_ptr()
    if stream:
        # read at every call, as torch.cuda.stream() and graph capture set
        # it; torch.cuda.current_stream(device).cuda_stream is the same
        # handle by way of a Stream object, 7-9 us a launch more (H100 host)
        args.append(torch._C._cuda_getCurrentRawStream(device.index))
    lib = load()
    if device.index == torch.cuda.current_device():
        return lib.value(entry, *args)
    with torch.cuda.device(device):
        return lib.value(entry, *args)


def launch(entry: str, on: torch.Tensor, *args, refused=None) -> bool:
    """Launch entry ``entry`` on ``on``'s device and current stream with
    ``args`` (tensors and None as ``_invoke`` passes them).  Raises
    RuntimeError on a nonzero code other than ``refused``, the code with
    which an entry says it launched nothing; returns whether it
    launched."""
    code = _invoke(entry, on.device, args, True)
    if code not in (0, refused):
        raise RuntimeError(f"{entry} failed with CUDA error {code}")
    return code == 0


def query(entry: str, device: torch.device, *args) -> int:
    """What query entry ``entry`` answers for ``device`` (made current; it
    takes no stream)."""
    return _invoke(entry, device, args, False)
