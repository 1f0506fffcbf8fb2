"""The kernel wrappers' one launch path (``ops/cuda/build.py`` ``launch``
and ``query``) and their launch check (``ops/cuda/modes.py``
``check_launch``), on the CPU.

A stand-in library takes the loaded one's place: each entry a ``ctypes``
callback of the signature ``_SIGNATURES`` declares, so what reaches it has
passed through the same conversion as a call into the kernels.  The
current device, its current stream and the device switch are stand-ins
too.  ``tests/test_torch_cuda.py`` holds the path on the card: a wrapper
under ``torch.cuda.stream(s)`` runs on ``s``, and one on a second card.
"""

import ctypes
from types import SimpleNamespace

import pytest
import torch

from esp32_fluid_simulation_tpu_torch.ops.cuda import build
from esp32_fluid_simulation_tpu_torch.ops.cuda.advect import (
    advect_kernel, advect_maccormack_kernel)
from esp32_fluid_simulation_tpu_torch.ops.cuda.advect3d import (
    Source, advect3d_kernel, advect3d_source_kernel)
from esp32_fluid_simulation_tpu_torch.ops.cuda.fd3d import (
    divergence3d, subtract_gradient3d)
from esp32_fluid_simulation_tpu_torch.ops.cuda.project import project_fused
from esp32_fluid_simulation_tpu_torch.ops.cuda.sor import sor_solve_kernel
from esp32_fluid_simulation_tpu_torch.ops.cuda.sor3d import (
    sor3d_chunk, sor3d_solve)
from esp32_fluid_simulation_tpu_torch.render.cuda_smoke import (
    render_smoke_mip_kernel)
from esp32_fluid_simulation_tpu_torch.render.cuda_upscale import (
    render_rgb565_kernel)

STREAM = 0x5EED00   # device k's current stream handle is STREAM + k


class StandIn:
    """The library's stand-in: every entry returns ``code`` and records the
    arguments that reached it."""

    def __init__(self, code=0):
        self.code = code
        self.seen = []
        self._entries = {}

    def value(self, name, *args):
        if name not in self._entries:
            def body(*got):
                self.seen.append((name, got))
                return self.code
            proto = ctypes.CFUNCTYPE(ctypes.c_int, *build._SIGNATURES[name])
            self._entries[name] = proto(body)
        return self._entries[name](*args)


@pytest.fixture
def card(monkeypatch):
    """A stand-in library on a stand-in card whose current device is
    ``card.current``; ``card.switched`` lists the devices made current."""
    state = SimpleNamespace(lib=StandIn(), current=0, switched=[])

    class Device:
        def __init__(self, device):
            self.index = device.index

        def __enter__(self):
            state.switched.append(self.index)

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(build, "load", lambda: state.lib)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: state.current)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream",
                        lambda index: STREAM + index, raising=False)
    monkeypatch.setattr(torch.cuda, "device", Device)
    return state


def _on(index):
    return SimpleNamespace(device=torch.device("cuda", index))


def _arguments(argtypes):
    """Arguments for ``argtypes``, each with the value the entry must see:
    pointers alternate between CPU tensors and None, ints and floats count
    up."""
    args, want = [], []
    for k, kind in enumerate(argtypes):
        if kind is ctypes.c_void_p:
            t = None if k % 3 == 2 else torch.zeros(k + 1)
            args.append(t)
            want.append(None if t is None else t.data_ptr())
        elif kind is ctypes.c_int:
            args.append(k + 2)
            want.append(k + 2)
        else:
            args.append(k + 0.5)
            want.append(k + 0.5)
    return args, want


@pytest.mark.parametrize("entry", sorted(build._SIGNATURES))
def test_entry_gets_pointers_and_the_current_stream_last(card, entry):
    """Through each entry's declared signature: a tensor arrives as its
    data pointer, None as a null pointer, a number as itself, and a launch
    entry's last argument is the current stream of the launch's device; a
    query entry takes no stream."""
    argtypes = build._SIGNATURES[entry]
    launches = argtypes[-1] is ctypes.c_void_p
    args, want = _arguments(argtypes[:-1] if launches else argtypes)
    if launches:
        assert build.launch(entry, _on(0), *args) is True
        want.append(STREAM)
    else:
        assert build.query(entry, torch.device("cuda", 0), *args) == 0
    assert card.lib.seen == [(entry, tuple(want))]
    assert card.switched == []


def test_launch_makes_the_device_current_only_where_it_is_not(card):
    """A launch on the current device enters no device context; one on
    another device enters that device's, once, and passes that device's
    stream."""
    d, out = torch.zeros(24), torch.zeros(24)
    args = (d, out, 2, 3, 4, 0.5)
    build.launch("fluid_divergence3d", _on(0), *args)
    assert card.switched == []
    build.launch("fluid_divergence3d", _on(1), *args)
    assert card.switched == [1]
    assert card.lib.seen[-1][1][-1] == STREAM + 1
    build.query("fluid_project_window_blocks", torch.device("cuda", 1), 10)
    assert card.switched == [1, 1]


@pytest.mark.parametrize("code", [1, 700, -1])
def test_launch_raises_naming_the_entry(card, code):
    """A nonzero code raises RuntimeError naming the entry, unless it is
    the code with which the entry says it launched nothing (``refused``):
    then ``launch`` returns False."""
    card.lib.code = code
    args = (torch.zeros(4), torch.zeros(4), 2, 2, 1, 0.5)
    with pytest.raises(RuntimeError,
                       match=f"fluid_divergence3d failed with CUDA error "
                             f"{code}"):
        build.launch("fluid_divergence3d", _on(0), *args)
    with pytest.raises(RuntimeError, match="fluid_divergence3d failed"):
        build.launch("fluid_divergence3d", _on(0), *args, refused=code + 1)
    assert build.launch("fluid_divergence3d", _on(0), *args,
                        refused=code) is False


def _meta(*shape):
    return torch.zeros(shape, device="meta")


WRAPPERS = {
    "project_fused": lambda: project_fused(_meta(2, 8, 8)),
    "sor_solve_kernel": lambda: sor_solve_kernel(_meta(8, 8)),
    "advect_kernel": lambda: advect_kernel(_meta(3, 8, 8), _meta(2, 8, 8),
                                           0.1, False),
    "advect_maccormack_kernel": lambda: advect_maccormack_kernel(
        _meta(3, 8, 8), _meta(2, 8, 8), 0.1, False),
    "render_rgb565_kernel": lambda: render_rgb565_kernel(_meta(3, 8, 8), 2),
    "advect3d_kernel": lambda: advect3d_kernel(_meta(3, 4, 8, 8), None, 0.1,
                                               True),
    "advect3d_source_kernel": lambda: advect3d_source_kernel(
        _meta(4, 8, 8), _meta(4, 8, 8), _meta(3, 4, 8, 8), 0.1, False,
        Source(_meta(4, 8, 8), 0.1, 0.1, 1.0, 0.1)),
    "divergence3d": lambda: divergence3d(_meta(3, 4, 8, 8)),
    "subtract_gradient3d": lambda: subtract_gradient3d(_meta(3, 4, 8, 8),
                                                       _meta(4, 8, 8)),
    "sor3d_solve": lambda: sor3d_solve(_meta(4, 8, 8)),
    "sor3d_chunk": lambda: sor3d_chunk(_meta(4, 8, 8), _meta(4, 8, 8), 1.0, 1,
                                       1.5),
    "render_smoke_mip_kernel": lambda: render_smoke_mip_kernel(
        _meta(4, 8, 8)),
}


@pytest.mark.parametrize("name", sorted(WRAPPERS))
def test_wrapper_refuses_a_device_it_has_no_route_for(name):
    """A tensor on neither the CPU (the plain version) nor a CUDA device
    (the kernel) raises ValueError naming the wrapper, before any library
    is loaded."""
    with pytest.raises(ValueError, match=f"{name}: unsupported device meta"):
        WRAPPERS[name]()
