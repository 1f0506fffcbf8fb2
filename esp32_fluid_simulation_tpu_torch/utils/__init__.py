"""Host-side utilities (counterpart of
``esp32_fluid_simulation_tpu/utils``)."""

from .uq32 import float_to_uq32, uq32_to_float, uq32_top_bits
from .checkpoint import save_checkpoint, load_checkpoint, dump_arr, load_arr
from .watchdog import make_guarded_step
from .metrics import MetricsLogger, summarize
from .debug import make_checked_step
from .profiling import chain_time, trace
from .roofline import speed_of_light, GPU_SPECS

__all__ = [
    "float_to_uq32",
    "uq32_to_float",
    "uq32_top_bits",
    "save_checkpoint",
    "load_checkpoint",
    "dump_arr",
    "load_arr",
    "make_guarded_step",
    "MetricsLogger",
    "summarize",
    "make_checked_step",
    "chain_time",
    "trace",
    "speed_of_light",
    "GPU_SPECS",
]
