"""The port's benchmark: one run of one cell.

    python3 bench_port/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Run from the root of a checkout.  The cell, its configuration, traffic,
entry, reference, limits and per-layer readers are found by name from
``BENCHMARK.json`` and the files under ``bench_port/``.  With ``--trace 0``
the result carries the cell's end-to-end metrics, with ``--trace 1`` its
per-layer metrics from one profiler trace taken after the window.  It
needs as many CUDA cards as the cell asks for, and fails without them.
The last line of standard output is the result, as JSON; the numbers
compared with the reference, each beside its limit, are the last lines of
standard error.  A run whose process holds JAX or the JAX package once
the window has closed fails and prints no result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="bench_port/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from bench_port import core

    cell = core.find_cell(args.workload)
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA card(s); this "
              f"machine has {have}", file=sys.stderr)
        return 2
    result = core.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                           core.CudaClock(), T_START)
    found = core.banned_modules()
    if found:
        print(f"the run loaded {', '.join(found)}; no result",
              file=sys.stderr)
        return 3
    core.emit(result)
    return 0


if __name__ == "__main__":
    # the checkout's root, in place of this directory, on the import path
    sys.path[0] = str(Path(__file__).resolve().parents[1])
    sys.exit(main())
