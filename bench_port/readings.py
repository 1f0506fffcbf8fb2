"""The readings that a cell's limits are set from (not run by the
benchmark's own runs).

    python3 bench_port/readings.py --workload <cell> --seconds <s> \\
        --seeds 1,2,3 --control-seeds 4,5,6

In one process: a run of the program for each of ``--seeds`` (its numbers
compared are the lower readings), then a run of the control for each of
``--control-seeds``: the cell's plain reference computed one precision
down (``reference/<entry>.py``, ``lower=True``), put in the program's
place at the cell's own size and driven by the same window, whose numbers
are the upper readings.  Each run prints one JSON line; the last line
gives, for each number, the largest program reading and the smallest
control one.
"""

import argparse
import json
import sys
import time
from pathlib import Path


class Control:
    """The reference at the lower precision, in the program's place.  It
    starts from ``state`` and keeps, of each step's outputs, those named
    as inputs for the next step."""

    def __init__(self, state: dict, sim: dict, scaling: int, reference):
        self.sim, self.scaling, self.ref = sim, scaling, reference
        self._state, self._out = state, {}

    def feed(self, *lists):
        return lists

    def step(self, fed) -> None:
        self._out = self.ref.step(self._state, *fed, self.sim,
                                  self.scaling, lower=True)
        self._state = {k: self._out[k] for k in self._state}

    def inputs(self) -> dict:
        return dict(self._state)

    def outputs(self) -> dict:
        return dict(self._out)


def control_factory(cell: dict):
    """Builds the cell's control: the cell's own entry is built, its
    ``inputs()`` (the program's initial state) are stored as the
    reference's ``lower_state`` stores them, and the entry is freed."""
    from bench_port import core

    name = cell["config"]["entry"]
    reference = core.load_module(core.BENCH / "reference" / f"{name}.py")
    entry = core.load_module(core.BENCH / "entries" / f"{name}.py")

    def build(sim, scaling, device):
        program = entry.build(sim, scaling, device)
        state = reference.lower_state(program.inputs(), sim)
        del program
        return Control(state, sim, scaling, reference)
    return build


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="bench_port/readings.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    args = ap.parse_args(argv)

    import torch

    from bench_port import core

    cell = core.find_cell(args.workload)
    if not torch.cuda.is_available():
        print("readings need a CUDA card", file=sys.stderr)
        return 2
    clock = core.CudaClock()
    lower, upper = {}, {}
    runs = [(int(s), False) for s in args.seeds.split(",") if s]
    runs += [(int(s), True) for s in args.control_seeds.split(",") if s]
    for seed, control in runs:
        r = core.run_cell(cell, seed, args.seconds, False, clock,
                          time.perf_counter(),
                          control_factory(cell) if control else None)
        numbers = {k: v["value"] for k, v in r["compared"].items()}
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control": control, "correct": r["correct"],
                          "steps": r["attempted"], "numbers": numbers}),
              flush=True)
        into = upper if control else lower
        for k, v in numbers.items():
            v = float("inf") if v is None else v
            into.setdefault(k, []).append(v)
        torch.cuda.empty_cache()
    print(json.dumps({"workload": args.workload,
                      "lower": {k: max(v) for k, v in lower.items()},
                      "upper": {k: min(v) for k, v in upper.items()}}))
    return 0


if __name__ == "__main__":
    # the checkout's root, in place of this directory, on the import path
    sys.path[0] = str(Path(__file__).resolve().parents[1])
    sys.exit(main())
