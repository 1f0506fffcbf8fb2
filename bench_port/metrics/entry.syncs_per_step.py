"""CUDA runtime calls that block the host (a synchronise, or a copy or
set that waits), made inside the program's calls (``bench.feed`` and
``bench.step``), per traced step."""

import re

BLOCKING = re.compile(r"^cuda(DeviceSynchronize|StreamSynchronize"
                      r"|EventSynchronize|Memcpy|Memcpy2D|Memcpy3D"
                      r"|Memset|Free|FreeHost)$")


def read(summary: dict, ctx: dict):
    if not summary["runtime"] or not summary["steps"]:
        return None
    n = sum(1 for r in summary["runtime"]
            if r["in_program"] and BLOCKING.match(r["name"]))
    return n / summary["steps"]
