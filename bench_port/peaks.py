"""Published peaks of the cards the benchmark knows, by the name that
``torch.cuda.get_device_name()`` gives.  A card not listed has no peak,
and the readers of roofline shares then report nothing.

NVIDIA H100 SXM (data sheet, dense rates, at its 700 W limit): 3.35 TB/s
of HBM3.
"""

HBM_BYTES_PER_S = {
    "NVIDIA H100 80GB HBM3": 3.35e12,
}


def hbm_bytes_per_s(kind: str):
    return HBM_BYTES_PER_S.get(kind)
