"""Share of the traced stretch in which no kernel, copy or set runs on
the card (the complement of the union of device intervals), in percent."""


def read(summary: dict, ctx: dict):
    if summary["busy_s"] <= 0 or summary["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - summary["busy_s"] / summary["window_s"])
