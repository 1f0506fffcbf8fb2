"""The ensemble's state layout conversions (member stack to the grid the
program steps, or back: a permuting copy of the whole state each) a traced
step, from the program's own running total.  None where the program keeps
no such total."""


def read(summary: dict, ctx: dict):
    counters = summary.get("counters", {})
    if "layouts" not in counters:
        return None
    return counters["layouts"]
