"""One call's ``fluid.*`` spans for the span tests, as ``(name, parent's
name or None)`` pairs in order of entry: from a CPU ``torch.profiler``
(the parent is the innermost span whose range holds it) and from
``spans.record()`` (the parent it stamped).  Imports no JAX."""

from torch.profiler import ProfilerActivity, profile

from esp32_fluid_simulation_tpu_torch import spans


def profiled(fn):
    """``fn()`` under a CPU profiler: its result and its spans' pairs."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    events = sorted((e.time_range.start, -e.time_range.end, e.name)
                    for e in prof.events() if e.name.startswith("fluid."))
    pairs, open_ = [], []
    for _, neg_end, name in events:
        # one thread's spans nest: an open span that ends first is done
        while open_ and open_[-1][1] < -neg_end:
            open_.pop()
        pairs.append((name, open_[-1][0] if open_ else None))
        open_.append((name, -neg_end))
    return out, pairs


def recorded(fn, clock=None):
    """``fn()`` with a ``spans.record()`` open: its result, its spans'
    pairs and the recorder."""
    with (spans.record() if clock is None else spans.record(clock)) as rec:
        out = fn()
    names = [s[0] for s in rec.spans]
    return out, [(name, names[parent] if parent >= 0 else None)
                 for name, parent, _, _ in rec.spans], rec


def counting_clock():
    """A stub clock that counts its calls: each returns the next integer
    ns."""
    calls = []

    def clock():
        calls.append(None)
        return len(calls)
    return clock, calls
