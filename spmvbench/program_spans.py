"""The program's own spans of the traced slice, for the per-layer readers.

``tpu_spmv_torch.profiling`` records spans while a ``torch.profiler``
session is in its recording step, which in a run is the traced slice's
active step alone: ``profiling.spans()`` then holds the slice's calls, one
root span each.  A program without the recorder, or a slice it did not
cover whole, reads as nothing (``None``), never as a wrong number.
"""

from __future__ import annotations

ROOTS = {"spmv": "spmv.call", "pagerank": "pagerank.call"}


def per_call(run, loop: str) -> list | None:
    """For each call of the slice, ``{span name: [(µs, count), ...]}`` of
    the spans inside its root; ``None`` unless ``run`` is a traced run of
    ``loop`` whose slice the program recorded whole (a root of the loop's
    entry for each call, nothing dropped)."""
    if run.loop != loop or run.trace is None or not run.trace.calls:
        return None
    try:
        from tpu_spmv_torch import profiling
    except ImportError:
        return None
    read = getattr(profiling, "spans", None)
    if read is None or profiling.dropped():
        return None
    spans = read()
    roots = {s.call: {} for s in spans
             if s.parent == -1 and s.name == ROOTS[loop]}
    if len(roots) != run.trace.calls:
        return None
    for s in spans:
        if s.parent != -1 and s.call in roots and s.end_ns:
            roots[s.call].setdefault(s.name, []).append(
                ((s.end_ns - s.start_ns) * 1e-3, s.count))
    return list(roots.values())


def mean_per_call(run, loop: str, name: str, scale: float = 1.0):
    """The mean over the slice's calls of the µs a call spent in spans
    named ``name`` (times ``scale``); ``None`` where no call has one."""
    calls = per_call(run, loop)
    if not calls or not any(name in c for c in calls):
        return None
    return sum(sum(us for us, _ in c.get(name, ())) for c in calls) \
        / len(calls) * scale
