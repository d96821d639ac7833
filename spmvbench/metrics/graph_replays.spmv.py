"""``graph_replays.spmv``: the share of the SpMV calls that replayed their
plan's captured CUDA graph, as the program counts it in its ``spmv.graph``
span (1 a replay, 0 a call run eagerly or captured), the mean over the
traced slice's SpMV calls.  A program that records no ``spmv.graph`` span
(one without the graph, or a plan it never captures) reads nothing."""

from spmvbench.program_spans import per_call


def read(run):
    calls = per_call(run, "spmv")
    counts = [n for c in calls or () for _, n in c.get("spmv.graph", ())]
    if not counts or None in counts:
        return None
    return sum(counts) / len(calls)
