"""``step_host_us.pagerank``: the program's ``pagerank.step`` span, the
host issuing one iteration (its SpMV, the dangling dot, the update and the
residual's norm), the mean over the traced slice's iterations."""

from spmvbench.program_spans import per_call


def read(run):
    calls = per_call(run, "pagerank")
    steps = [us for c in calls or () for us, _ in c.get("pagerank.step", ())]
    return sum(steps) / len(steps) if steps else None
