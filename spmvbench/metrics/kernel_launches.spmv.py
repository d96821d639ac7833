"""``kernel_launches.spmv``: the port's own kernels launched a call (K1's
folds and section epilogues, K2, K3), as the program counts them in its
``spmv.launch`` span, the mean over the traced slice's SpMV calls.  The
fills and joins torch makes are not the port's kernels: the device trace's
``launches_per_call.spmv`` counts them too."""

from spmvbench.program_spans import per_call


def read(run):
    calls = per_call(run, "spmv")
    counts = [n for c in calls or () for _, n in c.get("spmv.launch", ())]
    if not counts or None in counts:
        return None
    return sum(counts) / len(calls)
