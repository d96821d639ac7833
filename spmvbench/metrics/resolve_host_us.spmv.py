"""``resolve_host_us.spmv``: the program's ``spmv.resolve`` span (the plan
lookup; a cache hit in the window), the mean over the traced slice's
SpMV calls."""

from spmvbench.program_spans import mean_per_call


def read(run):
    return mean_per_call(run, "spmv", "spmv.resolve")
