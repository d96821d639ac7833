"""``launch_host_us.spmv``: the program's ``spmv.launch`` span (the host
issuing the plan's launches), the mean over the traced slice's SpMV
calls."""

from spmvbench.program_spans import mean_per_call


def read(run):
    return mean_per_call(run, "spmv", "spmv.launch")
