"""``reorder_host_us.spmv``: the program's ``spmv.reorder`` span (the host
serving a block-reordered plan: the permutes of ``x`` and of the rows and
the inner plan's launches between them), the mean over the traced slice's
SpMV calls."""

from spmvbench.program_spans import mean_per_call


def read(run):
    return mean_per_call(run, "spmv", "spmv.reorder")
