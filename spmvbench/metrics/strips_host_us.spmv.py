"""``strips_host_us.spmv``: the program's ``spmv.strips`` span (the host
issuing a column-strip plan's partial products and their sum), the mean
over the traced slice's SpMV calls.  A program that records no
``spmv.strips`` span, or a call served by no strip plan, reads nothing."""

from spmvbench.program_spans import mean_per_call


def read(run):
    return mean_per_call(run, "spmv", "spmv.strips")
