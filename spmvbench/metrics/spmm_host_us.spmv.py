"""``spmm_host_us.spmv``: the program's ``spmv.spmm`` span (the host
issuing the SpMM of a 2-D operand: K5 and its fix-up), the mean over the
traced slice's calls.  A program that records no ``spmv.spmm`` span, or a
call of a 1-D operand, reads nothing."""

from spmvbench.program_spans import mean_per_call


def read(run):
    return mean_per_call(run, "spmv", "spmv.spmm")
