"""``mask_ms.pagerank``: the program's ``pagerank.mask`` span (the dangling
mask on the host and its upload), the mean over the traced slice's
PageRank calls."""

from spmvbench.program_spans import mean_per_call


def read(run):
    return mean_per_call(run, "pagerank", "pagerank.mask", 1e-3)
