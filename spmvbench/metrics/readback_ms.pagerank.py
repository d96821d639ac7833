"""``readback_ms.pagerank``: the program's ``pagerank.readback`` spans of a
PageRank call (each iteration's residual read back to the host, waiting
for the device), summed over the call, the mean over the traced slice's
calls."""

from spmvbench.program_spans import mean_per_call


def read(run):
    return mean_per_call(run, "pagerank", "pagerank.readback", 1e-3)
