"""``spmv_p95_us``: the 95th percentile over all calls of the window of a
call's time from its issue to its result on hand (cells that wait on every
call)."""

import numpy as np


def read(run):
    if run.loop != "spmv" or not run.latency_ns:
        return None
    return float(np.percentile(run.latency_ns, 95)) * 1e-3
