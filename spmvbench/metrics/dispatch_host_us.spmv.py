"""``dispatch_host_us.spmv``: the host's time in ``spmv_csr``, from entry
to return, the mean over the window's calls (the benchmark's own span
around each call, on the host clock)."""


def read(run):
    if run.loop != "spmv" or not run.dispatch_ns:
        return None
    return sum(run.dispatch_ns) / len(run.dispatch_ns) * 1e-3
