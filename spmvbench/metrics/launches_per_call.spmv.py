"""``launches_per_call.spmv``: the kernels launched in the traced slice
over the SpMV calls in it (copies and fills the runtime makes are not
kernels)."""


def read(run):
    if run.loop != "spmv" or run.trace is None or not run.trace.calls:
        return None
    return run.trace.kernels / run.trace.calls
