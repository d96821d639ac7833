"""``spmv_us``: the window's seconds over the SpMV calls completed in it."""


def read(run):
    if run.loop != "spmv" or not run.calls:
        return None
    return run.window_s / run.calls * 1e6
