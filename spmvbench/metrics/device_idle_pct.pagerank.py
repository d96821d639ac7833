"""``device_idle_pct.pagerank``: the share of the traced slice in which no
operation ran on the device, 1 - busy / span, in %."""


def read(run):
    t = run.trace
    if run.loop != "pagerank" or t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
