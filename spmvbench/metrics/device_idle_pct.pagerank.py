"""``device_idle_pct.pagerank``: the share of the traced slice in which a
card ran nothing, 1 - that card's busy time / the slice's span, the mean
over the run's cards (on one card: 1 - busy / span), in %."""


def read(run):
    t = run.trace
    if run.loop != "pagerank" or t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.card_busy_s / t.window_s)
