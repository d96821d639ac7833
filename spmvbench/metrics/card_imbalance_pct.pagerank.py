"""``card_imbalance_pct.pagerank``: the busiest card's busy time in the
traced slice over the mean card's, less 1, in %: whether the shards' cut
balances time as well as nonzeros.  Nothing on a run of one card."""


def read(run):
    t = run.trace
    if run.loop != "pagerank" or t is None or run.cards < 2:
        return None
    busy = list(t.card_busy_us.values())
    mean = sum(busy) / len(busy)
    return 100.0 * (max(busy) / mean - 1.0) if mean > 0 else None
