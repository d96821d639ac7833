"""``pagerank_ms``: the window's seconds over the PageRank calls completed
in it, each a solve to the stated tolerance."""


def read(run):
    if run.loop != "pagerank" or not run.calls:
        return None
    return run.window_s / run.calls * 1e3
