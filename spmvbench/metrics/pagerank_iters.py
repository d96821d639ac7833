"""``pagerank_iters``: the mean iterations of the window's PageRank calls
(``PageRankResult.iterations``)."""


def read(run):
    if run.loop != "pagerank" or not run.iterations:
        return None
    return sum(run.iterations) / len(run.iterations)
