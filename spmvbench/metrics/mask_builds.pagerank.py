"""``mask_builds.pagerank``: the dangling masks a PageRank call worked out
and uploaded, as the program counts them on its ``pagerank.mask`` span (1
where the call made the mask, 0 where it found it cached with the plan),
the mean over the traced slice's PageRank calls.  A program whose span
carries no count reads as nothing."""

from spmvbench.program_spans import per_call


def read(run):
    calls = per_call(run, "pagerank")
    counts = [n for c in calls or () for _, n in c.get("pagerank.mask", ())]
    if not counts or None in counts:
        return None
    return sum(counts) / len(calls)
