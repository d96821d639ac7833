"""``slots_per_nnz.spmv``: the packed slots the plan that served a call
streams for each stored nonzero: the count of the program's
``spmv.resolve`` span (the served plan's packed groups, summed over bands
and levels) times the 1,024 slots of a group, over the matrix's nonzeros,
the mean over the traced slice's SpMV calls.  It reads the plan's padding;
1 is a plan without any.  A program whose span carries no count, or a
call served on a flat path, reads as nothing."""

from spmvbench.program_spans import per_call

SLOTS_PER_GROUP = 1024


def read(run):
    calls = per_call(run, "spmv")
    counts = [n for c in calls or () for _, n in c.get("spmv.resolve", ())]
    if not counts or None in counts or run.nnz <= 0:
        return None
    return sum(counts) * SLOTS_PER_GROUP / run.nnz / len(calls)
