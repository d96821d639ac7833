"""``plan_builds.spmv``: the host plans the program built or rejected a
call, as it counts them in its ``spmv.plan`` span (1 where the call missed
the matrix's plan cache, 0 on a hit), the mean over the traced slice's
SpMV calls.  It reads 0 in a sound window: every plan is built in set-up.
A program that records no ``spmv.plan`` span reads nothing."""

from spmvbench.program_spans import per_call


def read(run):
    calls = per_call(run, "spmv")
    counts = [n for c in calls or () for _, n in c.get("spmv.plan", ())]
    if not counts or None in counts:
        return None
    return sum(counts) / len(calls)
