"""``exchange_pct.pagerank``: the copies between cards (the trace's
peer-to-peer ``Memcpy PtoP`` rows: the ranks sent to each shard's card,
its rows gathered back), their union over the union of every card's busy
time in the traced slice, in %.  Nothing on a run of one card."""

from spmvbench.trace import busy_us

EXCHANGE = "Memcpy PtoP"


def read(run):
    t = run.trace
    if run.loop != "pagerank" or t is None or run.cards < 2 \
            or t.busy_s <= 0:
        return None
    copies = [e for e in t.device if e[0].startswith(EXCHANGE)]
    return 100.0 * busy_us(copies, *t.span) * 1e-6 / t.busy_s
