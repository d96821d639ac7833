"""``pagerank_spmv_roofline``: the least time of the SpMVs that the traced
PageRank calls made, the pattern byte model a SpMV times their count over
the published bandwidth of the run's cards together, as a share of the
time some card was busy (the union of the device's operations), in %.

On several cards it cannot pass 100 either: the shards' byte models sum
to at least the whole model (``x`` is read on every card), so the busiest
card streams at least its ``1 / cards``, which takes it at least the
model's least time over ``cards`` cards, and the union of the cards' busy
time is no shorter."""

from spmvbench.reference.models import pattern_bytes, peak_bytes_per_s


def read(run):
    peak = peak_bytes_per_s(run.device_kind)
    t = run.trace
    if run.loop != "pagerank" or t is None or not peak or not t.spmvs \
            or t.busy_s <= 0:
        return None
    least = pattern_bytes(run.rows, run.nnz) * t.spmvs / (run.cards * peak)
    return 100.0 * least / t.busy_s
