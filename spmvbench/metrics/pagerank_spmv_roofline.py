"""``pagerank_spmv_roofline``: the least time of the SpMVs that the traced
PageRank calls made, the pattern byte model a SpMV times their count over
the card's published bandwidth, as a share of the device's busy time, in
%."""

from spmvbench.reference.models import pattern_bytes, peak_bytes_per_s


def read(run):
    peak = peak_bytes_per_s(run.device_kind)
    t = run.trace
    if run.loop != "pagerank" or t is None or not peak or not t.spmvs \
            or t.busy_s <= 0:
        return None
    least = pattern_bytes(run.rows, run.nnz) * t.spmvs / peak
    return 100.0 * least / t.busy_s
