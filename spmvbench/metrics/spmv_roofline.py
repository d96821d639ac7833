"""``spmv_roofline``: the least time of one SpMV, its CSR byte model over
the card's published bandwidth, as a share of the device's busy time per
call in the traced slice, in %."""

from spmvbench.reference.models import csr_bytes, peak_bytes_per_s


def read(run):
    peak = peak_bytes_per_s(run.device_kind)
    t = run.trace
    if run.loop != "spmv" or t is None or not peak or not t.calls \
            or t.busy_s <= 0:
        return None
    least = csr_bytes(run.rows, run.cols, run.nnz) / peak
    return 100.0 * least / (t.busy_s / t.calls)
