"""``spmm_roofline``: the least time of one SpMM, its byte model
(``reference.spmm.spmm_bytes``: the CSR arrays, the operand read once and
``Y`` written once, at the operand's width, which the loop records as
``run.width``) over the card's published bandwidth, as a share of the
device's busy time per call in the traced slice, in %.  Nothing on a run
whose loop records no width."""

from spmvbench.reference.models import peak_bytes_per_s
from spmvbench.reference.spmm import spmm_bytes


def read(run):
    peak = peak_bytes_per_s(run.device_kind)
    width = getattr(run, "width", None)
    t = run.trace
    if run.loop != "spmv" or not width or t is None or not peak \
            or not t.calls or t.busy_s <= 0:
        return None
    least = spmm_bytes(run.rows, run.cols, run.nnz, width) / peak
    return 100.0 * least / (t.busy_s / t.calls)
