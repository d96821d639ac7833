"""The arithmetic of the traced slice, on a small recorded event list."""

import os

import pytest

from conftest import REPO
from spmvbench import trace
from spmvbench.reference import models
from spmvbench.run import Run, load_module

# µs: two calls, a kernel overlapping a copy, a gap while the host waits
DEVICE = [("fold_chunk", 10.0, 30.0), ("Memset (Device)", 25.0, 35.0),
          ("unpermute_kernel", 40.0, 50.0), ("fold_chunk", 70.0, 90.0),
          ("unpermute_kernel", 95.0, 100.0)]
HOST = [("spmv.dispatch", 0.0, 12.0), ("spmv.wait", 12.0, 62.0),
        ("spmv.dispatch", 62.0, 72.0), ("spmv.wait", 72.0, 110.0)]
SPAN = (0.0, 110.0)


def reader(name):
    return load_module(os.path.join(REPO, "spmvbench", "metrics",
                                    name + ".py"), "test_" + name)


def test_busy_is_the_union_of_intervals():
    # [10, 35] + [40, 50] + [70, 90] + [95, 100]
    assert trace.busy_us(DEVICE, *SPAN) == pytest.approx(25 + 10 + 20 + 5)
    assert trace.busy_us(DEVICE, 20.0, 45.0) == pytest.approx(15 + 5)
    assert trace.busy_us([], *SPAN) == 0.0


def test_idle_gaps_are_named_by_the_host_span():
    gaps = trace.idle_gaps(DEVICE, HOST, *SPAN)
    assert sum(g for _, g in gaps) == pytest.approx(110 - 60)
    assert gaps[0] == ("spmv.wait", pytest.approx(20.0))      # 50-70
    assert ("spmv.dispatch", pytest.approx(10.0)) in gaps     # 0-10
    assert ("spmv.wait", pytest.approx(10.0)) in gaps         # 100-110


def test_top_ops_sum_by_name():
    assert trace.top_ops(DEVICE, 2) == [("fold_chunk", 40.0),
                                        ("unpermute_kernel", 15.0)]


def test_slice_and_the_readers():
    s = trace.Slice(DEVICE, HOST, SPAN, calls=2, spmvs=2)
    assert s.kernels == 4
    assert s.busy_s == pytest.approx(60e-6)
    assert s.window_s == pytest.approx(110e-6)
    kind = "NVIDIA H100 80GB HBM3"
    run = Run("spmv", rows=1000, cols=500, nnz=20000, device_kind=kind,
              trace=s)
    assert reader("launches_per_call.spmv").read(run) == 2.0
    assert reader("device_idle_pct.spmv").read(run) == pytest.approx(
        100 * (1 - 60 / 110))
    least = models.csr_bytes(1000, 500, 20000) / 3.35e12
    assert reader("spmv_roofline").read(run) == pytest.approx(
        100 * least / 30e-6)
    assert models.csr_bytes(1000, 500, 20000) == \
        20000 * 8 + 1001 * 4 + 500 * 4 + 1000 * 4
    # the PageRank readers stay silent on an SpMV run, and every trace
    # reader on an untraced one or on a card with no published peak
    assert reader("pagerank_spmv_roofline").read(run) is None
    assert reader("device_idle_pct.pagerank").read(run) is None
    other = Run("spmv", 1000, 500, 20000, "some other card", trace=s)
    assert reader("spmv_roofline").read(other) is None
    run.trace = None
    assert reader("spmv_roofline").read(run) is None
    assert reader("launches_per_call.spmv").read(run) is None


def test_pagerank_roofline_counts_each_spmv():
    s = trace.Slice(DEVICE, HOST, SPAN, calls=1, spmvs=3)
    run = Run("pagerank", rows=64, cols=64, nnz=300,
              device_kind="NVIDIA H100 80GB HBM3", trace=s)
    least = 3 * models.pattern_bytes(64, 300) / 3.35e12
    assert reader("pagerank_spmv_roofline").read(run) == pytest.approx(
        100 * least / 60e-6)
    assert models.pattern_bytes(64, 300) == 300 * 4 + 65 * 4 + 2 * 64 * 4 \
        + 64 * 4


def test_window_readers():
    run = Run("spmv", 10, 10, 10, "cpu", setup_s=2.5, calls=4,
              window_s=2e-3, latency_ns=list(range(100, 2100, 100)),
              dispatch_ns=[1000, 3000])
    assert reader("spmv_us").read(run) == pytest.approx(500.0)
    assert reader("spmv_p95_us").read(run) == pytest.approx(1.905)
    assert reader("dispatch_host_us.spmv").read(run) == pytest.approx(2.0)
    assert reader("setup_s").read(run) == 2.5
    assert reader("pagerank_ms").read(run) is None
    pr = Run("pagerank", 10, 10, 10, "cpu", calls=4, window_s=0.2,
             iterations=[40, 42, 41, 41])
    assert reader("pagerank_ms").read(pr) == pytest.approx(50.0)
    assert reader("pagerank_iters").read(pr) == pytest.approx(41.0)
    assert reader("spmv_us").read(pr) is None
