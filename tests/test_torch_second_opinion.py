"""The dispatch's second opinion on the route (``spmv._second_opinion``) on
the CPU, with its timer (``spmv._timer``) replaced by one that reports set
times: where the packing model (``spmv.merge_route``) keeps an f32
window-ELL plan, K4's plan serves only where its call takes under
``ROUTE_MARGIN`` of window-ELL's in two trials in turn; a trial that finds
no room on the card keeps the model's plan, and any other failure of it
raises; no trial where the model already says K4,
for a bf16 value stream, where the caller forces the reordered plan, for a
composite plan or strips, or on the CPU with the real timer; one trial a
matrix and device; the loser dropped; and the ``spmv.route`` span against
the module's counters.  The timed trial itself runs on the card
(``tests/test_torch_cuda.py``)."""

import gc
import sys
import weakref

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tpu_spmv_torch import (CSRMatrix, KernelType, SpMVConfig,  # noqa: E402
                            profiling, spmv_auto_config, spmv_csr)
from tpu_spmv_torch.benchmarks.mtx_bench import rmat_csr  # noqa: E402
from tpu_spmv_torch.kernels import merge_csr as km  # noqa: E402
from tpu_spmv_torch.kernels import reorder as tr  # noqa: E402
from tpu_spmv_torch.kernels import strips as ts  # noqa: E402
from tpu_spmv_torch.kernels import window_ell as twe  # noqa: E402
from tpu_spmv_torch.spmv import (merge_route, resolve_csr,  # noqa: E402
                                 run_plan)
from tpu_spmv_torch.utils.testing import (RandomGenerator,  # noqa: E402
                                          scrambled_banded_csr)

tspmv = sys.modules["tpu_spmv_torch.spmv"]
CPU = torch.device("cpu")
ROW_TOL = 1e-5
WINDOW_ELL = (twe.WindowEllPlan, twe.BandedPlan, tr.ReorderedPlan)


class Timer:
    """A stand-in for the card's timer: each call records the plans and
    ``x`` it was handed and reports window-ELL's call at 1 s and K4's at
    ``ratio`` s, or, given a sequence, its next ratio each call; where a
    ratio is an exception, it raises it."""

    def __init__(self, ratio):
        self.ratios = list(ratio) if isinstance(ratio, tuple) else [ratio]
        self.calls = []

    def __call__(self, plans, x):
        self.calls.append((plans, x))
        ratio = self.ratios[min(len(self.calls), len(self.ratios)) - 1]
        if isinstance(ratio, BaseException):
            raise ratio
        return [1.0, ratio]


def timed(monkeypatch, ratio) -> Timer:
    """The second opinion on every device, timed by a :class:`Timer`."""
    timer = Timer(ratio)
    monkeypatch.setattr(tspmv, "_timer", lambda device: timer)
    return timer


def power_law() -> CSRMatrix:
    """The flagship's law, which the model keeps on window-ELL."""
    return RandomGenerator(42).power_law_csr(8192, 2048, 12.0, 1.6)


def graph500() -> CSRMatrix:
    """A Graph500-law graph the model sends to K4."""
    gen = np.random.default_rng(42)
    A = rmat_csr(gen, 13, 8)
    n = A.num_rows
    p = gen.permutation(n)
    r = p[np.repeat(np.arange(n), np.diff(A.row_ptrs))]
    c = p[A.col_indices]
    o = np.lexsort((c, r))
    ptr = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(r, minlength=n), out=ptr[1:])
    return CSRMatrix(n, n, A.values[o], c[o].astype(np.int32), ptr)


def wide(cols: int, rows: int) -> CSRMatrix:
    """``rows`` rows of 6 random columns of ``cols``."""
    r = RandomGenerator(42).rng
    ca = np.sort(r.integers(0, cols, (rows, 6), dtype=np.int32), axis=1)
    va = r.random((rows, 6)).astype(np.float32)
    return CSRMatrix(rows, cols, va.reshape(-1), ca.reshape(-1),
                     np.arange(rows + 1, dtype=np.int32) * 6)


def counters() -> tuple:
    return tspmv._route_trials, tspmv._route_wins


def within_rows(y: torch.Tensor, A: CSRMatrix, x: np.ndarray) -> bool:
    """``y`` against the float64 product, row by row under ``ROW_TOL``
    of ``|A| @ |x|``."""
    rows = np.repeat(np.arange(A.num_rows), np.diff(A.row_ptrs))
    v = A.values.astype(np.float64)
    xc = x.astype(np.float64)[A.col_indices]
    ref = np.bincount(rows, v * xc, minlength=A.num_rows)
    scale = np.bincount(rows, np.abs(v * xc), minlength=A.num_rows)
    return bool(np.all(np.abs(y.numpy() - ref) <= ROW_TOL * scale + 1e-30))


@pytest.mark.parametrize("kt", [KernelType.VECTOR_CSR,
                                KernelType.MERGE_PATH])
@pytest.mark.parametrize("ratio, k4", [(0.5, True), (0.85, True),
                                       (0.9, False), (0.95, False),
                                       (1.5, False)])
def test_k4_serves_only_under_the_margin(monkeypatch, kt, ratio, k4):
    """On the power law the model keeps, the trial times window-ELL's plan
    against K4's f32 plan of the same matrix, on one ``x`` of its columns
    on the plan's device; K4 serves where its call takes under 0.9 of
    window-ELL's in both of two trials, window-ELL at 0.9 and above after
    the first; either way the call matches the float64 product."""
    A = power_law()
    split = 128 if kt == KernelType.MERGE_PATH else None
    assert not merge_route(A, split, pattern=False)
    timer = timed(monkeypatch, ratio)
    before = counters()
    cfg = SpMVConfig(kernel_type=kt)
    x = RandomGenerator(5).vector(A.num_cols)
    res = spmv_csr(A, x, cfg, device=CPU)
    assert res.error_code == 0
    assert counters() == (before[0] + 1, before[1] + k4)
    assert len(timer.calls) == 1 + k4
    plans, tx = timer.calls[0]
    assert all(c[0] == plans and c[1] is tx for c in timer.calls)
    assert isinstance(plans[0], twe.WindowEllPlan)
    assert isinstance(plans[1], km.MergePlan) and not plans[1].pat
    assert plans[1].nnz == A.nnz
    assert tx.shape == (A.num_cols,) and tx.device == CPU
    assert res.plan is plans[1 if k4 else 0]
    assert within_rows(res.y, A, x)


@pytest.mark.parametrize("ratios, calls", [((0.5, 0.95), 2),
                                           ((0.95, 0.5), 1)])
def test_k4_needs_both_trials(monkeypatch, ratios, calls):
    """Where the two trials disagree the model's window-ELL plan serves:
    K4 under the margin in the first and over it in the second, or over
    it in the first (the second then not taken)."""
    A = power_law()
    timer = timed(monkeypatch, ratios)
    before = counters()
    cfg = spmv_auto_config(A)
    plan = resolve_csr(A, KernelType(cfg.kernel_type), cfg, CPU)
    assert isinstance(plan, twe.WindowEllPlan)
    assert len(timer.calls) == calls and plan is timer.calls[0][0][0]
    assert counters() == (before[0] + 1, before[1])


@pytest.mark.parametrize("error", ["out of memory", "no room for K4",
                                   "launch failed"])
def test_only_a_full_card_keeps_the_model_plan(monkeypatch, error):
    """A trial that runs out of device memory, in the timing or in K4's
    upload, keeps the model's plan and counts as a trial K4 lost; any
    other failure (a K4 that fails to build, launch or be captured)
    raises out of the resolve, so a broken K4 fails the call."""
    A = power_law()
    fault = RuntimeError("CUDA error: an illegal memory access") \
        if error == "launch failed" else torch.OutOfMemoryError("no room")
    timer = timed(monkeypatch, fault if error != "no room for K4" else 0.5)
    if error == "no room for K4":
        def full(*a, **k):
            raise tspmv.DeviceAllocError("no room")

        monkeypatch.setattr(tspmv, "merge_from_host", full)
    before = counters()
    cfg = spmv_auto_config(A)
    kt = KernelType(cfg.kernel_type)
    if error == "launch failed":
        with pytest.raises(RuntimeError, match="illegal memory access"):
            resolve_csr(A, kt, cfg, CPU)
        assert counters() == before
        return
    plan = resolve_csr(A, kt, cfg, CPU)
    assert isinstance(plan, twe.WindowEllPlan)
    assert len(timer.calls) == (error == "out of memory")
    assert counters() == (before[0] + 1, before[1])


def reordered_mesh() -> CSRMatrix:
    return scrambled_banded_csr(RandomGenerator(42), 16384, 1024, 6.0)


@pytest.mark.parametrize("ratio, k4", [(0.5, True), (0.95, False)])
def test_a_reordered_plan_is_asked_too(monkeypatch, ratio, k4):
    """The reorder probe's plan of the scrambled banded mesh (which the
    model never prices) goes to the trial as well; K4 replaces it where
    it wins."""
    A = reordered_mesh()
    timer = timed(monkeypatch, ratio)
    cfg = spmv_auto_config(A)
    plan = resolve_csr(A, KernelType(cfg.kernel_type), cfg, CPU)
    assert len(timer.calls) == 1 + k4
    plans, _ = timer.calls[0]
    assert isinstance(plans[0], tr.ReorderedPlan)
    assert plan is plans[1 if k4 else 0]
    x = RandomGenerator(5).vector(A.num_cols)
    assert within_rows(run_plan(plan, torch.from_numpy(x)), A, x)


def no_trial_case(name: str, monkeypatch):
    """``(A, kernel type, config, the plan type that serves)`` of each case
    that takes no trial."""
    if name == "merge_route":
        return graph500(), KernelType.VECTOR_CSR, SpMVConfig(), km.MergePlan
    if name == "bf16_values":
        return (power_law(), KernelType.VECTOR_CSR,
                SpMVConfig(bf16_values=True), twe.WindowEllPlan)
    if name == "reorder=True":
        return (reordered_mesh(), KernelType.VECTOR_CSR,
                SpMVConfig(reorder=True), tr.ReorderedPlan)
    if name == "composite":
        return (wide(tspmv.VMEM_X_MAX_COLS + 4096, 1024),
                KernelType.VECTOR_CSR, SpMVConfig(), twe.CompositePlan)
    if name == "strips":
        return (wide(tspmv.PACKED_MAX_COLS + 4096, 64),
                KernelType.VECTOR_CSR, SpMVConfig(), ts.StripPlan)
    # the pattern route of a column-scaled matrix (PageRank's)
    A = power_law()
    scale = RandomGenerator(3).rng.uniform(0.5, 2.0, A.num_cols)
    A = CSRMatrix(A.num_rows, A.num_cols,
                  scale.astype(np.float32)[A.col_indices], A.col_indices,
                  A.row_ptrs)
    return (A, KernelType.VECTOR_CSR, SpMVConfig(pattern=True),
            tspmv.PatternPlan)


@pytest.mark.parametrize("name", ["merge_route", "bf16_values",
                                  "reorder=True", "composite", "strips",
                                  "pattern"])
def test_no_trial_where_the_route_is_settled(monkeypatch, name):
    """No trial where ``merge_route`` already says K4 (served untimed),
    under ``bf16_values`` (K4 has no bf16 instance), under
    ``reorder=True`` (the caller forced the reordered plan), for a
    composite plan or strips (never captured in a graph), or on the
    pattern route."""
    A, kt, cfg, kind = no_trial_case(name, monkeypatch)
    timer = timed(monkeypatch, 0.01)
    before = counters()
    plan = resolve_csr(A, kt, cfg, CPU)
    assert isinstance(plan, kind)
    assert timer.calls == [] and counters() == before


@pytest.mark.parametrize("name", ["power law", "reordered mesh"])
def test_no_trial_on_the_cpu(monkeypatch, name):
    """With the real timer a CPU device takes no trial: the model's route
    serves, as before the trial, and nothing is timed."""
    def refuse(*a, **k):
        raise AssertionError("a route was timed on the CPU")

    monkeypatch.setattr(tspmv, "_replay_seconds", refuse)
    assert tspmv._timer(CPU) is None
    A = power_law() if name == "power law" else reordered_mesh()
    before = counters()
    cfg = spmv_auto_config(A)
    res = spmv_csr(A, RandomGenerator(5).vector(A.num_cols), cfg,
                   device=CPU)
    assert res.error_code == 0 and isinstance(res.plan, WINDOW_ELL)
    assert counters() == before


@pytest.mark.parametrize("ratio", [0.5, 0.95])
def test_one_trial_a_matrix_and_device(monkeypatch, ratio):
    """A second ``resolve_csr`` and ten calls add no trial, and each of the
    ten calls' ``spmv.plan`` span counts no build."""
    A = power_law()
    timer = timed(monkeypatch, ratio)
    cfg = SpMVConfig(kernel_type=KernelType.MERGE_PATH)
    kt = KernelType.MERGE_PATH
    first = resolve_csr(A, kt, cfg, CPU)
    assert resolve_csr(A, kt, cfg, CPU) is first
    x = RandomGenerator(5).vector(A.num_cols)
    profiling.clear()
    try:
        with profiling.recording():
            for _ in range(10):
                assert spmv_csr(A, x, cfg, device=CPU).plan is first
        spans = profiling.spans()
    finally:
        profiling.clear()
    assert len(timer.calls) == 1 + (ratio < tspmv.ROUTE_MARGIN)
    assert [s.count for s in spans if s.name == "spmv.plan"] == [0] * 10
    assert not any(s.name == "spmv.route" for s in spans)


@pytest.mark.parametrize("ratio, k4", [(0.5, True), (0.95, False)])
def test_the_loser_is_dropped(monkeypatch, ratio, k4):
    """Once the trial is over nothing holds the losing device plan (nor
    a graph beside it in the plan cache), and ``free_device()`` drops the
    winner."""
    A = power_law()
    timer = timed(monkeypatch, ratio)
    cfg = spmv_auto_config(A)
    plan = resolve_csr(A, KernelType(cfg.kernel_type), cfg, CPU)
    plans, _ = timer.calls[0]
    loser = weakref.ref(plans[0 if k4 else 1])
    winner = weakref.ref(plans[1 if k4 else 0])
    assert winner() is plan
    del plans
    timer.calls.clear()
    gc.collect()
    assert loser() is None
    assert not any(isinstance(k, tuple) and k[0] == "_graph"
                   for k in A._plan_cache)
    A.free_device()
    del plan
    gc.collect()
    assert winner() is None


@pytest.mark.parametrize("ratio, k4", [(0.5, True), (0.95, False)])
def test_route_span_agrees_with_the_counters(monkeypatch, ratio, k4):
    """The first call's ``spmv.route`` span, inside its ``spmv.plan``,
    counts 1 where K4 won and 0 where window-ELL kept the matrix, as the
    module's counters moved; later calls record none."""
    A = power_law()
    timed(monkeypatch, ratio)
    before = counters()
    x = RandomGenerator(5).vector(A.num_cols)
    profiling.clear()
    try:
        with profiling.recording():
            for _ in range(3):
                spmv_csr(A, x, spmv_auto_config(A), device=CPU)
        spans = profiling.spans()
    finally:
        profiling.clear()
    route = [s for s in spans if s.name == "spmv.route"]
    assert [s.count for s in route] == [int(k4)]
    assert spans[route[0].parent].name == "spmv.plan"
    assert counters() == (before[0] + 1, before[1] + route[0].count)
