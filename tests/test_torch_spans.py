"""The port's span recorder (``tpu_spmv_torch.profiling``) on ``device="cpu"``:
what records and when, the spans each public entry records, the clock it
shares with ``torch.profiler``, the bounded list and ``annotate``."""

import json
import os
from collections import Counter

import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile, schedule  # noqa: E402

from tpu_spmv_torch import (DeviceCSR, ELLMatrix, KernelType,  # noqa: E402
                            PageRankConfig, SpMVConfig, pagerank, profiling,
                            spmv_auto_config, spmv_csr, spmv_ell)
from tpu_spmv_torch.kernels.window_ell import BandedPlan  # noqa: E402
from tpu_spmv_torch.spmv import launches_per_call  # noqa: E402
from tpu_spmv_torch.utils.testing import (  # noqa: E402
    RandomGenerator, scrambled_banded_csr, transition_matrix, web_graph_csr)

CPU = "cpu"


@pytest.fixture(autouse=True)
def _empty_recorder():
    profiling.clear()
    yield
    profiling.clear()
    assert not profiling.on


@pytest.fixture(scope="module")
def case():
    rng = RandomGenerator(42)
    A = rng.power_law_csr(1024, 256, 6.0, 1.6)
    return A, torch.from_numpy(rng.vector(A.num_cols)), spmv_auto_config(A)


@pytest.fixture(scope="module")
def graph():
    return transition_matrix(web_graph_csr(RandomGenerator(42), 400, 400,
                                           avg_nnz=5))


def call(case, entry="csr"):
    A, x, cfg = case
    if entry == "ell":
        res = spmv_ell(ELLMatrix.from_csr(A), x, device=CPU)
    else:
        res = spmv_csr(A, x, cfg, device=CPU)
    assert res.error_code == 0
    return res


def by_name(spans):
    return Counter(s.name for s in spans)


def test_nothing_is_recorded_by_default(case, graph):
    call(case)
    call(case, "ell")
    pagerank(graph, device=CPU)
    assert profiling.spans() == [] and profiling.dropped() == 0


def test_off_each_site_costs_a_flag_test(case, graph, monkeypatch):
    """With nothing recording, no span opens and each public call checks
    the profiler once."""
    checks = []

    def refuse(*args):
        raise AssertionError("a span opened while nothing records")

    monkeypatch.setattr(profiling, "begin", refuse)
    monkeypatch.setattr(profiling, "end", refuse)
    monkeypatch.setattr(profiling, "_profiler_enabled",
                        lambda: checks.append(1) and False)
    call(case)
    call(case, "ell")
    pagerank(graph, device=CPU)
    assert len(checks) == 3


def test_only_the_profilers_recording_step_records(case):
    """Under a schedule the warm-up step and what follows the active step
    record nothing; the active step records its call."""
    with profile(activities=[ProfilerActivity.CPU],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        call(case)
        prof.step()
        call(case)
        prof.step()
        call(case)
        prof.step()
    assert by_name(profiling.spans()) == {"spmv.call": 1, "spmv.resolve": 1,
                                          "spmv.plan": 1, "spmv.launch": 1}


@pytest.mark.parametrize("entry", ["csr", "ell"])
def test_a_call_records_its_resolve_and_launch(case, entry):
    with profiling.recording():
        call(case, entry)
        call(case, entry)
    spans = profiling.spans()
    assert [s.name for s in spans] == ["spmv.call", "spmv.resolve",
                                       "spmv.plan", "spmv.launch"] * 2
    for k in (0, 4):
        root, resolve, plan, launch = spans[k:k + 4]
        assert root.parent == -1
        assert resolve.parent == launch.parent == k
        assert plan.parent == k + 1
        assert root.call == resolve.call == plan.call == launch.call
        assert root.start_ns <= resolve.start_ns <= plan.start_ns \
            <= plan.end_ns <= resolve.end_ns <= launch.start_ns \
            <= launch.end_ns <= root.end_ns
        # the CPU runs the kernels' plain versions, which count no launch
        assert launch.count == 0 and root.count is None
    assert spans[0].call != spans[4].call
    # the CSR matrix's second call hits its plan; each ELL call is on a
    # new matrix, so each builds one
    assert spans[6].count == (1 if entry == "ell" else 0)


@pytest.mark.parametrize("tolerance, steps, readbacks",
                         [(1e-6, None, None), (0.0, 7, 1)])
def test_pagerank_records_mask_steps_and_readbacks(graph, tolerance, steps,
                                                   readbacks):
    cfg = PageRankConfig(tolerance=tolerance, max_iterations=7)
    with profiling.recording():
        res = pagerank(graph, cfg, device=CPU)
    assert res.error_code == 0 and res.iterations > 1
    spans = profiling.spans()
    got = by_name(spans)
    assert got["pagerank.call"] == got["pagerank.mask"] == 1
    assert got["pagerank.step"] == (steps or res.iterations)
    assert got["pagerank.readback"] == (readbacks or res.iterations)
    root = spans[0]
    assert root.name == "pagerank.call" and root.parent == -1
    assert all(s.parent == 0 and s.call == root.call
               and root.start_ns <= s.start_ns <= s.end_ns <= root.end_ns
               for s in spans[1:])
    # a step's issue, then its read-back
    if tolerance > 0:
        names = [s.name for s in spans[2:]]
        assert names == ["pagerank.step", "pagerank.readback"] \
            * res.iterations


def test_spans_share_the_profilers_clock(case):
    """Converted by the trace's start, the call's span holds every
    operator the profiler recorded inside the call."""
    A, x, cfg = case
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        spmv_csr(A, x, cfg, device=CPU)
    t0 = prof.profiler.kineto_results.trace_start_ns()
    root, _, _, launch = profiling.spans()
    lo, hi = (root.start_ns - t0) * 1e-3, (root.end_ns - t0) * 1e-3
    ops = [e for e in prof.events() if e.name.startswith("aten::")]
    assert ops
    assert all(lo <= e.time_range.start <= e.time_range.end <= hi
               for e in ops)
    # the plain kernels' operators run inside the launch span
    llo, lhi = (launch.start_ns - t0) * 1e-3, (launch.end_ns - t0) * 1e-3
    assert any(llo <= e.time_range.start <= e.time_range.end <= lhi
               for e in ops)


def test_the_bounded_list_counts_what_it_drops(case, monkeypatch):
    monkeypatch.setattr(profiling, "SPAN_CAP", 4)
    with profiling.recording():
        for _ in range(3):
            call(case)
    spans = profiling.spans()
    assert len(spans) == 4 and profiling.dropped() == 12 - 4
    assert [s.name for s in spans] == ["spmv.call", "spmv.resolve",
                                       "spmv.plan", "spmv.launch"]
    assert all(s.end_ns for s in spans)
    profiling.clear()
    assert profiling.spans() == [] and profiling.dropped() == 0


@pytest.mark.parametrize("cap", [None, 1, 0])
def test_a_failed_launch_closes_its_spans(case, monkeypatch, cap):
    """A call that ends in an error still closes every span it opened,
    stored or dropped, and ends the call's recording."""
    import tpu_spmv_torch.spmv as tspmv

    def out_of_memory(plan, x):
        raise torch.OutOfMemoryError("planted")

    monkeypatch.setattr(tspmv, "run_plan", out_of_memory)
    if cap is not None:
        monkeypatch.setattr(profiling, "SPAN_CAP", cap)
    A, x, cfg = case
    with profiling.recording():
        for _ in range(2):
            res = spmv_csr(A, x, cfg, device=CPU)
            assert res.error_code != 0 and not profiling.on
    spans = profiling.spans()
    names = ["spmv.call", "spmv.resolve", "spmv.plan", "spmv.launch"] * 2
    stored = len(names) if cap is None else cap
    assert [s.name for s in spans] == names[:stored]
    assert profiling.dropped() == len(names) - stored
    for s in spans:
        root = s.name == "spmv.call"
        assert s.end_ns and (s.parent == -1) == root
        assert root or spans[s.parent].end_ns >= s.end_ns


def test_annotate_records_and_appears_in_the_chrome_trace(case, tmp_path):
    """``annotate`` is the recorder's span: a root holding the public calls
    made inside it, and, while recording, a region of ``trace``'s Chrome
    trace; outside any recording it records nothing."""
    with profiling.annotate("outside"):
        call(case)
    assert profiling.spans() == []
    log_dir = tmp_path / "trace"
    with profiling.trace(str(log_dir)):
        with profiling.annotate("solver-step"):
            call(case)
    files = os.listdir(log_dir)
    assert len(files) == 1
    with open(log_dir / files[0]) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "solver-step" in names
    spans = profiling.spans()
    assert [s.name for s in spans] == ["solver-step", "spmv.call",
                                       "spmv.resolve", "spmv.plan",
                                       "spmv.launch"]
    assert spans[0].parent == -1 and spans[1].parent == 0
    assert len({s.call for s in spans}) == 1


def test_clear_is_refused_inside_a_recorded_span(case):
    with profiling.recording(), profiling.annotate("outer"):
        with pytest.raises(RuntimeError, match="inside a recorded span"):
            profiling.clear()
        call(case)
    assert [s.name for s in profiling.spans()][:2] == ["outer", "spmv.call"]


def test_launch_total_sums_the_launch_counters(monkeypatch):
    """``spmv.launch``'s count reads ``launch_total``: the sum of
    ``launch_counts()`` (the CPU's plain versions count nothing, so the
    counters are set by hand)."""
    from tpu_spmv_torch import kernels
    from tpu_spmv_torch.kernels import window_ell as twe

    monkeypatch.setattr(twe.window_ell_fold, "launches",
                        dict.fromkeys(twe.FOLD_VARIANTS, 0))
    for k, fn in enumerate((twe.section_epilogue, twe.unpermute,
                            twe.permute_chunks)):
        monkeypatch.setattr(fn, "launches", k + 2)
    for k, v in enumerate(twe.FOLD_VARIANTS):
        twe.window_ell_fold.launches[v] = 10 * (k + 1)
    assert kernels.launch_total() == sum(kernels.launch_counts().values()) \
        == 2 + 3 + 4 + 10 + 20 + 30


@pytest.fixture
def banded_mesh():
    """A scrambled banded matrix the reorder probe admits, and a vector
    (made for each test: the plans are cached on the matrix)."""
    rng = RandomGenerator(42)
    A = scrambled_banded_csr(rng, 16384, 1024, 6.0)
    return A, torch.from_numpy(rng.vector(A.num_cols))


def reordered_call(banded_mesh, monkeypatch, banded):
    """``spmv_csr`` of the planted mesh through its reordered plan, the
    inner plan one window-ELL plan or (the group cap lowered under it) a
    row-banded stack, at step width 8."""
    from tpu_spmv_torch.kernels import plan as tplan
    from tpu_spmv_torch.kernels import reorder as tr

    A, x = banded_mesh
    cfg = SpMVConfig(kernel_type=KernelType.VECTOR_CSR, block_size=16)
    if banded:
        single, _ = tr.build_reordered_host(A, step_groups=8)
        monkeypatch.setattr(tplan, "MAX_GROUPS", single.n_groups - 8)
    res = spmv_csr(A, x, cfg, device=CPU)
    assert res.error_code == 0 and isinstance(res.plan, tr.ReorderedPlan)
    assert isinstance(res.plan.inner, BandedPlan) == banded
    return res


@pytest.mark.parametrize("banded, permutes", [(True, 2), (False, 0)])
def test_a_reordered_call_records_its_permutes(banded_mesh, monkeypatch,
                                               banded, permutes):
    """``spmv.reorder`` sits inside ``spmv.launch``; its count is the
    standalone chunk permutes it made: two around a banded inner stack,
    none where the table's set-up and K2's tile map take them."""
    with profiling.recording():
        res = reordered_call(banded_mesh, monkeypatch, banded)
    spans = profiling.spans()
    assert [s.name for s in spans] == ["spmv.call", "spmv.resolve",
                                       "spmv.plan", "spmv.launch",
                                       "spmv.reorder"]
    launch, reorder = spans[3:]
    assert reorder.parent == 3 and reorder.call == launch.call
    assert launch.start_ns <= reorder.start_ns <= reorder.end_ns \
        <= launch.end_ns
    # K3 launches a table set-up a window-ELL plan, and the permutes
    inner = res.plan.inner
    setups = len(inner.plans) if banded else 1
    assert reorder.count == permutes \
        == launches_per_call(res.plan)["permute_chunks"] - setups
    # the resolve span counts the groups of the plan that served
    assert spans[1].count == res.plan.inner.n_groups == res.plan.n_groups


@pytest.mark.parametrize("route", ["csr", "ell", "flat", "reorder off",
                                   "pagerank"])
def test_no_other_route_records_a_reorder(case, graph, banded_mesh, route):
    """The plan of each other route, and the groups its resolve span
    counts: a single plan's, the ELL route's, none on the flat path, the
    natural plan of a matrix the probe would admit; PageRank records no
    ``spmv.*`` span."""
    with profiling.recording():
        if route == "pagerank":
            assert pagerank(graph, device=CPU).error_code == 0
        elif route == "reorder off":
            A, x = banded_mesh
            res = spmv_csr(A, x, SpMVConfig(
                kernel_type=KernelType.VECTOR_CSR, reorder=False),
                device=CPU)
        elif route == "flat":
            A, x, _ = case
            res = spmv_csr(A, x, SpMVConfig(
                kernel_type=KernelType.ELL_KERNEL), device=CPU)
        else:
            res = call(case, route)
    spans = profiling.spans()
    assert spans and "spmv.reorder" not in by_name(spans)
    if route == "pagerank":
        assert not any(s.name.startswith("spmv.") for s in spans)
        return
    assert res.error_code == 0
    resolve = [s for s in spans if s.name == "spmv.resolve"]
    assert len(resolve) == 1
    if route == "flat":
        assert isinstance(res.plan, DeviceCSR) and resolve[0].count is None
    else:
        assert not isinstance(res.plan, DeviceCSR)
        assert resolve[0].count == res.plan.n_groups > 0
