"""The dispatch's captured calls (``tpu_spmv_torch.spmv``: ``graphable``,
``CallGraph`` and the cache beside the plan) on the CPU, where nothing is
captured: which plans the dispatch would capture, that a CPU call never
captures, and, with a stand-in for the graph, the order of a plan's calls
(eager, captured, replayed), the cache's lifetime and a failed capture.
The captures themselves run on the card (``tests/test_torch_cuda.py``)."""

import logging
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tpu_spmv_torch import (ELLMatrix, SpMVConfig, KernelType,  # noqa: E402
                            spmv_auto_config, spmv_csr, spmv_ell)
from tpu_spmv_torch import kernels as tk  # noqa: E402
from tpu_spmv_torch.errors import DeviceException  # noqa: E402
from tpu_spmv_torch.kernels import plan as tplan  # noqa: E402
from tpu_spmv_torch.kernels import reorder as tr  # noqa: E402
from tpu_spmv_torch.kernels import strips as ts  # noqa: E402
from tpu_spmv_torch.kernels import window_ell as twe  # noqa: E402
from tpu_spmv_torch.spmv import (PatternPlan, _served, run_plan,  # noqa: E402
                                 graphable)
from tpu_spmv_torch.utils.testing import (RandomGenerator,  # noqa: E402
                                          scrambled_banded_csr,
                                          web_graph_csr)

tspmv = sys.modules["tpu_spmv_torch.spmv"]
CPU = "cpu"


@pytest.fixture(autouse=True)
def _counters():
    tk.reset_launch_counts()
    yield
    tk.reset_launch_counts()


@pytest.fixture(scope="module")
def plans():
    """One CPU plan of each kind the dispatch serves, by name."""
    rng = RandomGenerator(42)
    web = web_graph_csr(rng, 6000, 2100, avg_nnz=9)
    single = twe.plan_from_host(tplan.build(web, step_groups=16), CPU)
    banded = twe.banded_from_host(tplan.build_banded(
        web, sup=1024, n_bands=2, step_groups=16, split_rows=128), CPU)
    pat = twe.plan_from_host(tplan.build(web, step_groups=16, pattern=True),
                             CPU)
    scale = torch.ones(web.num_cols)
    mesh = scrambled_banded_csr(RandomGenerator(42), 16384, 1024, 6.0)
    order = tr.block_order(mesh)
    host, _ = tr.build_reordered_host(mesh, order, step_groups=16)
    reordered = tr.reordered_from_host(host, order, mesh.num_rows,
                                       mesh.num_cols, CPU)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tplan, "MAX_GROUPS", host.n_groups - 8)
        hb, _ = tr.build_reordered_host(mesh, order, step_groups=16)
    assert isinstance(hb, tplan.HostBanded)
    reordered_banded = tr.reordered_from_host(hb, order, mesh.num_rows,
                                              mesh.num_cols, CPU)
    wide = web_graph_csr(rng, 8192, 8192, avg_nnz=9)
    strips = ts.strips_from_host(ts.build_strips_host(
        wide, strip_cols=4096, step_groups=16), CPU)
    composite = twe.composite_from_host(
        tplan.build_composite(wide, step_groups=16), CPU)
    return {
        "single": single, "banded": banded,
        "pattern": PatternPlan(pat, scale),
        "pattern-banded": PatternPlan(banded, scale),
        "reordered": reordered, "reordered-banded": reordered_banded,
        "flat-csr": web.to_device(CPU),
        "flat-ell": ELLMatrix.from_csr(web).to_device(CPU),
        "strips": strips, "composite": composite,
    }


@pytest.mark.parametrize("name, captured", [
    ("single", True), ("banded", True), ("pattern", True),
    ("pattern-banded", True), ("reordered", True),
    ("reordered-banded", True), ("flat-csr", False), ("flat-ell", False),
    ("strips", False), ("composite", False)])
def test_graphable_by_plan_type(plans, name, captured):
    """The plans whose whole call is the port's kernels and torch ops that
    never wait on the host are captured; the flat paths, strips and
    composite plans stay eager."""
    assert graphable(plans[name]) is captured


@pytest.fixture
def case():
    rng = RandomGenerator(42)
    A = rng.power_law_csr(1024, 256, 6.0, 1.6)
    return A, torch.from_numpy(rng.vector(A.num_cols))


def no_capture(monkeypatch):
    def refuse(*args, **kw):
        raise AssertionError("a CUDA graph was made")

    monkeypatch.setattr(torch.cuda, "CUDAGraph", refuse)
    monkeypatch.setattr(tspmv, "CallGraph", refuse)


@pytest.mark.parametrize("entry", ["csr", "ell"])
def test_a_cpu_call_never_captures(case, monkeypatch, entry):
    """On a CPU device every call runs the plan eagerly, and nothing of a
    graph is cached beside the plan."""
    no_capture(monkeypatch)
    A, x = case
    if entry == "ell":
        A = ELLMatrix.from_csr(A)
    ys = []
    for _ in range(3):
        res = spmv_ell(A, x, device=CPU) if entry == "ell" \
            else spmv_csr(A, x, spmv_auto_config(A), device=CPU)
        assert res.error_code == 0 and graphable(res.plan)
        ys.append(res.y)
    assert all(torch.equal(ys[0], y) for y in ys[1:])
    assert not any(isinstance(k, tuple) and k[0] == "_graph"
                   for k in A._plan_cache)


class StandIn:
    """A stand-in for :class:`~tpu_spmv_torch.spmv.CallGraph` on the CPU:
    it "captures" by running the plan once (counting nothing, as a capture
    launches nothing), and "replays" eagerly; ``serve`` False makes it
    refuse a call, as a graph does on another stream."""

    made = []
    serve = True
    fail = None

    def __init__(self, plan, x):
        if StandIn.fail is not None:
            raise StandIn.fail
        self.plan = plan
        self.calls = 0
        self.launches = dict.fromkeys(tk.launch_counts(), 0)
        self.launches.update(window_ell_fold=3, unpermute=1,
                             permute_chunks=1, section_epilogue=2)
        StandIn.made.append(self)

    def __call__(self, x):
        if not StandIn.serve:
            return None
        self.calls += 1
        return run_plan(self.plan, x)


@pytest.fixture
def stand_in(monkeypatch):
    monkeypatch.setattr(StandIn, "made", [])
    monkeypatch.setattr(StandIn, "serve", True)
    monkeypatch.setattr(StandIn, "fail", None)
    monkeypatch.setattr(tspmv, "CallGraph", StandIn)
    return StandIn


def served_plan(case):
    A, x = case
    res = spmv_csr(A, x, SpMVConfig(kernel_type=KernelType.MERGE_PATH),
                   device=CPU)
    assert res.error_code == 0 and graphable(res.plan)
    return A, x, res.plan, res.y


def test_the_second_call_captures_and_later_calls_replay(case, stand_in):
    """The first call runs eagerly, the second captures and serves through
    the graph, every later call replays it and counts its captured
    kernels as launched; all give the eager output."""
    A, x, plan, y = served_plan(case)
    cache = {}
    got = []
    for k in range(4):
        before = tk.launch_total()
        out, replayed = _served(plan, x, cache)
        got.append((replayed, len(stand_in.made), tk.launch_total()
                    - before))
        assert torch.equal(out, y)
    assert got == [(0, 0, 0), (0, 1, 0), (1, 1, 7), (1, 1, 7)]
    assert stand_in.made[0].calls == 3
    held = cache[("_graph", id(plan))]
    assert held[0] is plan and held[1] is stand_in.made[0]


def test_a_graph_that_cannot_serve_runs_the_call_eagerly(case, stand_in):
    """Where the graph refuses a call (another stream, its buffers held by
    another thread) the call runs eagerly, counts no replay and is
    served by the same graph again once it can."""
    A, x, plan, y = served_plan(case)
    cache = {}
    _served(plan, x, cache)
    _served(plan, x, cache)
    stand_in.serve = False
    before = tk.launch_total()
    out, replayed = _served(plan, x, cache)
    assert replayed == 0 and tk.launch_total() == before
    assert torch.equal(out, y)
    stand_in.serve = True
    assert _served(plan, x, cache)[1] == 1 and len(stand_in.made) == 1


def test_free_device_drops_the_graph_with_the_plan(case, stand_in):
    """The graph lives in the matrix's plan cache beside its plan:
    ``free_device()`` drops both, and the next plan's calls start over
    (eager, then captured)."""
    A, x, plan, y = served_plan(case)
    for _ in range(3):
        _served(plan, x, A._plan_cache)
    key = ("_graph", id(plan))
    assert A._plan_cache[key][1] is stand_in.made[0]
    A.free_device()
    assert key not in A._plan_cache and not A._plan_cache
    A, x, plan, y = served_plan(case)
    assert _served(plan, x, A._plan_cache)[1] == 0
    assert len(stand_in.made) == 1
    _served(plan, x, A._plan_cache)
    assert len(stand_in.made) == 2


def test_an_entry_of_another_plan_is_not_served(case, stand_in):
    """A cache entry whose plan is not the call's (an id reused) is
    replaced: the call runs eagerly as a first call."""
    A, x, plan, y = served_plan(case)
    cache = {("_graph", id(plan)): (object(), StandIn(plan, x))}
    out, replayed = _served(plan, x, cache)
    assert replayed == 0 and torch.equal(out, y)
    assert cache[("_graph", id(plan))] == (plan, None)


@pytest.mark.parametrize("error", [
    RuntimeError("operation not permitted when stream is capturing"),
    DeviceException("section epilogue launch: cudaError 801")],
    ids=["cuda-error", "launch-error"])
def test_a_failed_capture_leaves_the_plan_eager_and_warns_once(
        case, stand_in, caplog, error):
    """A capture that fails on a CUDA error or a kernel's launch error
    leaves the call and every later one eager, with one warning, and is
    not tried again."""
    A, x, plan, y = served_plan(case)
    stand_in.fail = error
    cache = {}
    with caplog.at_level(logging.WARNING, logger="tpu_spmv_torch"):
        for _ in range(5):
            out, replayed = _served(plan, x, cache)
            assert replayed == 0 and torch.equal(out, y)
    warned = [r for r in caplog.records
              if "not captured in a CUDA graph" in r.message]
    assert len(warned) == 1
    assert cache[("_graph", id(plan))] == (plan, False)
    stand_in.fail = None
    _served(plan, x, cache)
    assert stand_in.made == []


def test_an_out_of_memory_capture_ends_the_call(case, stand_in):
    """Out of memory at the capture ends the call (the dispatch reports
    ``EXECUTION``) and leaves the plan to be captured at its next call."""
    A, x, plan, y = served_plan(case)
    cache = {}
    _served(plan, x, cache)
    stand_in.fail = torch.OutOfMemoryError("CUDA out of memory (planted)")
    with pytest.raises(torch.OutOfMemoryError):
        _served(plan, x, cache)
    assert cache[("_graph", id(plan))] == (plan, None)
    stand_in.fail = None
    out, replayed = _served(plan, x, cache)
    assert replayed == 0 and len(stand_in.made) == 1
    assert torch.equal(out, y)
    assert _served(plan, x, cache)[1] == 1


def test_add_launch_counts_adds_to_each_counter():
    """A replay's captured counts are added kernel by kernel, so
    ``launch_counts()`` reads as if the wrappers had launched them."""
    counts = {name: k + 1 for k, name in enumerate(tk.launch_counts())}
    tk.add_launch_counts(counts)
    tk.add_launch_counts(counts)
    assert tk.launch_counts() == {k: 2 * v for k, v in counts.items()}
    assert tk.launch_total() == 2 * sum(counts.values())
    assert np.all(np.array(list(tk.launch_counts().values())) > 0)
