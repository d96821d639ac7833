"""A 2-D operand through ``spmv_csr``: K5, the merge-path CSR SpMM
(``tpu_spmv_torch/kernels/merge_csr.py``), on the CPU, against the
benchmark's float64 reference (``spmvbench/reference/spmm.py``) and
column by column against the 1-D ``spmv_csr``; the entry's checks and
error codes; the dispatch's plan, span and launch count; the ``gcn``
law's renormalised adjacency against a dense one; and a tiny run of the
``aggregate`` mix through the harness, with a planted fault and the
control; and tiny HPCG runs under the ``stencil_solve`` mix, whose
control fails where the ``solve`` mix's cannot.  The card's cases (marked ``cuda``) hold K5 to its plain version
and two calls to the same bits."""

import json
import os
import shutil
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from spmvbench import run as harness  # noqa: E402
from spmvbench.reference import plain, spmm as ref  # noqa: E402
from spmvbench.reference.matrix import Matrix  # noqa: E402
from tpu_spmv_torch import (CSRMatrix, ELLMatrix, KernelType,  # noqa: E402
                            SpMVConfig, SpMVError, profiling,
                            spmv_auto_config, spmv_csr, spmv_ell)
from tpu_spmv_torch import kernels as tk  # noqa: E402
from tpu_spmv_torch.bandwidth import compute_bandwidth_csr  # noqa: E402
from tpu_spmv_torch.kernels import merge_csr as km  # noqa: E402
from tpu_spmv_torch.spmv import (graphable, launches_per_call,  # noqa: E402
                                 run_plan)

tspmv = sys.modules["tpu_spmv_torch.spmv"]
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
# an entry's gap from the float64 product over |A| @ |X| of the entry:
# float32 sums of at most a few thousand products round within 1e-5 (the
# K4 tests' row bound); a bf16-rounded operand reads about 2e-3
GAP = 1e-5
WIDTHS = (1, 3, 4, 32, 256)


@pytest.fixture(autouse=True)
def _counters():
    """The launch counters from 0; one intra-op thread (the test workers
    share the machine's cores, and many small CPU ops oversubscribe
    them)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    tk.reset_launch_counts()
    yield
    tk.reset_launch_counts()
    torch.set_num_threads(n)


def csr_of(lens, num_cols: int, seed: int) -> CSRMatrix:
    """Rows of lengths ``lens``, columns at random (repeats allowed),
    values uniform in [-1, 1)."""
    rng = np.random.default_rng(seed)
    ptr = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
    nnz = int(ptr[-1])
    return CSRMatrix(len(lens), num_cols,
                     rng.uniform(-1.0, 1.0, nnz).astype(np.float32),
                     rng.integers(0, num_cols, nnz).astype(np.int32), ptr)


def power_law(seed: int = 1) -> CSRMatrix:
    """Skewed rows (Pareto lengths), every 13th row empty."""
    rng = np.random.default_rng(seed)
    lens = (rng.pareto(1.3, 700) * 4).astype(np.int64)
    lens[::13] = 0
    return csr_of(lens, 500, seed)


def long_row() -> CSRMatrix:
    """A row of 3,000 nonzeros among rows of 0-4: longer than each of the
    CPU's ``CPU_CTAS`` shares, so its part crosses several."""
    lens = np.arange(400) % 5
    lens[123] = 3000
    return csr_of(lens, 300, 2)


MATRICES = {"power_law": power_law,
            "empty_rows": lambda: csr_of(np.zeros(40, np.int64), 30, 3),
            "long_row": long_row,
            "one_by_one": lambda: csr_of(np.array([1]), 1, 4)}


def as_matrix(A: CSRMatrix) -> Matrix:
    return Matrix(A.num_rows, A.num_cols, A.values, A.col_indices,
                  A.row_ptrs)


def op_of(A: CSRMatrix) -> plain.Operator:
    """The float64 reference's operator of ``A`` on the CPU."""
    return plain.Operator(as_matrix(A), CPU)


def operand(A: CSRMatrix, k: int, seed: int = 5) -> torch.Tensor:
    g = torch.Generator().manual_seed(seed)
    return torch.rand(A.num_cols, k, generator=g) * 2.0 - 1.0


@pytest.mark.parametrize("k", WIDTHS)
@pytest.mark.parametrize("name", sorted(MATRICES))
def test_a_2d_operand_matches_the_float64_reference(name, k):
    A = MATRICES[name]()
    X = operand(A, k)
    res = spmv_csr(A, X, spmv_auto_config(A), device=CPU)
    assert res.error_code == 0
    assert isinstance(res.plan, km.SpmmPlan)
    assert res.y.shape == (A.num_rows, k) and res.y.dtype == torch.float32
    assert ref.output_gap(op_of(A), X, [res.y]) <= GAP


@pytest.mark.parametrize("k", WIDTHS)
@pytest.mark.parametrize("name", sorted(MATRICES))
def test_each_column_matches_the_1d_call(name, k):
    A = MATRICES[name]()
    X = operand(A, k, seed=6)
    Y = spmv_csr(A, X, device=CPU).y
    y = torch.stack([spmv_csr(A, X[:, j].contiguous(), device=CPU).y
                     for j in range(k)], 1)
    _, scale = ref.products(op_of(A), X)
    den = torch.where(scale > 0, scale, torch.ones_like(scale))
    assert float(((Y.double() - y.double()).abs() / den).max()) <= 2 * GAP


@pytest.mark.parametrize("n_shares", [1, 2, 7, 50, 4000])
def test_the_split_and_carries_at_any_share_count(n_shares):
    """K5's plain version through ``spmm_from_host`` at share counts from
    one to more than the rows (capped at the path's items): every row
    whole, each carry added once."""
    A = long_row()
    plan = km.spmm_from_host(km.host_merge(A, False), CPU, n_shares)
    items = A.num_rows + A.nnz
    assert plan.n_shares == min(n_shares, items)
    X = operand(A, 5)
    Y = km.spmm_merge(plan, X)
    assert ref.output_gap(op_of(A), X, [Y]) <= GAP
    assert torch.equal(Y, km.spmm_merge_plain(plan, X))


def test_the_plain_version_in_column_blocks(monkeypatch):
    """Blocks of one column (``_PLAIN_ELEMS`` below the nonzeros) give
    what one block gives."""
    A = power_law(7)
    plan = km.spmm_from_host(km.host_merge(A, False), CPU, 5)
    X = operand(A, 6)
    whole = km.spmm_merge_plain(plan, X)
    monkeypatch.setattr(km, "_PLAIN_ELEMS", 1)
    assert torch.equal(km.spmm_merge_plain(plan, X), whole)


def test_the_1d_plain_version_is_unchanged_by_the_2d_parts():
    """K4's plain version of a column equals column j of the 2-D parts'
    fix-up over the same split."""
    A = power_law(3)
    plan = km.merge_from_host(km.host_merge(A, False), CPU, n_ctas=3)
    X = operand(A, 4)
    Y = km.spmm_merge(km.SpmmPlan(plan), X)
    for j in range(4):
        assert torch.allclose(km.spmv_merge_plain(plan, X[:, j].contiguous()),
                              Y[:, j], rtol=0, atol=1e-6)


@pytest.mark.parametrize("kernel_type", list(KernelType))
def test_k5_serves_every_kernel_type_from_one_plan(kernel_type):
    A = power_law(4)
    X = operand(A, 8)
    cfg = SpMVConfig(kernel_type=kernel_type)
    res = spmv_csr(A, X, cfg, device=CPU)
    assert res.error_code == 0 and isinstance(res.plan, km.SpmmPlan)
    assert res.plan is spmv_csr(A, operand(A, 3), SpMVConfig(),
                                device=CPU).plan
    assert ("spmm", "cpu") in A._plan_cache
    assert res.plan.n_shares == km.CPU_CTAS


def test_the_1d_route_is_untouched_by_a_2d_call():
    """The 1-D call resolves the plan it resolved before any 2-D call, and
    the 2-D call adds only K5's keys to the plan cache."""
    A = power_law(5)
    cfg = spmv_auto_config(A)
    x = operand(A, 1)[:, 0].contiguous()
    before = type(spmv_csr(A, x, cfg, device=CPU).plan)
    keys = set(A._plan_cache)
    spmv_csr(A, operand(A, 4), cfg, device=CPU)
    assert set(A._plan_cache) - keys == {"spmm", ("spmm", "cpu")}
    after = spmv_csr(A, x, cfg, device=CPU)
    assert type(after.plan) is before
    assert not isinstance(after.plan, km.SpmmPlan)


@pytest.mark.parametrize("bad", ["rows", "three_d", "zero_width",
                                 "vec_size"])
def test_invalid_dimension(bad):
    A = power_law(6)
    X = operand(A, 4)
    kw = {}
    if bad == "rows":
        X = X[:-1]
    elif bad == "three_d":
        X = X[None]
    elif bad == "zero_width":
        X = X[:, :0]
    else:
        kw["vec_size"] = A.num_cols + 1
    res = spmv_csr(A, X, device=CPU, **kw)
    assert res.error_code == int(SpMVError.INVALID_DIMENSION)
    assert res.y is None


@pytest.mark.parametrize("cfg", [SpMVConfig(bf16_values=True),
                                 SpMVConfig(pattern=True),
                                 SpMVConfig(kernel_type=KernelType.VECTOR_CSR,
                                            pattern=True)])
def test_bf16_values_and_pattern_refuse_a_2d_operand(cfg):
    A = power_law(6)
    res = spmv_csr(A, operand(A, 4), cfg, device=CPU)
    assert res.error_code == int(SpMVError.INVALID_ARGUMENT)
    assert res.y is None and "spmm" not in A._plan_cache
    # a 1-D operand under the same configuration is served
    assert spmv_csr(A, operand(A, 1)[:, 0].contiguous(), cfg,
                    device=CPU).error_code == 0


def test_spmv_ell_keeps_rejecting_a_2d_operand():
    A = power_law(8)
    E = ELLMatrix.from_csr(A)
    res = spmv_ell(E, operand(A, 4), device=CPU)
    assert res.error_code == int(SpMVError.INVALID_DIMENSION)


def test_a_numpy_operand_and_a_matrix_without_rows():
    A = power_law(9)
    X = operand(A, 3)
    got = spmv_csr(A, X.numpy().astype(np.float64), device=CPU).y
    assert torch.equal(got, spmv_csr(A, X, device=CPU).y)
    Z = CSRMatrix(0, 4, np.zeros(0, np.float32), np.zeros(0, np.int32),
                  np.zeros(1, np.int32))
    res = spmv_csr(Z, torch.ones(4, 3), device=CPU)
    assert res.error_code == 0 and res.y.shape == (0, 3)


def test_a_transposed_operand_is_made_contiguous():
    A = power_law(10)
    Xt = operand(A, 5).t().contiguous().t()
    assert not Xt.is_contiguous()
    res = spmv_csr(A, Xt, device=CPU)
    assert res.error_code == 0
    assert ref.output_gap(op_of(A), Xt, [res.y]) <= GAP


def test_the_plan_its_launches_span_and_counters():
    """K5's plan: no CUDA graph, two launches on the card (one with one
    share), ``spmv.resolve`` counting its nonzeros in groups, and the span
    ``spmv.spmm`` with the operand's width inside ``spmv.launch``; the
    plain version launches nothing."""
    A = power_law(11)
    plan = spmv_csr(A, operand(A, 2), device=CPU).plan
    assert not graphable(plan)
    assert launches_per_call(plan) == {
        "fold": 0, "section_epilogue": 0, "unpermute": 0,
        "permute_chunks": 0, "merge_csr": 0, "merge_spmm": 2}
    one = km.spmm_from_host(km.host_merge(A, False), CPU, 1)
    assert launches_per_call(one)["merge_spmm"] == 1
    assert tspmv._packed_groups(plan) == -(-A.nnz // 1024)
    assert tk.launch_counts()["merge_spmm"] == 0
    profiling.clear()
    with profiling.recording():
        spmv_csr(A, operand(A, 7), device=CPU)
    spans = profiling.spans()
    profiling.clear()
    names = [s.name for s in spans]
    spmm_span = spans[names.index("spmv.spmm")]
    assert spmm_span.count == 7
    assert spans[spmm_span.parent].name == "spmv.launch"
    assert [s.count for s in spans if s.name == "spmv.plan"] == [0]


def test_run_plan_takes_k5_and_measure_models_the_spmm():
    A = power_law(12)
    X = operand(A, 4)
    plan = spmv_csr(A, X, device=CPU).plan
    assert torch.equal(run_plan(plan, X), km.spmm_merge_plain(plan, X))
    bw = compute_bandwidth_csr(A.num_rows, A.num_cols, A.nnz, 1.0, 1e3, 4)
    assert bw.achieved_gb_s == pytest.approx(
        ref.spmm_bytes(A.num_rows, A.num_cols, A.nnz, 4) / 1e-3 / 1e9)


def test_k5_refuses_operands_it_cannot_take():
    A = power_law(13)
    plan = km.spmm_from_host(km.host_merge(A, False), CPU)
    with pytest.raises(ValueError):
        km.spmm_merge(plan, operand(A, 4).double())
    with pytest.raises(ValueError):
        km.spmm_merge(plan, operand(A, 4)[:-1])
    with pytest.raises(ValueError):
        km.spmm_from_host(km.host_merge(A, True), CPU)


# ---- the gcn law ----

GCN6 = {"generator": "gcn", "scale": 6, "edgefactor": 8, "a": 0.57,
        "b": 0.19, "c": 0.19, "structure_seed": 42, "width": 4}


def gcn_law():
    return harness.load_module(os.path.join(REPO, "spmvbench", "generators",
                                            "gcn.py"), "test_generator_gcn")


def test_the_gcn_law_is_the_renormalised_adjacency():
    """Against a dense ``D̃^-1/2 (A + I) D̃^-1/2`` of the ``graph500`` law's
    graph: symmetric, every diagonal entry present, an isolated vertex's
    1, the values within float32 rounding of float64."""
    law = gcn_law()
    m = law.generate(GCN6, 12345, CPU)
    g = law.graph500.structure(GCN6, 42, CPU)
    n = g.num_rows
    adj = np.zeros((n, n))
    rows = np.repeat(np.arange(n), np.diff(g.row_ptrs))
    adj[rows, g.col_indices] = 1.0
    assert (np.diag(adj) == 0).all()
    a = adj + np.eye(n)
    d = a.sum(1)
    want = a / np.sqrt(d)[:, None] / np.sqrt(d)[None, :]
    got = np.zeros((n, n))
    mrows = np.repeat(np.arange(n), np.diff(m.row_ptrs))
    got[mrows, m.col_indices] = m.values
    assert m.nnz == g.nnz + n
    assert np.count_nonzero(got) == m.nnz
    assert np.array_equal(got != 0, want != 0)
    assert np.allclose(got, want, rtol=1e-7, atol=0)
    assert np.array_equal(got, got.T)
    assert (np.diag(got) > 0).all()
    isolated = d == 1
    assert isolated.any() and (np.diag(got)[isolated] == 1.0).all()
    for r in range(n):   # columns ascend in every row
        c = m.col_indices[m.row_ptrs[r]:m.row_ptrs[r + 1]]
        assert (np.diff(c) > 0).all()


def test_the_gcn_law_ignores_the_run_seed():
    law = gcn_law()
    a, b = law.generate(GCN6, 1, CPU), law.generate(GCN6, 2**40 + 3, CPU)
    assert np.array_equal(a.values, b.values)
    assert np.array_equal(a.col_indices, b.col_indices)


# ---- a tiny run of the aggregate mix ----

TINY_GCN = {**GCN6, "scale": 8, "width": 8}
CELL, REAL = "tinygcn.aggregate", "gcn256s21.aggregate"


@pytest.fixture
def gcn_root(tmp_path, monkeypatch):
    """A checkout root with ``tinygcn.aggregate``: the ``gcn`` law at scale
    8 and width 8 under the ``aggregate`` mix, reporting
    ``gcn256s21.aggregate``'s metrics.  The test process has loaded JAX
    (the suite's ``conftest.py``), which a benchmark run refuses; the
    harness's check of it is stood down here."""
    root = str(tmp_path)
    shutil.copytree(os.path.join(REPO, "spmvbench"),
                    os.path.join(root, "spmvbench"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        bench = json.load(f)
    rel = "spmvbench/configs/tinygcn.json"
    with open(os.path.join(root, rel), "w") as f:
        json.dump(TINY_GCN, f)
    bench["configs"].append({"name": "tinygcn", "source": "tests",
                             "file": rel, "reduced": [], "why": "tests"})
    bench["workloads"].append({"name": CELL, "config": "tinygcn",
                               "traffic": "aggregate", "chips": 1,
                               "why": "tests"})
    for group in ("end_to_end", "per_layer"):
        for m in bench[group]:
            if REAL in m.get("workloads", ()):
                m["workloads"].append(CELL)
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    monkeypatch.setattr(harness, "forbidden_modules", lambda: [])
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield root
    torch.set_num_threads(n)


def run_tiny(root, control=False):
    return harness.run_cell(root, CELL, 2**33 + 17, 0.3, False, CPU,
                            time.perf_counter(), control=control)


def test_the_cells_are_found_from_files_alone():
    bench, entry, conf, config, traffic = harness.resolve(REPO, REAL)
    assert entry["chips"] == 1 and config["generator"] == "gcn"
    assert (config["scale"], config["width"]) == (21, 256)
    assert conf["reduced"] == ["scale"] and traffic["loop"] == "spmm"
    e2e = {m["name"] for m in harness.metrics_of(bench, REAL, False)}
    assert e2e == {"setup_s", "spmv_us", "spmv_p95_us"}
    layer = {m["name"] for m in harness.metrics_of(bench, REAL, True)}
    assert {"spmm_roofline", "spmm_host_us.spmv",
            "kernel_launches.spmv"} <= layer
    assert "spmv_roofline" not in layer
    hp = harness.resolve(REPO, "hpcg104.solve")
    assert hp[1]["config"] == "hpcg104" and hp[4]["loop"] == "stencil_solve"
    solve = harness.read_json(harness.find(REPO, "traffic", "solve",
                                           ".json"))
    assert {k: v for k, v in hp[4].items() if k not in ("loop", "why")} \
        == {k: v for k, v in solve.items() if k not in ("loop", "why")}
    layer = {m["name"] for m in harness.metrics_of(bench, "hpcg104.solve",
                                                   True)}
    assert "spmv_roofline" in layer and "spmm_roofline" not in layer


def test_a_tiny_aggregate_run_is_correct_and_its_control_is_not(gcn_root):
    result, checks = run_tiny(gcn_root)
    assert result["correct"], checks
    assert result["failed"] == 0 and result["attempted"] > 0
    assert set(result["metrics"]) == {"setup_s", "spmv_us", "spmv_p95_us"}
    assert checks["y_gap"][0] <= GAP
    result, checks = run_tiny(gcn_root, control=True)
    assert not result["correct"]
    assert checks["y_gap"][0] > checks["y_gap"][1]


def test_a_tiny_aggregate_run_with_one_entry_altered_is_not_correct(
        gcn_root, monkeypatch):
    import tpu_spmv_torch

    real = tpu_spmv_torch.spmv_csr

    def altered(A, X, cfg=None, **kw):
        res = real(A, X, cfg, **kw)
        res.y = res.y.clone()
        res.y[A.num_rows // 2, 3] *= 1.001
        res.y[A.num_rows // 2, 3] += 1e-3
        return res

    monkeypatch.setattr(tpu_spmv_torch, "spmv_csr", altered)
    result, checks = run_tiny(gcn_root)
    assert not result["correct"], checks


TINY_HPCG = {"generator": "hpcg", "nx": 12, "ny": 10, "nz": 9,
             "structure_seed": 42}


def tiny_root(tmp_path, name, config, traffic, real):
    """A checkout root with the cell ``name`` of ``config`` under the mix
    ``traffic``, reporting ``real``'s metrics."""
    root = str(tmp_path)
    shutil.copytree(os.path.join(REPO, "spmvbench"),
                    os.path.join(root, "spmvbench"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        bench = json.load(f)
    conf = name.split(".")[0]
    rel = f"spmvbench/configs/{conf}.json"
    with open(os.path.join(root, rel), "w") as f:
        json.dump(config, f)
    bench["configs"].append({"name": conf, "source": "tests",
                             "file": rel, "reduced": [], "why": "tests"})
    bench["workloads"].append({"name": name, "config": conf,
                               "traffic": traffic, "chips": 1,
                               "why": "tests"})
    for group in ("end_to_end", "per_layer"):
        for m in bench[group]:
            if real in m.get("workloads", ()):
                m["workloads"].append(name)
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return root


@pytest.fixture
def hpcg_root(tmp_path, monkeypatch):
    """``tinyhpcg.stencil_solve`` and ``tinyhpcg.solve``: the ``hpcg`` law
    at 12 × 10 × 9 under both CSR solve mixes, reporting
    ``hpcg104.solve``'s metrics (the harness's JAX check stood down, as in
    ``gcn_root``)."""
    root = tiny_root(tmp_path, "tinyhpcg.stencil_solve", TINY_HPCG,
                     "stencil_solve", "hpcg104.solve")
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["workloads"].append({"name": "tinyhpcg.solve", "config":
                               "tinyhpcg", "traffic": "solve", "chips": 1,
                               "why": "tests"})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    monkeypatch.setattr(harness, "forbidden_modules", lambda: [])
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield root
    torch.set_num_threads(n)


def run_hpcg(root, mix, control=False):
    return harness.run_cell(root, "tinyhpcg." + mix, 2**33 + 29, 0.3, False,
                            CPU, time.perf_counter(), control=control)


@pytest.mark.parametrize("mix", ["stencil_solve", "solve"])
def test_a_tiny_stencil_run_is_correct(hpcg_root, mix):
    """Both CSR solve mixes serve a stencil correctly, with the metrics of
    ``hpcg104.solve``."""
    result, checks = run_hpcg(hpcg_root, mix)
    assert result["correct"], checks
    assert result["failed"] == 0 and result["attempted"] > 0
    assert checks["y_gap"][0] <= GAP


def test_the_stencil_mix_control_fails_where_the_solve_mix_cannot(
        hpcg_root):
    """A stencil's values are exact in bf16, so the ``solve`` mix's control
    (the bf16 value stream) reads as the sound run does; the
    ``stencil_solve`` mix's (each ``x`` rounded to bf16, ``y`` held to the
    f32 ``x``) is not correct."""
    result, checks = run_hpcg(hpcg_root, "solve", control=True)
    assert result["correct"] and checks["y_gap"][0] <= GAP
    result, checks = run_hpcg(hpcg_root, "stencil_solve", control=True)
    assert not result["correct"]
    assert checks["y_gap"][0] > 10 * checks["y_gap"][1]


def test_the_stencil_mix_draws_the_solve_mix_x(hpcg_root):
    """The sound ``stencil_solve`` run hands the program the ``solve``
    mix's ``x`` vectors and configuration, so both time the same calls."""
    states = {}
    for mix in ("stencil_solve", "solve"):
        _, _, _, config, traffic = harness.resolve(hpcg_root,
                                                   "tinyhpcg." + mix)
        loop = harness.load_module(harness.find(hpcg_root, "loops",
                                                traffic["loop"], ".py"),
                                   "test_" + mix)
        law = harness.load_module(harness.find(hpcg_root, "generators",
                                               "hpcg", ".py"), "test_hpcg")
        cell = harness.Cell(traffic, law.generate(config, 11, CPU), CPU, 11,
                            config=config)
        run = harness.Run(traffic["loop"], 0, 0, 0, "cpu")
        states[mix] = loop.prepare(cell, run)
        assert run.loop == "spmv" and run.plan_s > 0
    a, b = states["stencil_solve"], states["solve"]
    assert torch.equal(a.X, b.X)
    assert all(torch.equal(x, y) for x, y in zip(a.xs, b.xs))
    assert a.cfg == b.cfg


def test_the_roofline_and_span_readers():
    """``spmm_roofline`` reads the SpMM model over the busy time a call,
    nothing without the loop's width; ``spmm_host_us.spmv`` reads nothing
    without spans."""
    from spmvbench.trace import Slice

    reader = harness.load_module(os.path.join(
        REPO, "spmvbench", "metrics", "spmm_roofline.py"), "test_spmm_rl")
    run = harness.Run("spmv", 1000, 1000, 5000, "NVIDIA H100 80GB HBM3")
    run.trace = Slice([("merge_spmm", 0.0, 50.0)], [("spmv.dispatch", 0.0,
                                                     60.0)],
                      (0.0, 100.0), 2, 2)
    assert reader.read(run) is None
    run.width = 16
    least = ref.spmm_bytes(1000, 1000, 5000, 16) / 3.35e12
    assert reader.read(run) == pytest.approx(100 * least / 25e-6)
    span = harness.load_module(os.path.join(
        REPO, "spmvbench", "metrics", "spmm_host_us.spmv.py"), "test_spmm_h")
    assert span.read(run) is None


# ---- on the card ----

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [4, 256, 33])
@pytest.mark.parametrize("name", ["power_law", "long_row", "empty_rows"])
def test_k5_on_the_card_matches_its_plain_version(card, name, k):
    """K5 and its fix-up (two launches; the 16-byte path at 4 and 256, the
    scalar one at 33) against the plain version, and two calls give the
    same bits."""
    A = MATRICES[name]()
    X = operand(A, k).to(card)
    tk.reset_launch_counts()
    res = spmv_csr(A, X, spmv_auto_config(A))
    again = spmv_csr(A, X, spmv_auto_config(A))
    torch.cuda.synchronize()
    assert res.error_code == 0 and isinstance(res.plan, km.SpmmPlan)
    assert torch.equal(res.y, again.y)
    assert tk.launch_counts()["merge_spmm"] \
        == 2 * launches_per_call(res.plan)["merge_spmm"]
    plain = km.spmm_merge_plain(res.plan, X).cpu().double()
    _, scale = ref.products(op_of(A), X.cpu())
    den = torch.where(scale > 0, scale, torch.ones_like(scale))
    assert float(((res.y.cpu().double() - plain).abs() / den).max()) \
        <= 2 * GAP
    assert ref.output_gap(op_of(A), X.cpu(), [res.y.cpu()]) <= GAP


@pytest.mark.cuda
@pytest.mark.parametrize("n_shares", [1, 3, 1000])
def test_k5_on_the_card_at_any_share_count_and_alignment(card, n_shares):
    A = long_row()
    plan = km.spmm_from_host(km.host_merge(A, False), card, n_shares)
    for k in (1, 4, 64, 65, 300):
        X = operand(A, k).to(card)
        off = torch.empty(A.num_cols * k + 1, device=card)[1:].view(
            A.num_cols, k)
        off.copy_(X)
        for Xk in (X, off):
            Y = km.spmm_merge(plan, Xk)
            assert torch.equal(Y, km.spmm_merge(plan, Xk))
            assert ref.output_gap(op_of(A), X.cpu(), [Y.cpu()]) <= GAP
