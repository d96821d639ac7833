"""K4, the merge-path CSR SpMV (``tpu_spmv_torch/kernels/merge_csr.py``), on
the CPU: its plain version against a float64 product, the merge path's
split (each CTA's share and tile starts) and carries, the dispatch's route
to it (``spmv.merge_route``) on a Graph500-law graph and away from it on
the flagship's power law, and the dispatch's handling of its plan
(``run_plan``, ``graphable``, the launch count, the ``spmv.resolve``
count, plan files).  The kernel itself runs on the card
(``tests/test_torch_cuda.py``)."""

import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tpu_spmv_torch import (CSRMatrix, KernelType,  # noqa: E402
                            PageRankConfig, SpMVConfig, pagerank, spmv_csr)
from tpu_spmv_torch import kernels as tk  # noqa: E402
from tpu_spmv_torch.benchmarks.mtx_bench import rmat_csr  # noqa: E402
from tpu_spmv_torch.errors import InvalidFormatError  # noqa: E402
from tpu_spmv_torch.kernels import merge_csr as km  # noqa: E402
from tpu_spmv_torch.kernels import window_ell as twe  # noqa: E402
from tpu_spmv_torch.plan_io import save_plan  # noqa: E402
from tpu_spmv_torch.spmv import (PatternPlan, graphable,  # noqa: E402
                                 launches_per_call, merge_route, resolve_csr,
                                 run_plan)
from tpu_spmv_torch.utils.testing import (RandomGenerator,  # noqa: E402
                                          transition_matrix)

tspmv = sys.modules["tpu_spmv_torch.spmv"]
CPU = torch.device("cpu")
ROW_TOL = 1e-5


@pytest.fixture(autouse=True)
def _counters():
    tk.reset_launch_counts()
    yield
    tk.reset_launch_counts()


def csr_of(lens, num_cols: int, seed: int = 0,
           column_scaled: bool = False) -> CSRMatrix:
    """A matrix with row lengths ``lens``, columns drawn at random
    (repeats allowed), values uniform in [-1, 1) or, column-scaled, one
    value a column."""
    rng = np.random.default_rng(seed)
    ptr = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
    nnz = int(ptr[-1])
    cols = rng.integers(0, num_cols, nnz).astype(np.int32)
    if column_scaled:
        vals = rng.uniform(0.1, 1.0, num_cols).astype(np.float32)[cols]
    else:
        vals = rng.uniform(-1.0, 1.0, nnz).astype(np.float32)
    return CSRMatrix(len(lens), num_cols, vals, cols, ptr)


def product64(A: CSRMatrix, x: np.ndarray, ones: bool = False) -> tuple:
    """``(A @ x, |A| @ |x|)`` in float64 (the stored entries as 1 where
    ``ones``)."""
    rows = np.repeat(np.arange(A.num_rows), np.diff(A.row_ptrs))
    v = np.ones(A.nnz) if ones else A.values.astype(np.float64)
    p = v * x.astype(np.float64)[A.col_indices]
    return (np.bincount(rows, p, minlength=A.num_rows),
            np.bincount(rows, np.abs(p), minlength=A.num_rows))


def graph500_law(scale: int, edgefactor: int, seed: int = 42) -> CSRMatrix:
    """``rmat_csr``'s Kronecker law (A 0.57, B = C 0.19), its vertex labels
    permuted at random as Graph500's generator permutes them."""
    gen = np.random.default_rng(seed)
    A = rmat_csr(gen, scale, edgefactor)
    n = A.num_rows
    p = gen.permutation(n)
    r = p[np.repeat(np.arange(n), np.diff(A.row_ptrs))]
    c = p[A.col_indices]
    o = np.lexsort((c, r))
    ptr = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(r, minlength=n), out=ptr[1:])
    return CSRMatrix(n, n, A.values[o], c[o].astype(np.int32), ptr)


def _lens(name: str) -> np.ndarray:
    rng = np.random.default_rng(7)
    return {
        "empty rows": np.where(rng.random(3000) < 0.4, 0,
                               rng.integers(1, 30, 3000)),
        "hubs over several CTAs": np.concatenate(
            [[9000], rng.integers(0, 4, 700), [7000], [0] * 40,
             rng.integers(0, 40, 300), [5000]]),
        "one nonzero": np.array([0, 0, 1, 0]),
        "all empty": np.zeros(50, np.int64),
    }[name]


CASES = ["empty rows", "hubs over several CTAs", "one nonzero", "all empty"]


@pytest.mark.parametrize("n_ctas", [1, 3, 8, 64])
@pytest.mark.parametrize("pattern", [False, True])
@pytest.mark.parametrize("case", CASES)
def test_plain_version_matches_float64(case, pattern, n_ctas):
    """K4's plain version, split over ``n_ctas`` CTAs, against the float64
    product, row by row within ``1e-5 * (|A| @ |x|)``; a pattern plan of a
    column-scaled matrix takes ``scale * x`` and gives the valued
    product."""
    A = csr_of(_lens(case), 500, column_scaled=pattern)
    x = np.random.default_rng(1).uniform(-1, 1, A.num_cols).astype(
        np.float32)
    ref, scale = product64(A, x)
    plan = km.merge_from_host(km.host_merge(A, pattern), CPU, n_ctas=n_ctas)
    assert plan.pat == pattern and plan.n_ctas <= n_ctas
    xt = torch.from_numpy(x)
    if pattern:
        col_scale = torch.zeros(A.num_cols)
        col_scale[torch.from_numpy(A.col_indices).long()] = \
            torch.from_numpy(A.values)
        xt = col_scale * xt
    y = km.spmv_merge(plan, xt).numpy()
    assert y.dtype == np.float32 and y.shape == (A.num_rows,)
    assert np.all(np.abs(y - ref) <= ROW_TOL * np.maximum(scale, 1e-30))
    if case == "all empty":
        assert not y.any()


@pytest.mark.parametrize("n_ctas", [1, 2, 5, 13])
@pytest.mark.parametrize("case", CASES)
def test_cta_shares_tiles_and_carries(case, n_ctas):
    """The start table: CTA shares of ``rows + nnz`` items equal to within
    one, every tile at most ``TILE`` items, starts monotone in both rows
    and nonzeros and on the merge path (a start ``(r, k)`` has every row
    before ``r`` closed by nonzero ``k``, row ``r`` not); and the CTAs'
    parts and carries add up to the rows' sums."""
    A = csr_of(_lens(case), 300, seed=3)
    ptr = A.row_ptrs.astype(np.int64)
    tiles, row, nz = km.merge_starts(ptr, n_ctas)
    items = A.num_rows + A.nnz
    diag = row.astype(np.int64) + nz
    assert len(diag) == n_ctas * tiles + 1
    assert diag[0] == 0 and diag[-1] == items
    assert row[-1] == A.num_rows and nz[-1] == A.nnz
    shares = np.diff(diag[::tiles])
    assert shares.max() - shares.min() <= 1 and shares.sum() == items
    assert np.all(np.diff(diag) >= 0) and np.all(np.diff(diag) <= km.TILE)
    assert np.all(np.diff(row) >= 0) and np.all(np.diff(nz) >= 0)
    closed = row < A.num_rows
    assert np.all(ptr[row[closed]] <= np.maximum(nz[closed], 0))
    assert np.all(nz[closed] <= ptr[row[closed] + 1])
    assert np.all(ptr[row[row > 0]] <= nz[row > 0])

    plan = km.merge_from_host(km.host_merge(A, False), CPU, n_ctas=n_ctas)
    x = np.random.default_rng(2).uniform(-1, 1, A.num_cols).astype(
        np.float32)
    parts, carry_row, carry_val = km.merge_parts(plan, torch.from_numpy(x))
    starts = plan.tile_row[::plan.tiles]
    assert torch.equal(carry_row, torch.where(
        starts[1:] < A.num_rows, starts[1:], -1).long())
    total = parts.double().index_add_(
        0, carry_row.clamp(min=0), carry_val.double() * (carry_row >= 0))
    ref, scale = product64(A, x)
    assert np.all(np.abs(total.numpy() - ref)
                  <= ROW_TOL * np.maximum(scale, 1e-30))


def test_plan_pads_for_the_bulk_copies():
    """The device arrays hold a multiple of 4 entries: ``row_end`` past
    ``num_rows`` with ``nnz``, columns and values with zeros; an empty
    matrix keeps 4."""
    A = csr_of(np.array([3, 0, 2]), 10)
    plan = km.merge_from_host(km.host_merge(A, False), CPU)
    assert plan.row_end.tolist() == [3, 3, 5, 5]
    assert len(plan.cols) == len(plan.vals) == 8
    assert not plan.cols[5:].any() and not plan.vals[5:].any()
    empty = km.merge_from_host(km.host_merge(csr_of(np.zeros(2, int), 4),
                                             True), CPU)
    assert len(empty.cols) == 4 and empty.vals is None
    assert empty.n_groups == 0 and plan.n_groups == 1


@pytest.fixture(scope="module")
def graph500():
    """A Graph500-law graph (SCALE 13, edgefactor 8) on which the packing
    model estimates about 6.6 slots a nonzero: above the crossover."""
    return graph500_law(13, 8)


@pytest.mark.parametrize("kt", [KernelType.VECTOR_CSR,
                                KernelType.MERGE_PATH])
def test_rule_routes_graph500_to_k4(graph500, kt):
    """``resolve_csr`` serves the Graph500-law graph through K4, for both
    kernel types and for the pattern route of its column-scaled form, and
    the call matches the float64 product; a bf16 request keeps
    window-ELL (K4 has no bf16 instance)."""
    A = graph500
    split = 128 if kt == KernelType.MERGE_PATH else None
    assert merge_route(A, split, pattern=False)
    plan = resolve_csr(A, kt, SpMVConfig(kernel_type=kt), CPU)
    assert isinstance(plan, km.MergePlan) and not plan.pat
    x = RandomGenerator(5).vector(A.num_cols)
    res = spmv_csr(A, x, SpMVConfig(kernel_type=kt), device=CPU)
    assert res.error_code == 0 and res.plan is plan
    ref, scale = product64(A, x)
    assert np.all(np.abs(res.y.numpy() - ref) <= ROW_TOL * scale + 1e-30)
    bf16 = resolve_csr(A, kt, SpMVConfig(kernel_type=kt, bf16_values=True),
                       CPU)
    assert not isinstance(bf16, km.MergePlan)

    P = transition_matrix(A)
    pat = resolve_csr(P, kt, SpMVConfig(kernel_type=kt, pattern=True), CPU)
    assert isinstance(pat, PatternPlan) and isinstance(pat.plan, km.MergePlan)
    assert pat.plan.pat
    xt = torch.from_numpy(x)
    ref_p, scale_p = product64(P, x)
    assert np.all(np.abs(run_plan(pat, xt).numpy() - ref_p)
                  <= ROW_TOL * scale_p + 1e-30)


def test_rule_keeps_the_power_law_on_window_ell():
    """The flagship's power law (dense narrow: the model's estimate is
    unknown, so K1 is priced at one slot a nonzero) stays on window-ELL."""
    A = RandomGenerator(42).power_law_csr(8192, 2048, 12.0, 1.6)
    for kt, split in ((KernelType.VECTOR_CSR, None),
                      (KernelType.MERGE_PATH, 128)):
        assert not merge_route(A, split, pattern=False)
        plan = resolve_csr(A, kt, SpMVConfig(kernel_type=kt), CPU)
        assert isinstance(plan, twe.WindowEllPlan)


def test_rule_prices_both_kernels(graph500, monkeypatch):
    """The rule compares the two predicted times: with K4's cost a nonzero
    raised past K1's at the estimated slots, the same graph stays on
    window-ELL."""
    A = graph500
    _, groups = tspmv._choose_sup(A, with_groups=True, split_rows=None)
    per_nnz = groups * 1024 / A.nnz * tspmv.K1_SLOT_PS["float32"]
    monkeypatch.setitem(tspmv.K4_NNZ_PS, "float32", 1.01 * per_nnz)
    assert not merge_route(A, None, pattern=False)
    monkeypatch.setitem(tspmv.K4_NNZ_PS, "float32", 0.9 * per_nnz)
    monkeypatch.setitem(tspmv.K4_ROW_PS, "float32", 0.0)
    assert merge_route(A, None, pattern=False)


def test_dispatch_handles_the_plan(graph500):
    """``run_plan`` and ``graphable`` take K4's plan alone and under a
    pattern plan; ``launches_per_call`` gives K4 and its fix-up; the
    ``spmv.resolve`` count is the nonzeros in 1,024-slot groups (1.0 slot
    a nonzero, rounded up); plan files refuse it."""
    A = graph500
    plan = resolve_csr(A, KernelType.MERGE_PATH,
                       SpMVConfig(kernel_type=KernelType.MERGE_PATH), CPU)
    assert isinstance(plan, km.MergePlan) and plan.n_ctas == km.CPU_CTAS
    assert graphable(plan)
    assert graphable(PatternPlan(plan, torch.ones(A.num_cols)))
    want = launches_per_call(plan)
    assert want == {"fold": 0, "section_epilogue": 0, "unpermute": 0,
                    "permute_chunks": 0, "merge_csr": 2, "merge_spmm": 0}
    assert launches_per_call(km.merge_from_host(
        km.host_merge(A, False), CPU, n_ctas=1))["merge_csr"] == 1
    assert tspmv._packed_groups(plan) == -(-A.nnz // 1024)
    assert 1.0 <= tspmv._packed_groups(plan) * 1024 / A.nnz < 1 + 1024 / A.nnz
    x = torch.from_numpy(RandomGenerator(9).vector(A.num_cols))
    assert torch.equal(run_plan(plan, x), km.spmv_merge_plain(plan, x))
    assert torch.equal(run_plan(PatternPlan(plan, torch.ones(A.num_cols)),
                                x), run_plan(plan, x))
    with pytest.raises(InvalidFormatError, match="merge-path"):
        save_plan(plan, "unused.npz")
    assert tk.launch_counts()["merge_csr"] == 0   # the plain version


def test_wrapper_checks_its_inputs(graph500):
    plan = km.merge_from_host(km.host_merge(graph500, False), CPU)
    with pytest.raises(ValueError, match="float32"):
        km.spmv_merge(plan, torch.zeros(graph500.num_cols,
                                       dtype=torch.float64))
    with pytest.raises(ValueError, match="shape"):
        km.spmv_merge(plan, torch.zeros(graph500.num_cols + 1))
    with pytest.raises(ValueError, match="32 bits"):
        km.merge_starts(np.array([0, 1 << 31]), 4)


def test_pagerank_over_k4_matches_float64(graph500):
    """PageRank on the Graph500-law graph runs its SpMVs through K4's
    pattern plan and stops after as many iterations as the float64 power
    iteration, at its ranks."""
    P = transition_matrix(graph500)
    res = pagerank(P, PageRankConfig(), device=CPU)
    assert isinstance(res.plan, PatternPlan)
    assert isinstance(res.plan.plan, km.MergePlan)
    n = P.num_rows
    dangling = np.bincount(P.col_indices, minlength=n) == 0
    r = np.full(n, 1.0 / n)
    rows = np.repeat(np.arange(n), np.diff(P.row_ptrs))
    for it in range(1, 101):
        y = np.bincount(rows, P.values.astype(np.float64) * r[P.col_indices],
                        minlength=n)
        new = 0.85 * (y + r[dangling].sum() / n) + 0.15 / n
        step = np.linalg.norm(new - r)
        r = new
        if step < 1e-6:
            break
    r /= r.sum()
    assert res.iterations == it
    assert np.max(np.abs(res.ranks.numpy() - r) / r) < 2e-4
