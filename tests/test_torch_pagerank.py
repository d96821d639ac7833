"""The port's PageRank (``tpu_spmv_torch.pagerank``) against the JAX package's
on the CPU: the cases of ``tests/test_pagerank.py`` run through the port,
and the ranks and iteration counts of both packages on the same matrices.

The port runs with ``device="cpu"``, where the kernel wrappers take their
plain versions; the JAX package runs its Pallas kernels in interpret mode,
with the port's ``_absorb_run_padding`` bound into its planner module for
the test's duration (``monkeypatch``), so no file of the JAX package
changes.  Ranks are compared at ``rtol=1e-4, atol=1e-7``: both packages sum
each SpMV row in fp32 in different orders.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import tpu_spmv  # noqa: E402
import tpu_spmv.kernels.window_ell as jwe  # noqa: E402
from tpu_spmv.csr import CSRMatrix as JaxCSRMatrix  # noqa: E402

from tpu_spmv_torch import (  # noqa: E402
    CSRMatrix, KernelType, PageRankConfig, SpMVError, pagerank,
    pagerank_load_state, pagerank_save_state, pagerank_top_k)
from tpu_spmv_torch.kernels import plan as tplan  # noqa: E402
from tpu_spmv_torch.kernels.window_ell import WindowEllPlan  # noqa: E402
from tpu_spmv_torch.pagerank import column_scale_factor  # noqa: E402
from tpu_spmv_torch.spmv import PatternPlan  # noqa: E402
from tpu_spmv_torch.utils.testing import (RandomGenerator,  # noqa: E402
                                          transition_matrix, web_graph_csr)

CPU = "cpu"


@pytest.fixture
def absorb_helper(monkeypatch):
    monkeypatch.setattr(jwe, "_absorb_run_padding",
                        tplan._absorb_run_padding, raising=False)


def column_normalized_adjacency(rng, n, density=0.2):
    """A random column-normalised adjacency like the reference demo
    (``main.cu:102-112``), as ``tests/test_pagerank.py`` makes it."""
    adj = (rng.rng.random((n, n)) < density).astype(np.float32)
    np.fill_diagonal(adj, 0.0)
    col_sums = adj.sum(axis=0)
    nz = col_sums > 0
    adj[:, nz] /= col_sums[nz]
    return CSRMatrix.from_dense(adj)


def column_normalized(rng_np, n, m):
    """A column-normalised transition matrix from ``m`` random edges
    (values ``1/outdeg[col]``), as ``tests/test_pagerank.py`` makes it."""
    rows = rng_np.integers(0, n, m)
    cols = rng_np.integers(0, n, m)
    keep = rows != cols
    rows, cols = rows[keep], cols[keep]
    outdeg = np.bincount(cols, minlength=n)
    vals = (1.0 / outdeg[cols]).astype(np.float32)
    order = np.lexsort((cols, rows))
    ptr = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(rows, minlength=n), out=ptr[1:])
    return CSRMatrix(n, n, vals[order], cols[order].astype(np.int32),
                     ptr.astype(np.int32))


def dense_of(A) -> np.ndarray:
    d = np.zeros((A.num_rows, A.num_cols), np.float32)
    rows = np.repeat(np.arange(A.num_rows), np.diff(A.row_ptrs))
    d[rows, A.col_indices] = A.values
    return d


def to_jax(A):
    return JaxCSRMatrix(A.num_rows, A.num_cols, A.values, A.col_indices,
                        A.row_ptrs)


def power_iteration(A, cfg) -> np.ndarray:
    """The JAX test's NumPy reference loop (f32 updates, the same stop)."""
    n = A.num_rows
    dense = dense_of(A)
    dangling = (dense.sum(axis=0) == 0.0).astype(np.float32)
    r = np.full(n, 1.0 / n, np.float32)
    for _ in range(cfg.max_iterations):
        r_new = (cfg.damping_factor * (dense @ r)
                 + cfg.damping_factor * float(dangling @ r) / n
                 + (1 - cfg.damping_factor) / n).astype(np.float32)
        resid = float(np.linalg.norm(r_new - r))
        r = r_new
        if resid < cfg.tolerance:
            break
    return r / r.sum()


def test_invariants():
    rng = RandomGenerator(42)
    for _ in range(5):
        n = rng.uniform_int(5, 60)
        adj = column_normalized_adjacency(rng, n)
        cfg = PageRankConfig(max_iterations=100)
        res = pagerank(adj, cfg, device=CPU)
        ranks = res.ranks_host()
        assert res.error_code == 0 and ranks.shape == (n,)
        assert np.all(ranks >= 0)
        assert abs(ranks.sum() - 1.0) < 1e-4
        assert res.converged or res.iterations == cfg.max_iterations
        if res.converged:
            assert res.final_residual < cfg.tolerance


def test_matches_host_power_iteration():
    adj = column_normalized_adjacency(RandomGenerator(42), 40)
    cfg = PageRankConfig(max_iterations=100, tolerance=1e-6)
    res = pagerank(adj, cfg, device=CPU)
    np.testing.assert_allclose(res.ranks_host(), power_iteration(adj, cfg),
                               rtol=1e-4, atol=1e-6)


def test_topk():
    rng = RandomGenerator(42)
    for _ in range(5):
        n = rng.uniform_int(10, 50)
        adj = column_normalized_adjacency(rng, n)
        res = pagerank(adj, device=CPU)
        k = rng.uniform_int(1, n)
        top = pagerank_top_k(res, n, k)
        assert len(top) == min(k, n)
        ranks = [t.rank for t in top]
        assert all(ranks[i] >= ranks[i + 1] for i in range(len(ranks) - 1))
        true_sorted = np.sort(res.ranks_host())[::-1]
        np.testing.assert_allclose(ranks, true_sorted[:k], rtol=1e-6)
        assert all(res.ranks_host()[t.node_id] == t.rank for t in top)
    res = pagerank(column_normalized_adjacency(rng, 8), device=CPU)
    assert len(pagerank_top_k(res, 8, 20)) == 8
    assert pagerank_top_k(res, 8, 0) == [] == pagerank_top_k(None, 8, 3)


def test_3cycle_symmetric_ranks():
    adj = np.array([[0, 0, 1], [1, 0, 0], [0, 1, 0]], np.float32)
    res = pagerank(CSRMatrix.from_dense(adj), device=CPU)
    np.testing.assert_allclose(res.ranks_host(), [1 / 3] * 3, atol=1e-5)
    assert res.converged


def test_null_empty_and_non_square():
    assert pagerank(None).ranks is None
    res = pagerank(CSRMatrix.from_dense(np.zeros((0, 0), np.float32)),
                   device=CPU)
    assert res.error_code == 0 and res.ranks_host().shape == (0,)
    rect = CSRMatrix.from_dense(np.ones((4, 5), np.float32))
    res = pagerank(rect, device=CPU)
    jres = tpu_spmv.pagerank(to_jax(rect))
    assert res.error_code == jres.error_code == SpMVError.INVALID_DIMENSION
    assert res.ranks is None and np.isnan(res.final_residual)


def test_save_load_resume(tmp_path, absorb_helper):
    """Five iterations, saved, loaded and resumed for 95 more, match a
    straight run; the JAX loader reads the port's file and the port's
    loader the JAX package's."""
    adj = column_normalized_adjacency(RandomGenerator(42), 40)
    partial = pagerank(adj, PageRankConfig(max_iterations=5, tolerance=0.0),
                       device=CPU)
    assert partial.iterations == 5
    path = tmp_path / "state"
    pagerank_save_state(partial, path)
    loaded = pagerank_load_state(path)
    assert loaded.iterations == partial.iterations
    resumed = pagerank(adj, PageRankConfig(max_iterations=95),
                       initial_ranks=loaded.ranks, device=CPU)
    straight = pagerank(adj, PageRankConfig(max_iterations=100), device=CPU)
    assert resumed.converged and straight.converged
    np.testing.assert_allclose(resumed.ranks_host(), straight.ranks_host(),
                               rtol=1e-4, atol=1e-7)
    jloaded = tpu_spmv.pagerank_load_state(path)
    assert jloaded.iterations == 5
    assert np.array_equal(np.asarray(jloaded.ranks), partial.ranks_host())
    jpartial = tpu_spmv.pagerank(to_jax(adj), tpu_spmv.PageRankConfig(
        max_iterations=5, tolerance=0.0))
    tpu_spmv.pagerank_save_state(jpartial, tmp_path / "jax.npz")
    back = pagerank_load_state(tmp_path / "jax.npz")
    assert back.iterations == 5 and back.final_residual \
        == jpartial.final_residual
    assert np.array_equal(back.ranks.numpy(), np.asarray(jpartial.ranks))


def test_column_scale_factor_detection():
    from tpu_spmv.pagerank import column_scale_factor as jax_scale

    A = column_normalized(np.random.default_rng(9), 500, 4000)
    s = column_scale_factor(A)
    assert s is not None
    np.testing.assert_array_equal(s[A.col_indices], A.values)
    assert np.array_equal(s, jax_scale(to_jax(A)))
    A.values[0] *= 2.0
    if np.count_nonzero(A.col_indices == A.col_indices[0]) > 1:
        assert column_scale_factor(A) is None


def test_pattern_path_matches_f32_route(monkeypatch):
    """A transition matrix runs on a pattern plan; with the pattern path
    turned off (``TPU_SPMV_NO_PATTERN``, as in the JAX package) on the f32
    plan; both converge to the same ranks in the same iterations."""
    A = column_normalized(np.random.default_rng(3), 2000, 16000)
    r_pat = pagerank(A, device=CPU)
    assert isinstance(r_pat.plan, PatternPlan) and r_pat.plan.plan.pat
    monkeypatch.setenv("TPU_SPMV_NO_PATTERN", "1")
    B = CSRMatrix(A.num_rows, A.num_cols, A.values, A.col_indices,
                  A.row_ptrs)
    r_f32 = pagerank(B, device=CPU)
    assert isinstance(r_f32.plan, WindowEllPlan) and not r_f32.plan.pat
    assert r_pat.converged and r_f32.converged
    assert r_pat.iterations == r_f32.iterations
    assert np.abs(r_pat.ranks_host() - r_f32.ranks_host()).max() < 1e-6


def test_non_factorable_matrix_still_works():
    """Row-normalised values defeat the pattern detection; the dispatch
    serves the f32 plan."""
    rng = RandomGenerator(42)
    n = 400
    dense = np.abs(rng.dense_matrix(n, n, 0.02))
    np.fill_diagonal(dense, 0.0)
    rs = dense.sum(axis=1, keepdims=True)
    dense = np.divide(dense, rs, out=np.zeros_like(dense), where=rs > 0)
    A = CSRMatrix.from_dense(dense.astype(np.float32))
    assert column_scale_factor(A) is None
    res = pagerank(A, device=CPU)
    assert res.error_code == 0 and res.ranks is not None
    assert isinstance(res.plan, WindowEllPlan) and not res.plan.pat


@pytest.mark.parametrize("case, tolerance", [
    ("edges-2000", 1e-6), ("edges-2000", 0.0), ("edges-500", 1e-6),
    ("edges-500", 0.0), ("demo-60", 1e-6), ("demo-60", 0.0),
    ("web-2048", 1e-6), ("web-2048-merge", 0.0)])
def test_ranks_and_iterations_match_jax(absorb_helper, case, tolerance):
    if case.startswith("edges"):
        n = int(case.split("-")[1])
        A = column_normalized(np.random.default_rng(n), n, 8 * n)
    elif case == "demo-60":
        A = column_normalized_adjacency(RandomGenerator(7), 60)
    else:
        A = transition_matrix(web_graph_csr(RandomGenerator(42), 2048, 2048,
                                            avg_nnz=15))
    kt = KernelType.MERGE_PATH if case.endswith("merge") \
        else KernelType.VECTOR_CSR
    cfg = PageRankConfig(max_iterations=30, tolerance=tolerance,
                         kernel_type=kt)
    res = pagerank(A, cfg, device=CPU)
    jres = tpu_spmv.pagerank(to_jax(A), tpu_spmv.PageRankConfig(
        max_iterations=30, tolerance=tolerance,
        kernel_type=tpu_spmv.KernelType(int(kt))))
    assert res.error_code == 0 == jres.error_code
    assert isinstance(res.plan, PatternPlan)
    assert res.iterations == jres.iterations
    assert res.converged == jres.converged
    np.testing.assert_allclose(res.ranks_host(), np.asarray(jres.ranks),
                               rtol=1e-4, atol=1e-7)
    assert abs(res.ranks_host().sum() - 1.0) < 1e-4


def test_pagerank_keeps_the_requested_device_cpu():
    A = column_normalized(np.random.default_rng(5), 300, 2400)
    res = pagerank(A, PageRankConfig(max_iterations=3, tolerance=0.0),
                   initial_ranks=torch.full((300,), 1 / 300), device=CPU)
    assert res.ranks.device.type == "cpu" and res.iterations == 3
