"""The port's row-banded plans against the JAX package's (``BandedPlan``,
``build_banded``, ``build_auto``'s banded arms, ``spmv_banded``,
``spmv_pattern_banded``; ``tpu_spmv/kernels/window_ell.py:1722-2004``).

Host part: for the same matrix both planners must give the same bands, leaf
for leaf, with the same ``band_rows``.  The bands come from the v5e guards
both planners keep (``MAX_GROUPS``), so the tests band matrices of at most
8,192 rows by lowering ``MAX_GROUPS`` in both planners for the test's
duration, as ``tests/test_wide.py`` does in the JAX package's own tests.

Device part: the port's banded SpMVs on the CPU (the kernels' plain
versions) against the JAX package's in Pallas interpret mode and against
the CPU oracle, under the backward-error row bound ``|y - y_ref|_i <= 1e-5 *
max((|A||x|)_i, 1)``: the packages sum each row in different orders.  PageRank
over banded plans must match the JAX ``pagerank`` in ranks (rtol 1e-4, atol
1e-7) and iterations.

The JAX planner calls ``_absorb_run_padding``, which its module does not
define; the tests bind the port's copy into the JAX module for their
duration (``monkeypatch``), so no file of the JAX package changes.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import tpu_spmv  # noqa: E402
import tpu_spmv.kernels.window_ell as jwe  # noqa: E402
from tpu_spmv.csr import CSRMatrix as JaxCSRMatrix  # noqa: E402

import tpu_spmv_torch  # noqa: E402
from tpu_spmv_torch import (KernelType, PageRankConfig,  # noqa: E402
                            SpMVConfig)
from tpu_spmv_torch.errors import InvalidFormatError  # noqa: E402
from tpu_spmv_torch.kernels import plan as tplan  # noqa: E402
from tpu_spmv_torch.kernels.reorder import HostReordered  # noqa: E402
from tpu_spmv_torch.kernels import window_ell as twe  # noqa: E402
from tpu_spmv_torch.pagerank import column_scale_factor  # noqa: E402
from tpu_spmv_torch.spmv import PatternPlan  # noqa: E402
from tpu_spmv_torch.utils.testing import (RandomGenerator,  # noqa: E402
                                          abs_row_scale, spmv_matches,
                                          transition_matrix, web_graph_csr)

ROW_TOL = 1e-5
CPU = "cpu"


@pytest.fixture
def absorb_helper(monkeypatch):
    monkeypatch.setattr(jwe, "_absorb_run_padding",
                        tplan._absorb_run_padding, raising=False)


def set_max_groups(monkeypatch, cap: int) -> None:
    """Lower the SMEM group cap in both planners."""
    monkeypatch.setattr(jwe, "MAX_GROUPS", cap)
    monkeypatch.setattr(tplan, "MAX_GROUPS", cap)


def to_jax(A):
    return JaxCSRMatrix(A.num_rows, A.num_cols, A.values, A.col_indices,
                        A.row_ptrs)


def web(rows=6000, cols=2100, seed=42):
    return web_graph_csr(RandomGenerator(seed), rows, cols, avg_nnz=9)


def assert_plans_equal(jax_plan, host_plan):
    for name in tplan.LEAVES:
        a, b = getattr(jax_plan, name), getattr(host_plan, name)
        if a is None or b is None:
            assert a is None and b is None, name
            continue
        a = np.asarray(a)
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    for name in tplan.AUX:
        assert getattr(jax_plan, name) == getattr(host_plan, name), name
    assert jax_plan.occupancy == host_plan.occupancy


def assert_banded_equal(jbp, hb):
    """A JAX ``BandedPlan`` and a port ``HostBanded``: the same bands, leaf
    for leaf, and the same real rows."""
    assert isinstance(jbp, jwe.BandedPlan)
    assert isinstance(hb, tplan.HostBanded)
    assert (jbp.num_rows, jbp.num_cols) == (hb.num_rows, hb.num_cols)
    assert tuple(jbp.band_rows) == tuple(hb.band_rows)
    assert len(jbp.plans) == len(hb.plans)
    for jp, hp in zip(jbp.plans, hb.plans):
        assert_plans_equal(jp, hp)
    assert jbp.n_groups == hb.n_groups and jbp.sup == hb.sup


def assert_row_bound(y, y_ref, A, x):
    diff = np.abs(np.asarray(y, np.float32) - np.asarray(y_ref, np.float32))
    bound = ROW_TOL * np.maximum(abs_row_scale(A, x), 1.0)
    assert np.all(diff <= bound), float(np.max(diff - bound))


def natural_groups(A) -> int:
    """Groups of ``A``'s unbanded plan: a cap under it bands the plan (at
    sup 4096 a transition matrix of 6,000 nodes has two superblocks, each
    over half the plan's groups, so those tests cap just under it)."""
    return tplan.build_auto(A, step_groups=8).n_groups


# ---- the host plans ----

@pytest.mark.parametrize("n_bands", [1, 2, 3])
def test_banded_plans_equal_jax(absorb_helper, n_bands):
    A = web()
    kw = dict(sup=1024, n_bands=n_bands, spill_beta=2.6, step_groups=8)
    hb = tplan.build_banded(A, **kw)
    assert len(hb.plans) == n_bands and sum(hb.band_rows) == A.num_rows
    # the bands share one padded height
    assert len({p.num_rows for p in hb.plans}) == 1
    assert_banded_equal(jwe.build_banded(to_jax(A), **kw), hb)


@pytest.mark.parametrize("n_bands", [2, None], ids=["halved", "adaptive"])
def test_banded_halving_and_adaptive_count_equal_jax(absorb_helper,
                                                     monkeypatch, n_bands):
    """Under a cap a half of the matrix overflows, the bands are halved down
    to single superblocks (``n_bands=2``) or counted from the overflow's
    hints (``None``); both planners alike."""
    A = web(8192, 4000)
    need1 = max(tplan.build(tplan._slice_rows(A, a, a + 1024), sup=1024,
                            step_groups=8).n_groups
                for a in range(0, A.num_rows, 1024))
    set_max_groups(monkeypatch, max(natural_groups(A) // 4, need1))
    hb = tplan.build_banded(A, sup=1024, n_bands=n_bands, step_groups=8)
    assert len(hb.plans) > 2 and sum(hb.band_rows) == A.num_rows
    assert all(p.n_groups <= tplan.MAX_GROUPS for p in hb.plans)
    assert_banded_equal(
        jwe.build_banded(to_jax(A), sup=1024, n_bands=n_bands,
                         step_groups=8), hb)


def test_banded_one_band_is_the_single_plan(absorb_helper):
    """Where the matrix fits, the adaptive build gives one band: the
    single build's plan, and the JAX build's."""
    A = web()
    hb = tplan.build_banded(A, sup=1024, step_groups=8, split_rows=128)
    assert len(hb.plans) == 1 and hb.band_rows == (A.num_rows,)
    single = tplan.build(A, sup=1024, step_groups=8, split_rows=128)
    assert_plans_equal(single, hb.plans[0])
    assert_banded_equal(jwe.build_banded(to_jax(A), sup=1024, step_groups=8,
                                         split_rows=128), hb)


def test_banded_zero_row_matrix(absorb_helper):
    A = tpu_spmv_torch.CSRMatrix(0, 64, np.zeros(0, np.float32),
                                 np.zeros(0, np.int32),
                                 np.zeros(1, np.int32))
    hb = tplan.build_banded(A, sup=1024, n_bands=2, step_groups=8)
    assert len(hb.plans) == 1 and hb.band_rows == (0,)
    assert_banded_equal(jwe.build_banded(to_jax(A), sup=1024, n_bands=2,
                                         step_groups=8), hb)
    y = twe.spmv_banded(twe.banded_from_host(hb, CPU), torch.ones(64))
    assert y.shape == (0,)


def test_inflation_overflow_is_not_halved_f7(absorb_helper):
    """Fault F7 of the JAX planner, not carried over: a band over the
    inflation guard is halved there until its halves slip under the guard's
    4M-slot floor (here four bands at 288x the nonzeros); the port refuses
    the band (halving cannot lift occupancy), so ``build_auto`` tries the
    next height instead.  Both planners still give one plan for the matrix
    through ``build_auto``."""
    rows, cols = 8192, 1 << 20
    ca = np.sort(np.random.default_rng(3).integers(0, cols, (rows, 4)),
                 axis=1).astype(np.int32)
    A = tpu_spmv_torch.CSRMatrix(rows, cols, np.ones(rows * 4, np.float32),
                                 ca.reshape(-1),
                                 np.arange(rows + 1, dtype=np.int32) * 4)
    jbp = jwe.build_banded(to_jax(A), sup=1024, n_bands=2, step_groups=256)
    assert jbp.band_rows == (2048,) * 4
    assert jbp.n_groups * 1024 > 64 * A.nnz           # past the guard's 64x
    with pytest.raises(tplan.WindowEllOverflow, match="inflation"):
        tplan.build_banded(A, sup=1024, n_bands=2, step_groups=256)
    host = tplan.build_auto(A, step_groups=8)
    assert isinstance(host, tplan.HostPlan)
    assert_plans_equal(jwe.build_auto(to_jax(A), step_groups=8)[1], host)


@pytest.mark.parametrize("arm", ["presized", "overflow"])
def test_build_auto_banded_arms_equal_jax(absorb_helper, monkeypatch, arm):
    """``build_auto``'s two banded arms: bands pre-sized from the model's
    group estimate (``choice``), and bands sized from an overflow's hints
    after the single plan trips the lowered cap."""
    A = web(8192, 4000)
    kw = dict(split_rows=128, step_groups=8)
    if arm == "presized":
        kw["choice"] = (1024, tplan.MAX_GROUPS + 1)
    else:
        set_max_groups(monkeypatch, natural_groups(A) // 2)
    host = tplan.build_auto(A, **kw)
    fn, jplan = jwe.build_auto(to_jax(A), **kw)
    assert fn is jwe.spmv_banded
    assert_banded_equal(jplan, host)
    assert len(host.plans) >= 2


# ---- the SpMVs ----

def test_spmv_banded_matches_jax_and_oracle(absorb_helper):
    A = web()
    x = RandomGenerator(7).vector(A.num_cols)
    kw = dict(sup=1024, n_bands=2, spill_beta=2.6, step_groups=8,
              split_rows=128, permute_rows=True)
    bp = twe.banded_from_host(tplan.build_banded(A, **kw), CPU)
    assert bp.plans[0].lam is not None
    y = twe.spmv_banded(bp, torch.from_numpy(x)).numpy()
    y_jax = np.asarray(jwe.spmv_banded(jwe.build_banded(to_jax(A), **kw),
                                       jnp.asarray(x)))
    assert y.shape == y_jax.shape == (A.num_rows,)
    assert_row_bound(y, y_jax, A, x)
    assert spmv_matches(y, A, x, rel_tol=ROW_TOL)


def test_spmv_pattern_banded_matches_jax_and_oracle(absorb_helper):
    A = transition_matrix(web(6000, 6000))
    x = RandomGenerator(7).vector(A.num_cols)
    scale = column_scale_factor(A)
    assert scale is not None
    kw = dict(sup=1024, n_bands=3, step_groups=8, pattern=True)
    bp = twe.banded_from_host(tplan.build_banded(A, **kw), CPU)
    assert all(p.pat for p in bp.plans)
    y = twe.spmv_pattern_banded(bp, torch.from_numpy(scale),
                                torch.from_numpy(x)).numpy()
    y_jax = np.asarray(jwe.spmv_pattern_banded(
        jwe.build_banded(to_jax(A), **kw), jnp.asarray(scale),
        jnp.asarray(x)))
    assert_row_bound(y, y_jax, A, x)
    assert spmv_matches(y, A, x, rel_tol=ROW_TOL)


def test_band_rows_must_partition_the_rows():
    """A stack whose ``band_rows`` cannot reassemble ``num_rows`` is
    refused, as the JAX ``spmv_banded`` refuses it."""
    A = web(3000, 2100)
    bp = twe.banded_from_host(tplan.build_banded(
        A, sup=1024, n_bands=2, step_groups=8), CPU)
    x = torch.from_numpy(RandomGenerator(7).vector(A.num_cols))
    for rows in ((bp.band_rows[0],), (bp.band_rows[0], 1),
                 tuple(p.num_rows for p in bp.plans)):
        bad = twe.BandedPlan(bp.plans, bp.num_rows, bp.num_cols, rows)
        with pytest.raises(InvalidFormatError, match="partition"):
            twe.spmv_banded(bad, x)
    # with no band_rows the bands' own heights must add up (they are
    # padded here, so they do not)
    with pytest.raises(InvalidFormatError):
        twe.spmv_banded(twe.BandedPlan(bp.plans, bp.num_rows, bp.num_cols),
                        x)


def test_banded_stream_bytes_sum_the_bands_and_the_join():
    A = web()
    bp = twe.banded_from_host(tplan.build_banded(
        A, sup=1024, n_bands=3, step_groups=8), CPU)
    assert bp.stream_bytes == sum(p.stream_bytes for p in bp.plans) \
        + 8 * A.num_rows
    one = twe.banded_from_host(tplan.build_banded(
        A, sup=1024, n_bands=1, step_groups=8), CPU)
    assert one.stream_bytes == one.plans[0].stream_bytes


# ---- the dispatch and PageRank ----

@pytest.mark.parametrize("kernel_type", [KernelType.VECTOR_CSR,
                                         KernelType.MERGE_PATH])
def test_dispatch_bands_oversized_plans_as_jax(absorb_helper, monkeypatch,
                                               kernel_type):
    """Under a lowered cap both dispatches serve the matrix by a banded
    plan (``tests/test_wide.py``'s ``test_dispatch_bands_oversized_plans``),
    the port's equal to the JAX one band for band."""
    A = web(8192, 4000)
    x = RandomGenerator(7).vector(A.num_cols)
    set_max_groups(monkeypatch, natural_groups(A) // 2)
    cfg = SpMVConfig(kernel_type=kernel_type, block_size=16)
    res = tpu_spmv_torch.spmv_csr(A, x, cfg, device=CPU)
    jA = to_jax(A)
    jres = tpu_spmv.spmv_csr(jA, x, tpu_spmv.SpMVConfig(
        kernel_type=tpu_spmv.KernelType(int(kernel_type)), block_size=16))
    assert res.error_code == 0 == jres.error_code
    assert isinstance(res.plan, twe.BandedPlan) and len(res.plan.plans) >= 2
    fn, jplan = jA._plan_cache[(int(kernel_type), 8, False, None)]
    assert fn is jwe.spmv_banded
    host = A._plan_cache[("host", int(kernel_type), 8, False, None)]
    assert not isinstance(host, HostReordered)
    assert_banded_equal(jplan, host)
    assert_row_bound(res.y_host(), np.asarray(jres.y), A, x)
    assert spmv_matches(res.y_host(), A, x, rel_tol=ROW_TOL)


def test_pattern_dispatch_serves_a_banded_pattern_plan(absorb_helper,
                                                       monkeypatch):
    A = transition_matrix(web(6000, 6000))
    x = RandomGenerator(7).vector(A.num_cols)
    set_max_groups(monkeypatch, natural_groups(A) - 8)
    cfg = SpMVConfig(kernel_type=KernelType.VECTOR_CSR, pattern=True,
                     block_size=16)
    res = tpu_spmv_torch.spmv_csr(A, x, cfg, device=CPU)
    assert res.error_code == 0
    assert isinstance(res.plan, PatternPlan)
    assert isinstance(res.plan.plan, twe.BandedPlan)
    assert all(p.pat for p in res.plan.plan.plans)
    jA = to_jax(A)
    fn, (jplan, _) = tpu_spmv.spmv._resolve_pattern(
        jA, tpu_spmv.KernelType.VECTOR_CSR,
        tpu_spmv.SpMVConfig(pattern=True, block_size=16))
    assert fn is jwe.spmv_pattern_banded
    assert_banded_equal(jplan, A._plan_cache[("pat", int(KernelType.VECTOR_CSR),
                                              8)])
    assert spmv_matches(res.y_host(), A, x, rel_tol=ROW_TOL)


def interpret_step_width(monkeypatch) -> None:
    """Resolve the port's default step width as the JAX package does under
    Pallas interpret mode (8 groups, ``SpMVConfig.step_groups``): PageRank
    takes no step width, and the port's own default (128 at sup 4096) pads
    each band of these small matrices past the lowered cap."""
    monkeypatch.setattr(tpu_spmv_torch.spmv.SpMVConfig, "step_groups",
                        property(lambda self: 8))


@pytest.mark.parametrize("tolerance", [0.0])
def test_pagerank_over_banded_plans_matches_jax(absorb_helper, monkeypatch,
                                                tolerance):
    A = transition_matrix(web(6000, 6000, seed=7))
    set_max_groups(monkeypatch, natural_groups(A) - 8)
    interpret_step_width(monkeypatch)
    cfg = PageRankConfig(max_iterations=8, tolerance=tolerance)
    res = tpu_spmv_torch.pagerank(A, cfg, device=CPU)
    jres = tpu_spmv.pagerank(to_jax(A), tpu_spmv.PageRankConfig(
        max_iterations=8, tolerance=tolerance))
    assert res.error_code == 0 == jres.error_code
    assert isinstance(res.plan, PatternPlan)
    assert isinstance(res.plan.plan, twe.BandedPlan)
    assert_banded_equal(
        jwe.build_auto(to_jax(A), step_groups=8, pattern=True)[1],
        A._plan_cache[("pat", int(KernelType.VECTOR_CSR), 8)])
    assert res.iterations == jres.iterations
    np.testing.assert_allclose(res.ranks_host(), np.asarray(jres.ranks),
                               rtol=1e-4, atol=1e-7)
    assert abs(res.ranks_host().sum() - 1.0) < 1e-4
