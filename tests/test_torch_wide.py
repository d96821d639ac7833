"""The port's composite plans, column strips, the naive SCALAR_CSR plan and
the flat path against the JAX package's (``build_composite`` and
``spmv_composite``, ``tpu_spmv/kernels/window_ell.py:1549-1719``;
``tpu_spmv/kernels/strips.py``; ``tpu_spmv/kernels/scalar.py``; the dispatch's
routes, ``tpu_spmv/spmv.py:137-206``, ``:285-455``).

Host part: both planners must give the same levels, strips and naive plan,
leaf for leaf, and the same flat tail.  Device part: the port's SpMVs on the
CPU (the kernels' plain versions, and the flat path's torch ops) against the
JAX package's in Pallas interpret mode and against the CPU oracle, under
the backward-error row bound ``|y - y_ref|_i <= 1e-5 * max((|A||x|)_i, 1)``.
The routing tests mirror ``tests/test_wide.py`` and ``tests/test_strips.py``:
both dispatches must take the same route for the same matrix and
configuration, under the same cache key.

The JAX planner calls ``_absorb_run_padding``, which its module does not
define; the tests bind the port's copy into the JAX module for their
duration (``monkeypatch``), so no file of the JAX package changes.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import tpu_spmv  # noqa: E402
import tpu_spmv.kernels.strips as jst  # noqa: E402
import tpu_spmv.kernels.window_ell as jwe  # noqa: E402
import tpu_spmv.spmv as jspmv  # noqa: E402
from tpu_spmv.csr import CSRMatrix as JaxCSRMatrix  # noqa: E402
from tpu_spmv.kernels.scalar import pad_x as jax_pad_x  # noqa: E402
from tpu_spmv.kernels.scalar import \
    spmv_csr_scalar as jax_spmv_csr_scalar  # noqa: E402

import tpu_spmv_torch  # noqa: E402
import tpu_spmv_torch.spmv as tspmv  # noqa: E402
from tpu_spmv_torch import (CSRMatrix, DeviceCSR, KernelType,  # noqa: E402
                            PageRankConfig, SpMVConfig)
from tpu_spmv_torch.errors import InvalidFormatError  # noqa: E402
from tpu_spmv_torch.kernels import plan as tplan  # noqa: E402
from tpu_spmv_torch.kernels.reorder import HostReordered  # noqa: E402
from tpu_spmv_torch.kernels import strips as tst  # noqa: E402
from tpu_spmv_torch.kernels import window_ell as twe  # noqa: E402
from tpu_spmv_torch.kernels.scalar import spmv_csr_scalar  # noqa: E402
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


def to_jax(A):
    return JaxCSRMatrix(A.num_rows, A.num_cols, A.values, A.col_indices,
                        A.row_ptrs)


def web(rows=8192, cols=8192, avg=9, seed=42):
    return web_graph_csr(RandomGenerator(seed), rows, cols, avg_nnz=avg)


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


def assert_any_plan_equal(jax_plan, host):
    """A JAX ``WindowEllPlan`` or ``BandedPlan`` against the port's host
    form."""
    if isinstance(jax_plan, jwe.BandedPlan):
        assert isinstance(host, tplan.HostBanded)
        assert tuple(jax_plan.band_rows) == tuple(host.band_rows)
        assert len(jax_plan.plans) == len(host.plans)
        for jp, hp in zip(jax_plan.plans, host.plans):
            assert_plans_equal(jp, hp)
    else:
        assert isinstance(host, tplan.HostPlan)
        assert_plans_equal(jax_plan, host)


def assert_composite_equal(jcp, hc):
    assert isinstance(jcp, jwe.CompositePlan)
    assert isinstance(hc, tplan.HostComposite)
    assert (jcp.num_rows, jcp.num_cols) == (hc.num_rows, hc.num_cols)
    assert len(jcp.plans) == len(hc.plans)
    for jp, hp in zip(jcp.plans, hc.plans):
        assert_plans_equal(jp, hp)
    assert (jcp.tail is None) == (hc.tail is None)
    if hc.tail is not None:
        nnz = jcp.tail.nnz
        assert nnz == hc.tail.nnz
        assert np.array_equal(np.asarray(jcp.tail.values)[:nnz],
                              hc.tail.values)
        assert np.array_equal(np.asarray(jcp.tail.col_indices)[:nnz],
                              hc.tail.col_indices)
        assert np.array_equal(
            np.asarray(jcp.tail.row_ptrs)[:hc.num_rows + 1],
            hc.tail.row_ptrs)


def assert_strips_equal(jsp, hs):
    assert isinstance(jsp, jst.StripPlan)
    assert isinstance(hs, tst.HostStrips)
    assert tuple(jsp.bounds) == tuple(hs.bounds)
    assert len(jsp.plans) == len(hs.plans)
    for jp, hp in zip(jsp.plans, hs.plans):
        assert_any_plan_equal(jp, hp)


def assert_row_bound(y, y_ref, A, x):
    diff = np.abs(np.asarray(y, np.float32) - np.asarray(y_ref, np.float32))
    bound = ROW_TOL * np.maximum(abs_row_scale(A, x), 1.0)
    assert np.all(diff <= bound), float(np.max(diff - bound))


def set_max_groups(monkeypatch, cap: int) -> None:
    monkeypatch.setattr(jwe, "MAX_GROUPS", cap)
    monkeypatch.setattr(tplan, "MAX_GROUPS", cap)


def reject_build_auto(monkeypatch) -> None:
    """Both dispatches' ``build_auto`` rejects every matrix (the guard
    rejection of ``tests/test_strips.py``), and the port's K4 rule
    (``spmv.merge_route``) declines every matrix, as the JAX dispatch,
    which has no K4, does."""
    def boom(*a, **k):
        raise jwe.WindowEllOverflow("forced guard rejection")

    def boom_port(*a, **k):
        raise tplan.WindowEllOverflow("forced guard rejection")

    monkeypatch.setattr(jwe, "build_auto", boom)
    monkeypatch.setattr(tspmv, "build_auto", boom_port)
    monkeypatch.setattr(tspmv, "merge_route", lambda *a, **k: False)


def wide_cols_matrix(cols: int, rows: int = 1024, k: int = 6):
    """``rows`` rows of ``k`` random columns of ``cols``
    (``tests/test_wide.py``'s ``test_dispatch_beyond_single_vmem_block``)."""
    r = RandomGenerator(42).rng
    ca = np.sort(r.integers(0, cols, (rows, k), dtype=np.int32), axis=1)
    va = r.random((rows, k)).astype(np.float32)
    rp = np.arange(rows + 1, dtype=np.int32) * k
    return CSRMatrix(rows, cols, va.reshape(-1), ca.reshape(-1), rp)


# ---- composite plans ----

@pytest.mark.parametrize("tail", [False, True], ids=["levels", "tail"])
def test_composite_plan_and_spmv_match_jax(absorb_helper, monkeypatch, tail):
    """Two levels of the web graph; with the cap lowered to the first
    level's groups, one level and the flat tail."""
    A = web()
    x = RandomGenerator(7).vector(A.num_cols)
    hc = tplan.build_composite(A, step_groups=8)
    assert len(hc.plans) == 2 and hc.tail is None
    if tail:
        set_max_groups(monkeypatch, hc.plans[0].n_groups)
        hc = tplan.build_composite(A, step_groups=8)
        assert len(hc.plans) == 1 and hc.tail is not None
        assert hc.tail.nnz + hc.plans[0].occupancy * hc.plans[0].n_groups \
            * 1024 == pytest.approx(A.nnz)
    jcp = jwe.build_composite(to_jax(A), step_groups=8)
    assert_composite_equal(jcp, hc)
    cp = twe.composite_from_host(hc, CPU)
    y = twe.spmv_composite(cp, torch.from_numpy(x)).numpy()
    y_jax = np.asarray(jwe.spmv_composite(jcp, jnp.asarray(x)))
    assert y.shape == y_jax.shape == (A.num_rows,)
    assert_row_bound(y, y_jax, A, x)
    assert spmv_matches(y, A, x, rel_tol=ROW_TOL)


def test_composite_stream_bytes_add_levels_tail_and_adds():
    A = web()
    hc = tplan.build_composite(A, step_groups=8)
    cp = twe.composite_from_host(hc, CPU)
    assert cp.stream_bytes == sum(p.stream_bytes for p in cp.plans) \
        + 12 * A.num_rows


# ---- column strips ----

@pytest.mark.parametrize("banded", [False, True], ids=["single", "banded"])
def test_strip_plans_and_spmv_match_jax(absorb_helper, monkeypatch, banded):
    A = web()
    x = RandomGenerator(7).vector(A.num_cols)
    hs = tst.build_strips_host(A, strip_cols=4096, step_groups=8)
    assert hs.bounds == ((0, 4096), (4096, 8192))
    if banded:
        set_max_groups(monkeypatch, hs.plans[0].n_groups - 8)
        hs = tst.build_strips_host(A, strip_cols=4096, step_groups=8)
        assert isinstance(hs.plans[0], tplan.HostBanded)
        assert isinstance(hs.plans[1], tplan.HostPlan)
    fn, jsp = jst.build_strips(to_jax(A), strip_cols=4096, step_groups=8)
    assert_strips_equal(jsp, hs)
    sp = tst.strips_from_host(hs, CPU)
    assert isinstance(sp.plans[0], twe.BandedPlan) == banded
    y = tst.spmv_strips(sp, torch.from_numpy(x)).numpy()
    y_jax = np.asarray(fn(jsp, jnp.asarray(x)))
    assert_row_bound(y, y_jax, A, x)
    assert spmv_matches(y, A, x, rel_tol=ROW_TOL)


def test_empty_strips_are_skipped(absorb_helper):
    """Every nonzero in the first 100 columns of an 8,192-wide matrix: one
    strip of eight (``tests/test_strips.py``)."""
    rows = 256
    ci = np.tile(np.arange(4, dtype=np.int32) * 7, rows)
    rp = np.arange(rows + 1, dtype=np.int32) * 4
    vals = RandomGenerator(3).vector(rows * 4)
    A = CSRMatrix(rows, 8192, vals, ci, rp)
    hs = tst.build_strips_host(A, strip_cols=1024, step_groups=8)
    assert hs.bounds == ((0, 1024),)
    _, jsp = jst.build_strips(to_jax(A), strip_cols=1024, step_groups=8)
    assert_strips_equal(jsp, hs)
    x = RandomGenerator(7).vector(8192)
    sp = tst.strips_from_host(hs, CPU)
    assert spmv_matches(tst.spmv_strips(sp, torch.from_numpy(x)).numpy(), A,
                        x, rel_tol=ROW_TOL)
    empty = CSRMatrix(64, 4096, np.zeros(0, np.float32), np.zeros(0, np.int32),
                      np.zeros(65, np.int32))
    sp = tst.build_strips(empty, strip_cols=1024, step_groups=8, device=CPU)
    y = tst.spmv_strips(sp, torch.ones(4096))
    assert sp.plans == () and y.shape == (64,) and not y.any()
    with pytest.raises(ValueError):
        tst.build_strips_host(A, strip_cols=0)


def test_strip_width_is_the_gather_table_cap():
    assert tst.STRIP_MAX_COLS == tspmv.VMEM_X_MAX_COLS \
        == jst.STRIP_MAX_COLS == jspmv.VMEM_X_MAX_COLS
    assert tspmv.PACKED_MAX_COLS == jspmv.PACKED_MAX_COLS


# ---- the naive plan and the flat path ----

def test_naive_plan_equals_jax(absorb_helper):
    A = RandomGenerator(42).power_law_csr(2048, 1024, avg_nnz=10, alpha=1.6)
    x = RandomGenerator(7).vector(A.num_cols)
    cfg = SpMVConfig(kernel_type=KernelType.SCALAR_CSR, block_size=16)
    res = tpu_spmv_torch.spmv_csr(A, x, cfg, device=CPU)
    assert res.error_code == 0
    assert isinstance(res.plan, twe.WindowEllPlan) and res.plan.n_extra == 0
    jA = to_jax(A)
    fn, (jplan,) = jspmv._resolve_csr_kernel(
        jA, tpu_spmv.KernelType.SCALAR_CSR,
        tpu_spmv.SpMVConfig(kernel_type=tpu_spmv.KernelType.SCALAR_CSR,
                            block_size=16))
    assert fn is jwe.spmv_window_ell
    host = A._plan_cache[("naive", 8)]
    assert host.n_extra == 0 and host.lam is None and host.split_rows is None
    assert_plans_equal(jplan, host)
    y_jax = np.asarray(fn(jplan, jnp.asarray(x)))[:A.num_rows]
    assert_row_bound(res.y_host(), y_jax, A, x)
    assert spmv_matches(res.y_host(), A, x, rel_tol=ROW_TOL)


@pytest.mark.parametrize("shape", [(2048, 1024, 10.0), (300, 500, 0.5)],
                         ids=["power-law", "empty-rows"])
def test_flat_path_matches_jax_and_oracle(shape):
    A = RandomGenerator(42).power_law_csr(*shape, alpha=1.6)
    x = RandomGenerator(7).vector(A.num_cols)
    jdev = to_jax(A).to_device()
    y_jax = np.asarray(jax_spmv_csr_scalar(
        jdev, jax_pad_x(jnp.asarray(x), tplan._bucket(A.num_cols))
    ))[:A.num_rows]
    dev = A.to_device(CPU)
    assert isinstance(dev, DeviceCSR) and dev.nnz == A.nnz
    assert A.to_device(CPU) is dev                 # cached per device
    y = spmv_csr_scalar(dev, torch.from_numpy(x)).numpy()
    assert y.shape == (A.num_rows,)
    assert_row_bound(y, y_jax, A, x)
    assert spmv_matches(y, A, x, rel_tol=ROW_TOL)
    assert np.array_equal(y, spmv_csr_scalar(dev, torch.from_numpy(x)).numpy())


def test_flat_path_edges():
    empty = CSRMatrix(5, 7, np.zeros(0, np.float32), np.zeros(0, np.int32),
                      np.zeros(6, np.int32))
    y = spmv_csr_scalar(empty.to_device(CPU), torch.ones(7))
    assert y.shape == (5,) and not y.any()
    with pytest.raises(ValueError):
        spmv_csr_scalar(empty.to_device(CPU), torch.ones(6))
    bad = CSRMatrix(2, 3, np.ones(2, np.float32), np.array([0, 3], np.int32),
                    np.array([0, 1, 2], np.int32))
    with pytest.raises(InvalidFormatError):
        bad.to_device(CPU)
    bad = CSRMatrix(2, 3, np.ones(2, np.float32), np.array([0, 1], np.int32),
                    np.array([0, 2, 1], np.int32))
    with pytest.raises(InvalidFormatError):
        bad.to_device(CPU)


# ---- routing ----

def test_wide_columns_route_to_composite_as_jax(absorb_helper):
    """Columns past one gather table (``VMEM_X_MAX_COLS``) and within
    ``PACKED_MAX_COLS``: the composite route in both packages, the same
    plan under the same key."""
    A = wide_cols_matrix(tspmv.VMEM_X_MAX_COLS + 4096)
    x = RandomGenerator(7).vector(A.num_cols)
    cfg = SpMVConfig(kernel_type=KernelType.MERGE_PATH, block_size=16)
    res = tpu_spmv_torch.spmv_csr(A, x, cfg, device=CPU)
    jA = to_jax(A)
    jres = tpu_spmv.spmv_csr(jA, x, tpu_spmv.SpMVConfig(
        kernel_type=tpu_spmv.KernelType.MERGE_PATH, block_size=16))
    assert res.error_code == 0 == jres.error_code
    assert isinstance(res.plan, twe.CompositePlan)
    fn, jcp = jA._plan_cache[(int(KernelType.MERGE_PATH), 8, False, None)]
    assert fn is jwe.spmv_composite
    host = A._plan_cache[("host", int(KernelType.MERGE_PATH), 8, False, None)]
    assert not isinstance(host, HostReordered)
    assert_composite_equal(jcp, host)
    assert_row_bound(res.y_host(), np.asarray(jres.y), A, x)
    assert spmv_matches(res.y_host(), A, x, rel_tol=ROW_TOL)


def test_wider_than_packed_cap_routes_to_strips_as_jax(absorb_helper):
    """Past ``PACKED_MAX_COLS``: column strips of ``STRIP_MAX_COLS``
    (``tests/test_strips.py``'s ``test_public_dispatch_wide_cols_correct``)."""
    rows, cap = 64, tspmv.PACKED_MAX_COLS
    step = cap // 4
    ci = np.tile(np.arange(8, dtype=np.int64) * step, rows).astype(np.int32)
    rp = np.arange(rows + 1, dtype=np.int32) * 8
    vals = RandomGenerator(3).vector(rows * 8)
    A = CSRMatrix(rows, cap * 2, vals, ci, rp)
    x = np.zeros(cap * 2, np.float32)
    x[ci.astype(np.int64)] = RandomGenerator(7).vector(len(ci))
    cfg = SpMVConfig(kernel_type=KernelType.VECTOR_CSR, block_size=16)
    res = tpu_spmv_torch.spmv_csr(A, x, cfg, device=CPU)
    jA = to_jax(A)
    jres = tpu_spmv.spmv_csr(jA, x, tpu_spmv.SpMVConfig(
        kernel_type=tpu_spmv.KernelType.VECTOR_CSR, block_size=16))
    assert res.error_code == 0 == jres.error_code
    assert isinstance(res.plan, tst.StripPlan) and len(res.plan.plans) == 4
    key = ("strips", int(KernelType.VECTOR_CSR), 8, None)
    fn, jsp = jA._plan_cache[key]
    assert fn is jst.spmv_strips
    assert_strips_equal(jsp, A._plan_cache[key])
    assert_row_bound(res.y_host(), np.asarray(jres.y), A, x)
    assert spmv_matches(res.y_host(), A, x, rel_tol=ROW_TOL)


def test_guard_rejection_serves_composite_as_jax(absorb_helper, monkeypatch):
    A = RandomGenerator(42).power_law_csr(4096, 1024, avg_nnz=10, alpha=1.6)
    x = RandomGenerator(7).vector(A.num_cols)
    reject_build_auto(monkeypatch)
    kt = KernelType.MERGE_PATH
    cfg = SpMVConfig(kernel_type=kt, block_size=16)
    plan = tspmv.resolve_csr(A, kt, cfg, torch.device(CPU))
    assert isinstance(plan, twe.CompositePlan)
    jA = to_jax(A)
    fn, (jcp,) = jspmv._resolve_csr_kernel(
        jA, tpu_spmv.KernelType(int(kt)),
        tpu_spmv.SpMVConfig(kernel_type=tpu_spmv.KernelType(int(kt)),
                            block_size=16))
    assert fn is jwe.spmv_composite
    assert_composite_equal(jcp, A._plan_cache[("host", int(kt), 8, False,
                                               None)])
    res = tpu_spmv_torch.spmv_csr(A, x, cfg, device=CPU)
    assert res.error_code == 0 and res.plan is plan
    assert spmv_matches(res.y_host(), A, x, rel_tol=ROW_TOL)


@pytest.mark.parametrize("route", ["naive", "flat"])
def test_overflow_retries_as_scalar_csr_as_jax(absorb_helper, monkeypatch,
                                               route):
    """A packed route that overflows everywhere (no composite level packs)
    is served as SCALAR_CSR: its naive plan, or the flat path where that
    overflows too (``tpu_spmv/spmv.py:320-325``, ``:373-396``)."""
    A = RandomGenerator(42).power_law_csr(2048, 1024, avg_nnz=10, alpha=1.6)
    x = RandomGenerator(7).vector(A.num_cols)
    reject_build_auto(monkeypatch)

    def no_level(*a, **k):
        raise tplan.WindowEllOverflow("no composite level packs")

    def no_level_jax(*a, **k):
        raise jwe.WindowEllOverflow("no composite level packs")

    monkeypatch.setattr(tspmv, "build_composite", no_level)
    monkeypatch.setattr(jwe, "build_composite", no_level_jax)
    if route == "flat":
        def no_plan(*a, **k):
            raise tplan.WindowEllOverflow("naive plan overflows")

        def no_plan_jax(*a, **k):
            raise jwe.WindowEllOverflow("naive plan overflows")

        monkeypatch.setattr(tspmv, "build", no_plan)
        monkeypatch.setattr(jwe.WindowEllPlan, "build",
                            staticmethod(no_plan_jax))
    cfg = SpMVConfig(kernel_type=KernelType.MERGE_PATH, block_size=16)
    res = tpu_spmv_torch.spmv_csr(A, x, cfg, device=CPU)
    jA = to_jax(A)
    jres = tpu_spmv.spmv_csr(jA, x, tpu_spmv.SpMVConfig(
        kernel_type=tpu_spmv.KernelType.MERGE_PATH, block_size=16))
    assert res.error_code == 0 == jres.error_code
    if route == "naive":
        assert isinstance(res.plan, twe.WindowEllPlan)
        assert res.plan.n_extra == 0
        assert_plans_equal(jA._plan_cache[("naive", 8)],
                           A._plan_cache[("naive", 8)])
    else:
        assert isinstance(res.plan, DeviceCSR)
        assert jA._plan_cache[("naive", 8)] is None
        assert A._plan_cache[("naive", 8)] is None
    assert_row_bound(res.y_host(), np.asarray(jres.y), A, x)
    assert spmv_matches(res.y_host(), A, x, rel_tol=ROW_TOL)


@pytest.mark.parametrize("cfg", [
    dict(kernel_type=KernelType.ELL_KERNEL),
    dict(kernel_type=KernelType.MERGE_PATH, use_vmem_x=False),
    dict(kernel_type=KernelType.SCALAR_CSR, use_vmem_x=False)],
    ids=["ell-on-csr", "merge-no-vmem-x", "scalar-no-vmem-x"])
def test_flat_routes_match_jax(cfg):
    A = RandomGenerator(42).power_law_csr(2048, 1024, avg_nnz=10, alpha=1.6)
    x = RandomGenerator(7).vector(A.num_cols)
    res = tpu_spmv_torch.spmv_csr(A, x, SpMVConfig(**cfg), device=CPU)
    jcfg = tpu_spmv.SpMVConfig(**{
        k: tpu_spmv.KernelType(int(v)) if k == "kernel_type" else v
        for k, v in cfg.items()})
    jA = to_jax(A)
    fn, _ = jspmv._resolve_csr_kernel(jA, jcfg.kernel_type, jcfg)
    assert fn is jspmv._scalar_entry
    jres = tpu_spmv.spmv_csr(jA, x, jcfg)
    assert res.error_code == 0 == jres.error_code
    assert isinstance(res.plan, DeviceCSR)
    assert_row_bound(res.y_host(), np.asarray(jres.y), A, x)
    assert spmv_matches(res.y_host(), A, x, rel_tol=ROW_TOL)


def test_pagerank_over_a_composite_plan_matches_jax(absorb_helper,
                                                    monkeypatch):
    """PageRank where the single and banded builders reject the matrix: the
    composite (f32 levels, no pattern plan), in both packages."""
    A = transition_matrix(web(6000, 6000, seed=7))
    reject_build_auto(monkeypatch)
    # the JAX package's step width under interpret mode (PageRank takes none)
    monkeypatch.setattr(tspmv.SpMVConfig, "step_groups",
                        property(lambda self: 8))
    cfg = PageRankConfig(max_iterations=8, tolerance=0.0)
    res = tpu_spmv_torch.pagerank(A, cfg, device=CPU)
    jres = tpu_spmv.pagerank(to_jax(A), tpu_spmv.PageRankConfig(
        max_iterations=8, tolerance=0.0))
    assert res.error_code == 0 == jres.error_code
    assert isinstance(res.plan, twe.CompositePlan)
    assert not isinstance(res.plan, PatternPlan)
    assert res.iterations == jres.iterations == 8
    np.testing.assert_allclose(res.ranks_host(), np.asarray(jres.ranks),
                               rtol=1e-4, atol=1e-7)
    assert abs(res.ranks_host().sum() - 1.0) < 1e-4
