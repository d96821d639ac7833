"""The port's ELL format and ELL dispatch against the JAX package's
(``tpu_spmv/ell.py``, ``tpu_spmv/ops/cpu_reference.py:43-58``,
``tpu_spmv/bandwidth.py:110-137``, ``spmv_ell`` and
``_resolve_ell_kernel``, ``tpu_spmv/spmv.py:470-591``).

The container is held equal to the JAX one array for array and byte for
byte, the CPU oracle bit for bit.  ``spmv_ell`` is checked on each route
(a single window-ELL plan, the pattern plan of a column-scaled matrix,
column strips, the slot-major flat path) three ways: against the JAX
``spmv_ell`` (Pallas in interpret mode) under the row bound
``|Δy|_i <= 1e-5 * max((|A||x|)_i, 1)``, against the CPU oracle, and by the
plan type that serves it.  The two packages pick different step widths (the
JAX one 8 under interpret mode, the port 256), so their plans differ in
padding, not in their sums' terms.

The JAX planner calls ``_absorb_run_padding``, which its module does not
define; the tests bind the port's copy into the JAX module for their
duration (``monkeypatch``), so no file of the JAX package changes.
"""

import io

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import tpu_spmv  # noqa: E402
import tpu_spmv.kernels.window_ell as jwe  # noqa: E402
import tpu_spmv.spmv as jspmv  # noqa: E402
from tpu_spmv.bandwidth import _ell_bytes as jax_ell_bytes  # noqa: E402
from tpu_spmv.csr import CSRMatrix as JaxCSRMatrix  # noqa: E402
from tpu_spmv.ell import ELLMatrix as JaxELLMatrix  # noqa: E402

import tpu_spmv_torch  # noqa: E402
import tpu_spmv_torch.spmv as tspmv  # noqa: E402
from tpu_spmv_torch import (DeviceELL, ELLMatrix, SpMVConfig,  # noqa: E402
                            SpMVError)
from tpu_spmv_torch.bandwidth import (_ell_bytes,  # noqa: E402
                                      compute_bandwidth_ell)
from tpu_spmv_torch.kernels import plan as tplan  # noqa: E402
from tpu_spmv_torch.kernels import window_ell as twe  # noqa: E402
from tpu_spmv_torch.kernels.ell_kernel import spmv_ell_device  # noqa: E402
from tpu_spmv_torch.kernels.strips import StripPlan  # noqa: E402
from tpu_spmv_torch.ops import spmv_cpu_ell  # noqa: E402
from tpu_spmv_torch.spmv import PatternPlan, launches_per_call  # noqa: E402
from tpu_spmv_torch.utils.testing import (RandomGenerator,  # noqa: E402
                                          abs_row_scale, spmv_matches,
                                          stencil_csr)

ROW_TOL = 1e-5
CPU = "cpu"


@pytest.fixture
def absorb_helper(monkeypatch):
    monkeypatch.setattr(jwe, "_absorb_run_padding",
                        tplan._absorb_run_padding, raising=False)


def to_jax_csr(A):
    return JaxCSRMatrix(A.num_rows, A.num_cols, A.values, A.col_indices,
                        A.row_ptrs)


def to_jax_ell(E):
    return JaxELLMatrix(E.num_rows, E.num_cols, E.max_nnz_per_row, E.values,
                        E.col_indices)


def assert_row_bound(y, y_ref, A, x):
    diff = np.abs(np.asarray(y, np.float32) - np.asarray(y_ref, np.float32))
    bound = ROW_TOL * np.maximum(abs_row_scale(A, x), 1.0)
    assert np.all(diff <= bound), float(np.max(diff - bound))


MATRICES = {
    "power-law": lambda: RandomGenerator(42).power_law_csr(1500, 900, 10.0,
                                                           1.6),
    "empty rows": lambda: RandomGenerator(5).csr(60, 40, 0.05),
    "stencil": lambda: stencil_csr(24),
}


def ell_of(name):
    return ELLMatrix.from_csr(MATRICES[name]())


# ---- the container ----

@pytest.mark.parametrize("name", list(MATRICES))
def test_from_csr_and_to_csr_match_jax(name):
    A = MATRICES[name]()
    E = ELLMatrix.from_csr(A)
    J = JaxELLMatrix.from_csr(to_jax_csr(A))
    assert (E.num_rows, E.num_cols, E.max_nnz_per_row) \
        == (J.num_rows, J.num_cols, J.max_nnz_per_row)
    assert np.array_equal(E.values, J.values)
    assert np.array_equal(E.col_indices, J.col_indices)
    assert E.nnz == J.nnz == A.nnz
    back, jback = E.to_csr(), J.to_csr()
    for f in ("values", "col_indices", "row_ptrs"):
        assert np.array_equal(getattr(back, f), getattr(jback, f)), f
    # the JAX container's arrays, taken unchanged
    carried = ELLMatrix(J.num_rows, J.num_cols, J.max_nnz_per_row,
                        J.values, J.col_indices)
    assert np.array_equal(carried.values, E.values)


def test_dense_element_and_padding_match_jax():
    rng = RandomGenerator(11)
    dense = rng.dense_matrix(30, 25, 0.2)
    E = tpu_spmv_torch.ell_from_dense(dense)
    J = tpu_spmv.ell_from_dense(dense)
    assert np.array_equal(E.to_dense(), dense)
    assert np.array_equal(E.to_dense(), J.to_dense())
    pad = E.col_indices < 0
    assert np.all(E.col_indices[pad] == -1) and np.all(E.values[pad] == 0)
    for r, c in [(0, 0), (3, 7), (29, 24), (-1, 0), (30, 0), (0, 25)]:
        assert E.get_element(r, c) == J.get_element(r, c)
    for r, c in zip(*np.nonzero(dense)):
        assert E.get_element(int(r), int(c)) == dense[r, c]
    flat = tpu_spmv_torch.ell_from_dense(dense.reshape(-1), 30, 25)
    assert np.array_equal(flat.values, E.values)
    assert tpu_spmv_torch.ell_index(3, 2, 30) == tpu_spmv.ell_index(3, 2, 30)
    c = tpu_spmv_torch.ell_create(4, 5, 3)
    assert np.all(c.col_indices == -1) and c.values.size == 12


@pytest.mark.parametrize("name", ["power-law", "empty rows"])
def test_serialized_bytes_and_files_cross_packages(name, tmp_path):
    """The bytes the port writes are the JAX package's; a file either
    package writes loads in the other, and back."""
    E = ell_of(name)
    J = to_jax_ell(E)
    mine, theirs = io.BytesIO(), io.BytesIO()
    E.serialize(mine)
    J.serialize(theirs)
    assert mine.getvalue() == theirs.getvalue()
    jpath, ppath = str(tmp_path / "jax.ell"), str(tmp_path / "port.ell")
    tpu_spmv.ell_serialize(J, jpath)
    assert tpu_spmv_torch.ell_serialize(ELLMatrix.deserialize(jpath),
                                        ppath) == SpMVError.SUCCESS
    back = JaxELLMatrix.deserialize(ppath)
    assert np.array_equal(back.values, J.values)
    assert np.array_equal(back.col_indices, J.col_indices)
    with open(jpath, "rb") as f, open(ppath, "rb") as g:
        assert f.read() == g.read()
    with open(str(tmp_path / "short.ell"), "wb") as f:
        f.write(mine.getvalue()[:20])
    with pytest.raises(tpu_spmv_torch.FileIOError):
        ELLMatrix.deserialize(str(tmp_path / "short.ell"))


def test_device_form_and_from_device():
    """``DeviceELL`` on the CPU: slot-major ``(slots, rows_pad)``, rows
    padded to the JAX bucket with ``col=-1, value=0``; ``from_device``
    crops it back to the host layout."""
    E = ell_of("power-law")
    J = to_jax_ell(E)
    d = E.to_device(CPU)
    jd = J.to_device()
    assert isinstance(d, DeviceELL) and d.device.type == "cpu"
    assert tuple(d.values.shape) == tuple(jd.values.shape) \
        == (E.max_nnz_per_row, d.rows_pad)
    assert np.array_equal(d.values.numpy(), np.asarray(jd.values))
    assert np.array_equal(d.col_indices.numpy(), np.asarray(jd.col_indices))
    assert E.to_device(CPU) is d          # cached per device
    host = ELLMatrix.create(E.num_rows, E.num_cols, E.max_nnz_per_row)
    host.from_device(d)
    assert np.array_equal(host.values, E.values)
    assert np.array_equal(host.col_indices, E.col_indices)
    with pytest.raises(tpu_spmv_torch.InvalidDimensionError):
        ELLMatrix.create(3, 3, 1).from_device(d)
    E.free_device()
    assert not E._plan_cache and E._device_cache is None
    bad = ELLMatrix(2, 3, 1, np.ones(2, np.float32),
                    np.array([0, 3], np.int32))
    with pytest.raises(tpu_spmv_torch.InvalidFormatError):
        bad.to_device(CPU)


@pytest.mark.parametrize("name", list(MATRICES))
def test_spmv_cpu_ell_bit_for_bit(name):
    E = ell_of(name)
    x = RandomGenerator(7).vector(E.num_cols)
    y = spmv_cpu_ell(E, x)
    assert np.array_equal(y, tpu_spmv.spmv_cpu_ell(to_jax_ell(E), x))
    # rows add in slot order, as the CSR oracle adds its columns
    assert np.array_equal(y, tpu_spmv_torch.spmv_cpu_csr(E.to_csr(), x))


def test_compute_bandwidth_ell_matches_jax():
    shape = (262144, 262144, 5)
    assert _ell_bytes(*shape) == jax_ell_bytes(*shape)
    m = compute_bandwidth_ell(*shape, 0.01, 3350.0)
    assert m.achieved_gb_s == pytest.approx(jax_ell_bytes(*shape) / 1e-5
                                            / 1e9)
    assert m.efficiency == pytest.approx(m.achieved_gb_s / 3350.0)
    assert compute_bandwidth_ell(*shape, 0.0, 3350.0).achieved_gb_s == 0.0


# ---- the dispatch ----

def strip_matrix(rows=64, k=6):
    """Columns in (VMEM_X_MAX_COLS, PACKED_MAX_COLS]: the strips route."""
    cols = tspmv.VMEM_X_MAX_COLS + (1 << 19)
    r = RandomGenerator(42).rng
    ca = np.stack([np.sort(r.choice(cols, k, replace=False))
                   for _ in range(rows)]).astype(np.int32)
    va = r.uniform(-2, 2, (rows, k)).astype(np.float32)
    rp = np.arange(rows + 1, dtype=np.int32) * k
    return tpu_spmv_torch.CSRMatrix(rows, cols, va.reshape(-1),
                                    ca.reshape(-1), rp)


def flat_matrix(rows=64, k=5):
    """Columns past PACKED_MAX_COLS: the flat ELL path."""
    cols = tspmv.PACKED_MAX_COLS + 4096
    r = RandomGenerator(43).rng
    ca = np.stack([np.sort(r.choice(cols, k, replace=False))
                   for _ in range(rows)]).astype(np.int32)
    va = r.uniform(-2, 2, (rows, k)).astype(np.float32)
    rp = np.arange(rows + 1, dtype=np.int32) * k
    return tpu_spmv_torch.CSRMatrix(rows, cols, va.reshape(-1),
                                    ca.reshape(-1), rp)


def column_scaled(A):
    """``A``'s structure with every stored value of column j equal to a
    column scale in [0.5, 2)."""
    scale = RandomGenerator(7).rng.uniform(0.5, 2.0, A.num_cols) \
        .astype(np.float32)
    return tpu_spmv_torch.CSRMatrix(A.num_rows, A.num_cols,
                                    scale[A.col_indices], A.col_indices,
                                    A.row_ptrs)


ROUTES = {
    "plan": (lambda: MATRICES["power-law"](), False, twe.WindowEllPlan),
    "pattern": (lambda: column_scaled(stencil_csr(40)), True, PatternPlan),
    "strips": (strip_matrix, False, StripPlan),
    "flat": (flat_matrix, False, DeviceELL),
}


@pytest.mark.parametrize("route", list(ROUTES))
def test_spmv_ell_route_matches_jax(absorb_helper, route):
    make, pattern, kind = ROUTES[route]
    A = make()
    E = ELLMatrix.from_csr(A)
    x = np.zeros(A.num_cols, np.float32)
    x[A.col_indices] = RandomGenerator(9).vector(A.nnz)
    cfg = SpMVConfig(pattern=pattern)
    res = tpu_spmv_torch.spmv_ell(E, x, cfg, device=CPU)
    jres = tpu_spmv.spmv_ell(to_jax_ell(E), x,
                             tpu_spmv.SpMVConfig(pattern=pattern))
    assert res.error_code == 0 == jres.error_code
    assert isinstance(res.plan, kind), type(res.plan)
    y, y_jax = res.y_host(), np.asarray(jres.y)
    assert y.shape == y_jax.shape == (A.num_rows,)
    assert_row_bound(y, y_jax, A, x)
    assert spmv_matches(y, A, x, rel_tol=ROW_TOL)
    folds = launches_per_call(res.plan)["fold"]
    assert folds == 0 if route == "flat" else folds > 0
    again = tpu_spmv_torch.spmv_ell(E, x, cfg, device=CPU)
    assert again.plan is res.plan and torch.equal(again.y, res.y)


def test_routes_follow_the_jax_resolver(absorb_helper):
    """The JAX resolver takes the same route on each matrix: its packed
    plan, the pattern wrapper, its strips, its flat entry."""
    for route, (make, pattern, _) in ROUTES.items():
        J = to_jax_ell(ELLMatrix.from_csr(make()))
        fn, _ = jspmv._resolve_ell_kernel(
            J, tpu_spmv.SpMVConfig(pattern=pattern))
        name = getattr(fn, "__name__", "")
        want = {"plan": "spmv_window_ell", "pattern": "spmv_pattern",
                "strips": "spmv_strips", "flat": "<lambda>"}[route]
        assert name == want, (route, name)


def test_overflowing_single_plan_goes_flat_and_is_cached(monkeypatch):
    E = ell_of("power-law")
    calls = []

    def overflow(*a, **k):
        calls.append(1)
        raise tplan.WindowEllOverflow("no layout fits")

    monkeypatch.setattr(tspmv, "build", overflow)
    x = RandomGenerator(7).vector(E.num_cols)
    for _ in range(2):
        res = tpu_spmv_torch.spmv_ell(E, x, device=CPU)
        assert res.error_code == 0 and isinstance(res.plan, DeviceELL)
    assert calls == [1] and E._plan_cache["plan"] is None
    assert spmv_matches(res.y_host(), E.to_csr(), x, rel_tol=ROW_TOL)


def test_pattern_and_plain_calls_get_different_plans():
    """The plan-cache key carries the pattern flag (the F3/F6 class of
    fault): on one column-scaled ELL, a pattern call is served by the
    pattern plan, a plain call by the f32 plan, in either order."""
    A = column_scaled(stencil_csr(40))
    x = RandomGenerator(7).vector(A.num_cols)
    for first in (True, False):
        E = ELLMatrix.from_csr(A)
        order = (first, not first)
        plans = {p: tpu_spmv_torch.spmv_ell(E, x, SpMVConfig(pattern=p),
                                            device=CPU).plan for p in order}
        assert isinstance(plans[True], PatternPlan)
        assert isinstance(plans[False], twe.WindowEllPlan)
        assert not plans[False].pat and plans[True].plan.pat
        assert E._plan_cache[("plan", CPU)] is plans[False]


@pytest.mark.parametrize("case", ["none", "dimension", "zero rows",
                                  "no card"])
def test_error_codes_match_jax(case, monkeypatch):
    E = ell_of("power-law")
    x = RandomGenerator(7).vector(E.num_cols)
    if case == "none":
        want = SpMVError.INVALID_ARGUMENT
        res = tpu_spmv_torch.spmv_ell(None, x, device=CPU)
        jres = tpu_spmv.spmv_ell(None, x)
    elif case == "dimension":
        want = SpMVError.INVALID_DIMENSION
        res = tpu_spmv_torch.spmv_ell(E, x[:-1], device=CPU)
        jres = tpu_spmv.spmv_ell(to_jax_ell(E), x[:-1])
        assert tpu_spmv_torch.spmv_ell(E, x, vec_size=3, device=CPU) \
            .error_code == want
    elif case == "zero rows":
        want = SpMVError.SUCCESS
        Z = ELLMatrix.create(0, 5, 2)
        res = tpu_spmv_torch.spmv_ell(Z, np.ones(5, np.float32), device=CPU)
        jres = tpu_spmv.spmv_ell(to_jax_ell(Z), np.ones(5, np.float32))
        assert res.y.shape == (0,) == np.asarray(jres.y).shape
    else:
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        res = tpu_spmv_torch.spmv_ell(E, x)
        assert res.error_code == SpMVError.DEVICE_ALLOC and res.y is None
        assert not E._plan_cache       # nothing planned, nothing uploaded
        return
    assert res.error_code == int(want) == jres.error_code


def test_flat_ell_path_is_deterministic_and_masks_padding():
    """The flat path on the CPU: padding masked even where x[0] is not
    finite (a pad slot gathers x[0]), the same bits call after call, an
    empty matrix all zeros; x too short refused."""
    dense = RandomGenerator(5).dense_matrix(60, 40, 0.1)
    dense[:, 0] = 0.0                     # no stored nonzero reads x[0]
    E = ELLMatrix.from_dense(dense)
    assert (E.col_indices < 0).any()
    x = RandomGenerator(7).vector(E.num_cols)
    x[0] = np.inf
    d = E.to_device(CPU)
    y = spmv_ell_device(d, torch.from_numpy(x))
    assert torch.equal(y, spmv_ell_device(d, torch.from_numpy(x)))
    assert y.shape == (E.num_rows,) and torch.isfinite(y).all()
    assert spmv_matches(y.numpy(), E.to_csr(), x, rel_tol=ROW_TOL)
    Z = ELLMatrix.create(7, 4, 0).to_device(CPU)
    assert torch.equal(spmv_ell_device(Z, torch.ones(4)), torch.zeros(7))
    with pytest.raises(ValueError):
        spmv_ell_device(d, torch.from_numpy(x[:-1]))
    assert launches_per_call(d) == dict.fromkeys(
        ("fold", "section_epilogue", "unpermute", "permute_chunks",
         "merge_csr", "merge_spmm"), 0)


def test_measure_refuses_the_cpu():
    """``measure=True`` times on the card only (CUDA events); on a CPU
    device it raises, as ``spmv_csr`` does."""
    E = ell_of("power-law")
    with pytest.raises(RuntimeError):
        tpu_spmv_torch.spmv_ell(E, RandomGenerator(7).vector(E.num_cols),
                                measure=True, device=CPU)
