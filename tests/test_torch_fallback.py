"""What the dispatch does when a route runs out of device memory, beside
the JAX package's fallback ladder (``_run_with_fallback``,
``tpu_spmv/spmv.py:246-282``, and the ELL retry, ``:502-531``), under
injected failures.

The port retries nothing: a route that raises ``torch.OutOfMemoryError``
(the CUDA counterpart of the VMEM or HBM exhaustion the plan-time guards
cannot see) ends the call with ``EXECUTION``, logged as a warning, and no
other route serves it.  That is the code the JAX ladder ends with once it
has no rung left (``jax.errors.JaxRuntimeError`` injected into every
route), and the route that failed is the one the JAX dispatch tried first.
A kernel's build failure, a library bug or a caller bug propagates, as
``tests/test_device_errors.py::test_library_bug_not_masked`` asks of the
JAX side; a launch failure is ``EXECUTION`` without a retry.
"""

import logging

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import tpu_spmv.kernels.window_ell as jwe  # noqa: E402
import tpu_spmv.spmv as jspmv  # noqa: E402
from tpu_spmv.csr import CSRMatrix as JaxCSRMatrix  # noqa: E402
from tpu_spmv.ell import ELLMatrix as JaxELLMatrix  # noqa: E402

import tpu_spmv_torch.spmv as tspmv  # noqa: E402
from tpu_spmv_torch import (CSRMatrix, DeviceCSR, DeviceELL,  # noqa: E402
                            ELLMatrix, KernelType, SpMVConfig, SpMVError,
                            spmv_csr, spmv_ell)
from tpu_spmv_torch.errors import DeviceException  # noqa: E402
from tpu_spmv_torch.kernels import plan as tplan  # noqa: E402
from tpu_spmv_torch.utils.testing import (RandomGenerator,  # noqa: E402
                                          spmv_matches)

ROW_TOL = 1e-5
CPU = "cpu"
MERGE = SpMVConfig(kernel_type=KernelType.MERGE_PATH)
EXECUTION = int(SpMVError.EXECUTION)


@pytest.fixture(autouse=True)
def absorb_helper(monkeypatch):
    monkeypatch.setattr(jwe, "_absorb_run_padding",
                        tplan._absorb_run_padding, raising=False)


def narrow():
    return RandomGenerator(42).power_law_csr(512, 384, 6.0, 1.6)


def wide(cols=1 << 18):
    """A few nonzeros a row over ``cols`` columns."""
    rng = np.random.default_rng(3)
    rows, per_row = 256, 4
    col = np.sort(rng.integers(0, cols, (rows, per_row)), axis=1)
    vals = rng.uniform(-2.0, 2.0, rows * per_row).astype(np.float32)
    ptr = np.arange(rows + 1, dtype=np.int32) * per_row
    return CSRMatrix(rows, cols, vals, col.reshape(-1).astype(np.int32), ptr)


def to_jax(A):
    return JaxCSRMatrix(A.num_rows, A.num_cols, A.values, A.col_indices,
                        A.row_ptrs)


def route(plan) -> str:
    return "flat" if isinstance(plan, (DeviceCSR, DeviceELL)) else "packed"


def oom() -> torch.OutOfMemoryError:
    return torch.OutOfMemoryError("CUDA out of memory (injected)")


def fail_port(monkeypatch, failing: set, error=None) -> list:
    """The port's ``run_plan`` raising ``error`` (an injected out-of-memory
    error by default) on the routes in ``failing``; returns the list of
    routes tried, filled as the call goes."""
    tried, real = [], tspmv.run_plan

    def run(plan, x):
        tried.append(route(plan))
        if tried[-1] in failing:
            raise error if error is not None else oom()
        return real(plan, x)

    monkeypatch.setattr(tspmv, "run_plan", run)
    return tried


def recording(tried: list, name: str):
    """A route's callable that records ``name`` into ``tried`` and raises
    the JAX runtime's resource exhaustion."""
    def call(*args):
        tried.append(name)
        raise jax.errors.JaxRuntimeError("RESOURCE_EXHAUSTED: injected")
    return call


def fail_jax_csr(monkeypatch) -> list:
    """Every route of the JAX dispatch raising ``JaxRuntimeError``: the
    packed callable, the strips the ladder resolves, the flat entry;
    returns the routes tried."""
    tried = []
    flat = recording(tried, "flat")
    resolve, strips = jspmv._resolve_csr_kernel, jspmv._resolve_strips

    def resolve_csr(A, kt, cfg):
        fn, args = resolve(A, kt, cfg)
        return (fn if fn is flat else recording(tried, "packed")), args

    def resolve_strips(*args, **kw):
        got = strips(*args, **kw)
        return None if got is None else (
            recording(tried, "strips"), got[1])

    monkeypatch.setattr(jspmv, "_scalar_entry", flat)
    monkeypatch.setattr(jspmv, "_resolve_csr_kernel", resolve_csr)
    monkeypatch.setattr(jspmv, "_resolve_strips", resolve_strips)
    return tried


def oom_warnings(caplog) -> list:
    return [r for r in caplog.records
            if "ran out of device memory" in r.message]


@pytest.mark.parametrize("matrix,kernel_type", [
    (narrow, KernelType.MERGE_PATH),
    (narrow, KernelType.SCALAR_CSR),
    (wide, KernelType.MERGE_PATH),
], ids=["narrow-packed", "narrow-naive", "wide-packed"])
def test_csr_oom_ends_the_call(monkeypatch, caplog, matrix, kernel_type):
    """An out-of-memory error on the packed route (the merge plan, the
    naive SCALAR_CSR plan) is ``EXECUTION``, logged once, with no other
    route tried; the JAX ladder starts on the same route and ends on the
    same code once every rung has failed."""
    A = matrix()
    x = RandomGenerator(7).vector(A.num_cols)
    tried = fail_port(monkeypatch, {"packed", "flat"})
    with caplog.at_level(logging.WARNING, logger="tpu_spmv_torch"):
        res = spmv_csr(A, x, SpMVConfig(kernel_type=kernel_type), device=CPU)
    jtried = fail_jax_csr(monkeypatch)
    jres = jspmv.spmv_csr(to_jax(A), x, jspmv.SpMVConfig(
        kernel_type=jspmv.KernelType(int(kernel_type))))
    assert tried == ["packed"] and jtried[0] == "packed"
    assert jtried[-1] == "flat"
    assert res.error_code == jres.error_code == EXECUTION
    assert res.y is None and res.plan is None and jres.y is None
    warned = oom_warnings(caplog)
    assert len(warned) == 1 and "injected" in warned[0].message
    assert "retry" not in warned[0].message


def test_flat_route_oom_is_execution_as_jax(monkeypatch):
    """ELL_KERNEL on a CSR is served flat: its failure is ``EXECUTION``,
    as the JAX dispatch's."""
    A = narrow()
    x = RandomGenerator(7).vector(A.num_cols)
    cfg = SpMVConfig(kernel_type=KernelType.ELL_KERNEL)
    tried = fail_port(monkeypatch, {"flat"})
    res = spmv_csr(A, x, cfg, device=CPU)
    jtried = fail_jax_csr(monkeypatch)
    jres = jspmv.spmv_csr(to_jax(A), x, jspmv.SpMVConfig(
        kernel_type=jspmv.KernelType.ELL_KERNEL))
    assert tried == jtried == ["flat"]
    assert res.error_code == jres.error_code == EXECUTION


@pytest.mark.parametrize("matrix,want", [
    (narrow, "packed"), (lambda: wide((1 << 21) + 128), "flat"),
], ids=["packed", "flat"])
def test_ell_oom_ends_the_call(monkeypatch, caplog, matrix, want):
    """``spmv_ell``: an out-of-memory error on the route it resolves (the
    single plan; past ``PACKED_MAX_COLS`` the slot-major flat ELL path) is
    ``EXECUTION`` with no other route tried; the JAX route starts there
    and ends on the same code once its retry has failed too."""
    A = ELLMatrix.from_csr(matrix())
    x = RandomGenerator(7).vector(A.num_cols)
    tried = fail_port(monkeypatch, {"packed", "flat"})
    with caplog.at_level(logging.WARNING, logger="tpu_spmv_torch"):
        res = spmv_ell(A, x, device=CPU)
    jtried = []
    monkeypatch.setattr(jspmv, "spmv_window_ell",
                        recording(jtried, "packed"))
    monkeypatch.setattr(jspmv, "_ell_entry",
                        recording(jtried, "flat"))
    JA = JaxELLMatrix(A.num_rows, A.num_cols, A.max_nnz_per_row, A.values,
                      A.col_indices)
    jres = jspmv.spmv_ell(JA, x)
    assert tried == [want] and jtried[0] == want
    assert res.error_code == jres.error_code == EXECUTION
    assert res.y is None and res.plan is None
    assert len(oom_warnings(caplog)) == 1


@pytest.mark.parametrize("error", [
    RuntimeError("building libtpu_spmv_kernels.so failed (exit 1)"),
    NotImplementedError("library bug"),
    ValueError("window-ELL plan arrays must be contiguous"),
], ids=["build", "library-bug", "caller-bug"])
def test_other_errors_are_never_retried(monkeypatch, caplog, error):
    """A kernel that fails to build, a library bug or a caller bug raises
    from the route that met it; no other route runs and nothing is logged
    (the JAX package's ``test_library_bug_not_masked``)."""
    A = wide()
    x = RandomGenerator(7).vector(A.num_cols)
    tried = fail_port(monkeypatch, {"packed"}, error)
    with caplog.at_level(logging.WARNING, logger="tpu_spmv_torch"):
        with pytest.raises(type(error)):
            spmv_csr(A, x, MERGE, device=CPU)
    assert tried == ["packed"]
    assert not caplog.records
    assert not jspmv._is_exec_error(NotImplementedError("library bug"))


def test_launch_failure_is_execution_not_a_retry(monkeypatch):
    """A kernel's launch failure (a ``cudaError`` from its ctypes wrapper,
    ``DeviceException``) ends the call with ``EXECUTION`` under the
    no-throw contract; it is not served by another route."""
    A = wide()
    x = RandomGenerator(7).vector(A.num_cols)
    tried = fail_port(monkeypatch, {"packed"},
                      DeviceException("window-ELL fold launch: cudaError 1"))
    res = spmv_csr(A, x, MERGE, device=CPU)
    assert tried == ["packed"]
    assert res.error_code == EXECUTION
    assert res.y is None and res.plan is None


def test_call_after_an_oom_runs_the_cached_plan(monkeypatch):
    """The plan a failed call resolved stays cached; the next call, with
    nothing injected, is served by it and matches the oracle."""
    A = narrow()
    x = RandomGenerator(7).vector(A.num_cols)
    fail_port(monkeypatch, {"packed"})
    assert spmv_csr(A, x, MERGE, device=CPU).error_code == EXECUTION
    cached = dict(A._plan_cache)
    monkeypatch.undo()
    res = spmv_csr(A, x, MERGE, device=CPU)
    assert res.error_code == 0 and route(res.plan) == "packed"
    assert any(v is res.plan for v in A._plan_cache.values())
    assert cached.keys() == A._plan_cache.keys()
    assert spmv_matches(res.y_host(), A, x, rel_tol=ROW_TOL)
