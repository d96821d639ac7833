"""The HPCG operator (``spmvbench/generators/hpcg.py``) and what it asks of
the dispatch.

* The law against a literal transcription of HPCG 3.1's
  ``GenerateProblem_ref`` (its triple loop over the grid and the
  27-point stencil's offsets): the same CSR at 4 × 5 × 6.
* ``spmv_csr`` under the auto configuration and ``spmv_ell`` under
  ``SpMVConfig()`` on a 12 × 10 × 9 grid against the float64 product.
* A matrix that every packed layout rejects: at HPCG's 104³ grid the
  columns pass ``VMEM_X_MAX_COLS``, the composite plan overflows and the
  flat path serves.  The rejection is remembered on the matrix, so the
  composite is built once, not once a call (here the cap is lowered and
  the composite made to overflow).
* The dispatch's spans: ``spmv.plan`` counts the host plans a call built
  or rejected, ``spmv.strips`` the strips a strip plan ran.
"""

import numpy as np
import pytest
import torch

import tpu_spmv_torch
import tpu_spmv_torch.spmv as tspmv
from test_torch_ell import strip_matrix
from tpu_spmv_torch import (CSRMatrix, DeviceCSR, ELLMatrix, KernelType,
                            SpMVConfig, profiling, spmv_auto_config)
from tpu_spmv_torch.kernels.plan import WindowEllOverflow
from tpu_spmv_torch.kernels.strips import StripPlan

CPU = "cpu"
ROW_TOL = 1e-5


def generate_problem_ref(nx, ny, nz):
    """``GenerateProblem_ref``'s operator on one rank, loop for loop:
    ``(row lengths, columns, values)`` in row order."""
    lengths, cols, vals = [], [], []
    for iz in range(nz):
        for iy in range(ny):
            for ix in range(nx):
                row = iz * nx * ny + iy * nx + ix
                n = 0
                for sz in (-1, 0, 1):
                    if 0 <= iz + sz < nz:
                        for sy in (-1, 0, 1):
                            if 0 <= iy + sy < ny:
                                for sx in (-1, 0, 1):
                                    if 0 <= ix + sx < nx:
                                        col = row + sz * nx * ny \
                                            + sy * nx + sx
                                        cols.append(col)
                                        vals.append(26.0 if col == row
                                                    else -1.0)
                                        n += 1
                lengths.append(n)
    return lengths, cols, vals


def hpcg(nx, ny, nz):
    from spmvbench.generators import hpcg as law

    return law.generate({"nx": nx, "ny": ny, "nz": nz,
                         "structure_seed": 42})


def hpcg_csr(nx, ny, nz) -> CSRMatrix:
    m = hpcg(nx, ny, nz)
    return CSRMatrix(m.num_rows, m.num_cols, m.values, m.col_indices,
                     m.row_ptrs)


def product64(A: CSRMatrix, x: np.ndarray) -> tuple:
    """``(A @ x, |A| @ |x|)`` in float64."""
    rows = np.repeat(np.arange(A.num_rows), np.diff(A.row_ptrs))
    v = A.values.astype(np.float64)
    xg = x.astype(np.float64)[A.col_indices]
    y, s = np.zeros(A.num_rows), np.zeros(A.num_rows)
    np.add.at(y, rows, v * xg)
    np.add.at(s, rows, np.abs(v * xg))
    return y, s


def assert_close(y, A, x):
    ref, scale = product64(A, x)
    gap = np.abs(np.asarray(y, np.float64) - ref)
    assert np.all(gap <= ROW_TOL * np.maximum(scale, 1.0)), gap.max()


def test_the_law_is_generate_problem_ref():
    m = hpcg(4, 5, 6)
    lengths, cols, vals = generate_problem_ref(4, 5, 6)
    assert m.num_rows == m.num_cols == 4 * 5 * 6
    assert np.diff(m.row_ptrs).tolist() == lengths
    assert m.col_indices.tolist() == cols
    assert m.values.tolist() == vals
    assert m.values.dtype == np.float32 and m.col_indices.dtype == np.int32
    assert set(lengths) == {8, 12, 18, 27}
    assert m.nnz == 10 * 13 * 16 == (3 * 4 - 2) * (3 * 5 - 2) * (3 * 6 - 2)
    rows = np.repeat(np.arange(m.num_rows), np.diff(m.row_ptrs))
    diag = m.col_indices == rows
    assert diag.sum() == m.num_rows and np.all(m.values[diag] == 26.0)
    assert np.all(m.values[~diag] == -1.0)


@pytest.mark.parametrize("entry", ["csr", "ell"])
def test_both_entries_give_the_float64_product(entry):
    A = hpcg_csr(12, 10, 9)
    x = np.random.default_rng(5).uniform(-1, 1, A.num_cols) \
        .astype(np.float32)
    if entry == "csr":
        res = tpu_spmv_torch.spmv_csr(A, x, spmv_auto_config(A), device=CPU)
    else:
        res = tpu_spmv_torch.spmv_ell(ELLMatrix.from_csr(A), x,
                                      SpMVConfig(), device=CPU)
    assert res.error_code == 0
    assert_close(res.y_host(), A, x)


@pytest.fixture
def rejected(monkeypatch):
    """The 12 × 10 × 9 operator past a lowered ``VMEM_X_MAX_COLS`` (as
    104³ is past the real one) with a composite plan that overflows and
    counts its builds."""
    A = hpcg_csr(12, 10, 9)
    builds = []

    def overflow(*args, **kwargs):
        builds.append(1)
        raise WindowEllOverflow("no composite level packs this structure")

    monkeypatch.setattr(tspmv, "VMEM_X_MAX_COLS", A.num_cols - 1)
    monkeypatch.setattr(tspmv, "build_composite", overflow)
    return A, builds


def test_a_rejected_composite_is_built_once(rejected):
    A, builds = rejected
    cfg = spmv_auto_config(A)
    assert cfg.kernel_type == KernelType.VECTOR_CSR
    x = np.random.default_rng(6).uniform(-1, 1, A.num_cols) \
        .astype(np.float32)
    first = tpu_spmv_torch.spmv_csr(A, x, cfg, device=CPU)
    again = tpu_spmv_torch.spmv_csr(A, x, cfg, device=CPU)
    assert first.error_code == 0 == again.error_code
    assert builds == [1]
    assert isinstance(first.plan, DeviceCSR) and again.plan is first.plan
    assert torch.equal(first.y, again.y)
    assert A._plan_cache[("host", int(KernelType.VECTOR_CSR), None, False,
                          None)] is None
    assert_close(again.y_host(), A, x)
    A.free_device()
    tpu_spmv_torch.spmv_csr(A, x, cfg, device=CPU)
    assert builds == [1, 1]


def spans_named(name):
    return [s for s in profiling.spans() if s.name == name]


@pytest.mark.parametrize("entry", ["csr", "ell", "rejected"])
def test_the_plan_span_counts_a_build_then_none(entry, request):
    if entry == "rejected":
        A, builds = request.getfixturevalue("rejected")
    else:
        A = hpcg_csr(6, 5, 4)
    x = np.ones(A.num_cols, np.float32)
    if entry == "ell":
        E = ELLMatrix.from_csr(A)

        def call():
            return tpu_spmv_torch.spmv_ell(E, x, SpMVConfig(), device=CPU)
    else:
        def call():
            return tpu_spmv_torch.spmv_csr(A, x, spmv_auto_config(A),
                                           device=CPU)
    profiling.clear()
    with profiling.recording():
        assert call().error_code == 0
        assert call().error_code == 0
    spans = profiling.spans()
    plan = spans_named("spmv.plan")
    profiling.clear()
    assert [s.count for s in plan] == [1, 0]
    assert all(spans[s.parent].name == "spmv.resolve" for s in plan)
    assert all(s.end_ns >= s.start_ns > 0 for s in plan)


def test_without_recording_no_plan_span():
    A = hpcg_csr(6, 5, 4)
    profiling.clear()
    tpu_spmv_torch.spmv_csr(A, np.ones(A.num_cols, np.float32),
                            device=CPU)
    assert profiling.spans() == []


def test_the_strips_span_counts_the_strips_run():
    A = strip_matrix()
    E = ELLMatrix.from_csr(A)
    x = np.random.default_rng(8).uniform(-1, 1, A.num_cols) \
        .astype(np.float32)
    profiling.clear()
    with profiling.recording():
        res = tpu_spmv_torch.spmv_ell(E, x, device=CPU)
    spans = profiling.spans()
    strips = spans_named("spmv.strips")
    profiling.clear()
    assert res.error_code == 0 and isinstance(res.plan, StripPlan)
    assert len(res.plan.plans) == 2
    assert [s.count for s in strips] == [2]
    assert spans[strips[0].parent].name == "spmv.launch"
    assert_close(res.y_host(), A, x)
