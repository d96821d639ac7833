"""Host (CPU) reference SpMV — the correctness oracle (port of
``tpu_spmv/ops/cpu_reference.py``).

Each CSR row is summed left to right in fp32, as the reference golden
kernel does (``src/spmv_cpu.cpp:6-16``): natively when the planner library
is built, else by per-row ``np.add.reduce`` over fp32 slices.  ELL
accumulates slot by slot, padding skipped (``spmv_cpu.cpp:18-32``).
"""

from __future__ import annotations

import numpy as np

from ..csr import CSRMatrix
from ..ell import ELLMatrix


def spmv_cpu_csr(A: CSRMatrix, x: np.ndarray,
                 y: np.ndarray | None = None) -> np.ndarray:
    """``y = A @ x`` for CSR on the host."""
    x = np.asarray(x, dtype=np.float32)
    if y is None:
        y = np.zeros(A.num_rows, np.float32)
    from ..native import spmv_cpu_csr_native

    if A.num_rows and spmv_cpu_csr_native(A.num_rows, A.row_ptrs,
                                          A.col_indices, A.values, x, y):
        return y
    gathered = A.values * x[A.col_indices] if A.nnz else \
        np.zeros(0, np.float32)
    for i in range(A.num_rows):
        lo, hi = A.row_ptrs[i], A.row_ptrs[i + 1]
        y[i] = np.add.reduce(gathered[lo:hi], dtype=np.float32) \
            if hi > lo else 0.0
    return y


def spmv_cpu_ell(A: ELLMatrix, x: np.ndarray,
                 y: np.ndarray | None = None) -> np.ndarray:
    """``y = A @ x`` for ELL on the host (reference ``spmv_cpu.cpp:18-32``):
    k-major, each slot's products added to every row in fp32, pad slots
    (``col < 0``) skipped."""
    x = np.asarray(x, dtype=np.float32)
    if y is None:
        y = np.zeros(A.num_rows, np.float32)
    else:
        y[:] = 0.0
    if A.num_rows == 0 or A.max_nnz_per_row == 0:
        return y
    vals = A.values.reshape(A.max_nnz_per_row, A.num_rows)
    cols = A.col_indices.reshape(A.max_nnz_per_row, A.num_rows)
    for k in range(A.max_nnz_per_row):
        valid = cols[k] >= 0
        y[valid] += vals[k][valid] * x[cols[k][valid]]
    return y
