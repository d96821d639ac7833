"""Host CSR storage (port of the host half of ``tpu_spmv/csr.py``).

:class:`CSRMatrix` holds the reference struct's three arrays in NumPy
(``values`` f32, ``col_indices`` i32, ``row_ptrs`` i32) plus a per-matrix
plan cache the dispatch fills.  The device form ``DeviceCSR`` serves only the
flat fallback path and is not ported yet (ROADMAP M2).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .errors import InvalidDimensionError

# Minimum padding quantum of the packed layout: one (8, 128) tile.
LANE_TILE = 1024


def _bucket(n: int, quantum: int = LANE_TILE) -> int:
    """Round ``n`` up to a power-of-two multiple of ``quantum`` (the JAX
    package's shape buckets; kept so plans equal the reference's)."""
    if n <= quantum:
        return quantum
    k = (n + quantum - 1) // quantum
    return quantum * (1 << (k - 1).bit_length())


@dataclasses.dataclass
class CSRStats:
    """Row-length statistics (reference ``csr_matrix.h:64-71``)."""

    avg_nnz_per_row: float
    max_nnz_per_row: int
    min_nnz_per_row: int
    skewness: float  # max / (min + 1)


@dataclasses.dataclass
class CSRMatrix:
    """Host-side CSR matrix: ``values[nnz]`` f32, ``col_indices[nnz]`` i32,
    ``row_ptrs[rows+1]`` i32."""

    num_rows: int
    num_cols: int
    values: np.ndarray
    col_indices: np.ndarray
    row_ptrs: np.ndarray
    _plan_cache: dict = dataclasses.field(
        default_factory=dict, repr=False, compare=False
    )

    @property
    def nnz(self) -> int:
        return int(len(self.values))

    def __post_init__(self):
        self.values = np.ascontiguousarray(self.values, dtype=np.float32)
        self.col_indices = np.ascontiguousarray(self.col_indices,
                                                dtype=np.int32)
        self.row_ptrs = np.ascontiguousarray(self.row_ptrs, dtype=np.int32)
        if self.num_rows < 0 or self.num_cols < 0:
            raise InvalidDimensionError("negative matrix dimension")
        if len(self.row_ptrs) != self.num_rows + 1:
            raise InvalidDimensionError(
                "row_ptrs must have num_rows + 1 entries")
        if len(self.col_indices) != len(self.values):
            raise InvalidDimensionError(
                "values / col_indices length mismatch")

    @staticmethod
    def from_dense(dense: np.ndarray) -> "CSRMatrix":
        """Dense (row-major) → CSR; the zero test is exact ``!= 0.0``."""
        dense = np.asarray(dense, dtype=np.float32)
        if dense.ndim != 2:
            raise InvalidDimensionError("from_dense expects a 2D array")
        rows, cols = dense.shape
        mask = dense != np.float32(0.0)
        row_ptrs = np.zeros(rows + 1, np.int32)
        np.cumsum(mask.sum(axis=1, dtype=np.int64), out=row_ptrs[1:])
        rr, cc = np.nonzero(mask)  # row-major order → cols sorted within row
        return CSRMatrix(rows, cols, dense[rr, cc].astype(np.float32),
                         cc.astype(np.int32), row_ptrs)

    def compute_stats(self) -> CSRStats:
        """Reference ``csr_compute_stats`` (``csr_matrix.cpp:281-300``)."""
        if self.num_rows == 0:
            return CSRStats(0.0, 0, 0, 0.0)
        row_nnz = np.diff(self.row_ptrs)
        mx = int(row_nnz.max()) if len(row_nnz) else 0
        mn = int(row_nnz.min()) if len(row_nnz) else 0
        return CSRStats(
            avg_nnz_per_row=self.nnz / self.num_rows,
            max_nnz_per_row=mx,
            min_nnz_per_row=mn,
            skewness=float(mx) / float(mn + 1),
        )
