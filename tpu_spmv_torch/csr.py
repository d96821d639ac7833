"""Host CSR storage (port of the host half of ``tpu_spmv/csr.py``).

:class:`CSRMatrix` holds the reference struct's three arrays in NumPy
(``values`` f32, ``col_indices`` i32, ``row_ptrs`` i32) plus a per-matrix
plan cache the dispatch fills.  Its device form :class:`DeviceCSR` (the same
three arrays as tensors on one device) serves the flat path
(:mod:`.kernels.scalar`).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .errors import InvalidDimensionError, InvalidFormatError, guarded_upload

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

    def to_device(self, device="cuda") -> "DeviceCSR":
        """The matrix on ``device`` (the card unless the caller names
        another), cached per device in the plan cache (the JAX
        ``to_device``, ``tpu_spmv/csr.py:239-247``)."""
        import torch

        key = ("_device", str(torch.device(device)))
        if key not in self._plan_cache:
            self._plan_cache[key] = DeviceCSR.from_host(self, device)
        return self._plan_cache[key]

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


@dataclasses.dataclass(frozen=True)
class DeviceCSR:
    """A CSR matrix as tensors on one device (the JAX ``DeviceCSR``,
    ``tpu_spmv/csr.py:266-340``, with its field names).  The arrays are not
    padded: the JAX package pads them to power-of-two buckets for XLA's
    static shapes, and the flat path here reduces over ``row_ptrs``
    directly, so the padding and the per-nonzero ``row_ids`` it needs for a
    segment sum by ids are left out."""

    values: torch.Tensor       # f32 (nnz,)
    col_indices: torch.Tensor  # i32 (nnz,)
    row_ptrs: torch.Tensor     # i32 (num_rows + 1,)
    num_rows: int
    num_cols: int
    nnz: int

    @property
    def device(self):
        return self.values.device

    @property
    def stream_bytes(self) -> float:
        """Bytes the flat SpMV moves at least: values and column indices,
        the gathered x, the row pointers and y, 4 B each."""
        return 4.0 * (3 * self.nnz + 2 * self.num_rows + 1)

    @staticmethod
    def from_host(mat: CSRMatrix, device="cuda") -> "DeviceCSR":
        """Upload ``mat`` after checking, on the host, what the flat path
        indexes with unchecked: row pointers from 0 to ``nnz``, never
        decreasing, and column indices inside the matrix."""
        ptr, cols = mat.row_ptrs, mat.col_indices
        if ptr[0] != 0 or ptr[-1] != mat.nnz or np.any(np.diff(ptr) < 0) \
                or (mat.nnz and (cols.min() < 0
                                 or cols.max() >= mat.num_cols)):
            raise InvalidFormatError("CSR matrix: row pointers or column "
                                     "indices out of range")
        put = lambda a: guarded_upload(a, device)  # noqa: E731
        return DeviceCSR(put(mat.values), put(mat.col_indices),
                         put(mat.row_ptrs), mat.num_rows, mat.num_cols,
                         mat.nnz)
