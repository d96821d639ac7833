"""CSR storage (port of ``tpu_spmv/csr.py``).

:class:`CSRMatrix` holds the reference struct's three arrays in NumPy
(``values`` f32, ``col_indices`` i32, ``row_ptrs`` i32) plus a per-matrix
plan cache the dispatch fills, with the JAX container's host API:
``create``, ``from_dense``, ``from_arrays``, ``to_dense``, ``get_element``,
``compute_stats`` and the reference binary format (``serialize`` /
``deserialize``, byte for byte the JAX package's and the reference's,
``csr_matrix.cpp:202-279``).  Its device form :class:`DeviceCSR` (the same
three arrays as tensors on one device) serves the flat path
(:mod:`.kernels.scalar`); ``from_device`` reads one back.  The ``csr_*``
functions are the reference header's C-style names.
"""

from __future__ import annotations

import dataclasses
import os
from typing import BinaryIO

import numpy as np

from .errors import (FileIOError, InvalidArgumentError,
                     InvalidDimensionError, InvalidFormatError, SpMVError,
                     guarded_upload)

# Minimum padding quantum of the packed layout: one (8, 128) tile.
LANE_TILE = 1024


def read_array(f, n: int, dtype: str, what: str) -> np.ndarray:
    """``n`` little-endian 4-byte values from a binary file, or
    :class:`FileIOError` where the file ends first."""
    raw = f.read(4 * n)
    if len(raw) != 4 * n:
        raise FileIOError(f"truncated {what} payload")
    return np.frombuffer(raw, dtype=dtype)


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
    def create(num_rows: int, num_cols: int, nnz: int) -> "CSRMatrix":
        """An empty CSR shell (reference ``csr_create``,
        ``csr_matrix.cpp:10-32``): zero values, column indices and row
        pointers."""
        if num_rows < 0 or num_cols < 0 or nnz < 0:
            raise InvalidDimensionError("csr_create: negative dimension")
        return CSRMatrix(num_rows, num_cols, np.zeros(nnz, np.float32),
                         np.zeros(nnz, np.int32),
                         np.zeros(num_rows + 1, np.int32))

    @staticmethod
    def from_arrays(num_rows: int, num_cols: int, values, col_indices,
                    row_ptrs) -> "CSRMatrix":
        return CSRMatrix(num_rows, num_cols, np.asarray(values),
                         np.asarray(col_indices), np.asarray(row_ptrs))

    @staticmethod
    def from_dense(dense: np.ndarray, num_rows: int | None = None,
                   num_cols: int | None = None) -> "CSRMatrix":
        """Dense (row-major) → CSR (reference ``csr_from_dense``,
        ``csr_matrix.cpp:50-95``); the zero test is exact ``!= 0.0``, and a
        flat ``dense`` takes its shape from ``num_rows`` and ``num_cols``."""
        dense = np.asarray(dense, dtype=np.float32)
        if num_rows is not None:
            dense = dense.reshape(num_rows, num_cols)
        if dense.ndim != 2:
            raise InvalidDimensionError("from_dense expects a 2D array")
        rows, cols = dense.shape
        mask = dense != np.float32(0.0)
        row_ptrs = np.zeros(rows + 1, np.int32)
        np.cumsum(mask.sum(axis=1, dtype=np.int64), out=row_ptrs[1:])
        rr, cc = np.nonzero(mask)  # row-major order → cols sorted within row
        return CSRMatrix(rows, cols, dense[rr, cc].astype(np.float32),
                         cc.astype(np.int32), row_ptrs)

    def to_dense(self) -> np.ndarray:
        """CSR → dense (reference ``csr_to_dense``,
        ``csr_matrix.cpp:97-114``)."""
        dense = np.zeros((self.num_rows, self.num_cols), np.float32)
        if self.nnz:
            rows = np.repeat(np.arange(self.num_rows, dtype=np.int64),
                             np.diff(self.row_ptrs))
            dense[rows, self.col_indices] = self.values
        return dense

    def get_element(self, row: int, col: int) -> float:
        """The element at ``(row, col)``, 0 outside the matrix or the
        pattern: a binary search of the row's sorted columns (reference
        ``csr_get_element``, ``csr_matrix.cpp:116-135``)."""
        if not (0 <= row < self.num_rows and 0 <= col < self.num_cols):
            return 0.0
        lo, hi = int(self.row_ptrs[row]), int(self.row_ptrs[row + 1])
        j = lo + int(np.searchsorted(self.col_indices[lo:hi], col))
        if j < hi and self.col_indices[j] == col:
            return float(self.values[j])
        return 0.0

    def serialize(self, path: str | os.PathLike | BinaryIO) -> None:
        """The reference binary layout (``csr_matrix.cpp:202-230``): an
        int32 header {rows, cols, nnz}, then values f32[nnz], col_indices
        i32[nnz] and row_ptrs i32[rows+1], little-endian."""
        own = not hasattr(path, "write")
        try:
            f = open(path, "wb") if own else path
        except OSError as e:
            raise FileIOError(str(e)) from e
        try:
            f.write(np.array([self.num_rows, self.num_cols, self.nnz],
                             dtype="<i4").tobytes())
            if self.nnz:
                f.write(self.values.astype("<f4").tobytes())
                f.write(self.col_indices.astype("<i4").tobytes())
            f.write(self.row_ptrs.astype("<i4").tobytes())
        except OSError as e:
            raise FileIOError(str(e)) from e
        finally:
            if own:
                f.close()

    @staticmethod
    def deserialize(path: str | os.PathLike | BinaryIO) -> "CSRMatrix":
        """Read the reference binary layout (``csr_matrix.cpp:232-279``);
        a short or corrupt file raises :class:`FileIOError`."""
        own = not hasattr(path, "read")
        try:
            f = open(path, "rb") if own else path
        except OSError as e:
            raise FileIOError(str(e)) from e
        try:
            header = np.frombuffer(f.read(12), dtype="<i4")
            if len(header) != 3:
                raise FileIOError("truncated CSR header")
            rows, cols, nnz = (int(v) for v in header)
            if rows < 0 or cols < 0 or nnz < 0:
                raise FileIOError("corrupt CSR header")
            values = read_array(f, nnz, "<f4", "CSR")
            col_indices = read_array(f, nnz, "<i4", "CSR")
            row_ptrs = read_array(f, rows + 1, "<i4", "CSR")
            return CSRMatrix(rows, cols, values.copy(), col_indices.copy(),
                             row_ptrs.copy())
        except OSError as e:
            raise FileIOError(str(e)) from e
        finally:
            if own:
                f.close()

    def to_device(self, device="cuda") -> "DeviceCSR":
        """The matrix on ``device`` (the card unless the caller names
        another), cached per device in the plan cache (the JAX
        ``to_device``, ``tpu_spmv/csr.py:239-247``)."""
        import torch

        key = ("_device", str(torch.device(device)))
        if key not in self._plan_cache or self._plan_cache[key].deleted:
            self._plan_cache[key] = DeviceCSR.from_host(self, device)
        return self._plan_cache[key]

    def from_device(self, dev: "DeviceCSR") -> None:
        """Copy a device matrix's arrays back into this host matrix
        (reference ``csr_from_gpu``, ``csr_matrix.cpp:167-182``)."""
        if dev.num_rows != self.num_rows or dev.num_cols != self.num_cols:
            raise InvalidDimensionError("from_device: dimension mismatch")
        self.values = dev.values.cpu().numpy().copy()
        self.col_indices = dev.col_indices.cpu().numpy().copy()
        self.row_ptrs = dev.row_ptrs.cpu().numpy().copy()

    def free_device(self) -> None:
        """Drop the device copies and every cached plan (reference
        ``csr_free_gpu``, ``csr_matrix.cpp:184-200``); the next call
        uploads or plans again."""
        self._plan_cache.clear()

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


def column_scale_factor(adj: CSRMatrix) -> np.ndarray | None:
    """Per-column scale ``s`` when ``A = B·diag(s)`` for a 0/1 pattern ``B``
    (every stored value of a column the same), as a column-normalised
    transition matrix is (values ``1/outdeg(col)``); ``None`` when the
    factorisation does not hold exactly."""
    if adj.nnz == 0:
        return np.zeros(adj.num_cols, np.float32)
    scale = np.zeros(adj.num_cols, np.float32)
    scale[adj.col_indices] = adj.values       # the last value per column
    if not np.array_equal(adj.values, scale[adj.col_indices]):
        return None
    return scale


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

    def delete(self) -> None:
        """Drop the device tensors (the JAX ``DeviceCSR.delete``): their
        memory goes back to the allocator once nothing else holds them,
        and the form is empty; a host matrix that cached it uploads
        again on its next :meth:`CSRMatrix.to_device`."""
        for name in ("values", "col_indices", "row_ptrs"):
            object.__setattr__(self, name, None)

    @property
    def deleted(self) -> bool:
        return self.values is None

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


# ---- the reference header's C-style names (``csr_matrix.h``) ----

def csr_create(num_rows: int, num_cols: int, nnz: int) -> CSRMatrix:
    return CSRMatrix.create(num_rows, num_cols, nnz)


def csr_from_dense(dense, num_rows=None, num_cols=None) -> CSRMatrix:
    return CSRMatrix.from_dense(dense, num_rows, num_cols)


def csr_to_dense(mat: CSRMatrix) -> np.ndarray:
    return mat.to_dense()


def csr_get_element(mat: CSRMatrix, row: int, col: int) -> float:
    return mat.get_element(row, col)


def csr_to_device(mat: CSRMatrix, device="cuda") -> DeviceCSR:
    return mat.to_device(device)


def csr_serialize(mat: CSRMatrix, path) -> SpMVError:
    if mat is None or path is None:
        raise InvalidArgumentError("csr_serialize: null argument")
    mat.serialize(path)
    return SpMVError.SUCCESS


def csr_deserialize(path) -> CSRMatrix:
    return CSRMatrix.deserialize(path)


def csr_compute_stats(mat: CSRMatrix) -> CSRStats:
    return mat.compute_stats()
