"""ELL (ELLPACK) storage (port of ``tpu_spmv/ell.py``).

:class:`ELLMatrix` keeps the reference's column-major 1D layout
(``values[k * num_rows + row]``, ``ell_matrix.h:64-66``) and its binary
format, byte for byte the JAX package's, so ``ELLMatrix(rows, cols, k,
values, col_indices)`` takes the JAX container's arrays unchanged and a file
either package writes loads in the other.  Its device form
:class:`DeviceELL` is slot-major: ``(slots, rows_pad)`` tensors on one
device, slot ``k`` one contiguous row of each operand, ``rows_pad`` the JAX
package's 1024-bucket of the rows, so :meth:`ELLMatrix.from_device` crops
the same way.

Padding is the reference's: ``col = -1`` and ``value = 0`` for an unused
slot (``ell_matrix.cpp:23-27``); the flat path masks by ``col >= 0``.
"""

from __future__ import annotations

import dataclasses
import os
from typing import BinaryIO

import numpy as np

from .csr import CSRMatrix, _bucket, read_array
from .errors import (FileIOError, InvalidArgumentError,
                     InvalidDimensionError, InvalidFormatError, SpMVError,
                     guarded_upload)


def ell_index(row: int, k: int, num_rows: int) -> int:
    """Column-major flat index (reference ``ell_matrix.h:64-66``)."""
    return k * num_rows + row


@dataclasses.dataclass
class ELLMatrix:
    """Host ELLPACK matrix in the reference's column-major 1D layout:
    ``values`` / ``col_indices`` hold ``num_rows * max_nnz_per_row``
    entries addressed by :func:`ell_index`, padding ``col=-1, val=0``
    (``ell_matrix.h:12-28``).  ``_plan_cache`` holds what the dispatch
    resolves for it (:func:`~tpu_spmv_torch.spmv.spmv_ell`) and its device
    forms, per device."""

    num_rows: int
    num_cols: int
    max_nnz_per_row: int
    values: np.ndarray
    col_indices: np.ndarray
    _device_cache: "DeviceELL | None" = dataclasses.field(
        default=None, repr=False, compare=False)
    _plan_cache: dict = dataclasses.field(
        default_factory=dict, repr=False, compare=False)

    def __post_init__(self):
        self.values = np.ascontiguousarray(self.values, dtype=np.float32)
        self.col_indices = np.ascontiguousarray(self.col_indices,
                                                dtype=np.int32)
        size = self.num_rows * self.max_nnz_per_row
        if len(self.values) != size or len(self.col_indices) != size:
            raise InvalidDimensionError(
                "ELL array size != rows * max_nnz_per_row")

    @staticmethod
    def create(num_rows: int, num_cols: int,
               max_nnz_per_row: int) -> "ELLMatrix":
        """All slots padding (reference ``ell_create``,
        ``ell_matrix.cpp:8-36``)."""
        if num_rows < 0 or num_cols < 0 or max_nnz_per_row < 0:
            raise InvalidDimensionError("ell_create: negative dimension")
        size = num_rows * max_nnz_per_row
        return ELLMatrix(num_rows, num_cols, max_nnz_per_row,
                         np.zeros(size, np.float32),
                         np.full(size, -1, np.int32))

    @staticmethod
    def from_dense(dense: np.ndarray, num_rows: int | None = None,
                   num_cols: int | None = None) -> "ELLMatrix":
        """Dense → ELL (reference ``ell_from_dense``,
        ``ell_matrix.cpp:53-109``): the exact zero test, and
        ``max_nnz_per_row`` from the densest row."""
        return ELLMatrix.from_csr(CSRMatrix.from_dense(dense, num_rows,
                                                       num_cols))

    @staticmethod
    def from_csr(csr: CSRMatrix) -> "ELLMatrix":
        """CSR → ELL (reference ``ell_from_csr``,
        ``ell_matrix.cpp:111-159``): the ``j``-th nonzero of a row goes to
        slot ``j``."""
        rows = csr.num_rows
        row_nnz = np.diff(csr.row_ptrs)
        ell = ELLMatrix.create(rows, csr.num_cols,
                               int(row_nnz.max(initial=0)))
        if csr.nnz:
            starts = np.repeat(csr.row_ptrs[:-1], row_nnz)
            slot = np.arange(csr.nnz, dtype=np.int64) - starts
            rr = np.repeat(np.arange(rows, dtype=np.int64), row_nnz)
            flat = slot * rows + rr
            ell.values[flat] = csr.values
            ell.col_indices[flat] = csr.col_indices
        return ell

    def to_csr(self) -> CSRMatrix:
        """ELL → CSR, a row's columns in slot order (ELL keeps no order,
        ``ell_matrix.h:12-28``): the matrix the packed routes plan."""
        k, r = self.max_nnz_per_row, self.num_rows
        if k == 0 or r == 0:
            return CSRMatrix(r, self.num_cols, np.zeros(0, np.float32),
                             np.zeros(0, np.int32),
                             np.zeros(r + 1, np.int32))
        cols2 = self.col_indices.reshape(k, r).T   # (rows, slots)
        vals2 = self.values.reshape(k, r).T
        valid = cols2 >= 0
        row_ptrs = np.zeros(r + 1, np.int32)
        np.cumsum(valid.sum(axis=1), out=row_ptrs[1:])
        return CSRMatrix(r, self.num_cols, vals2[valid], cols2[valid],
                         row_ptrs)

    def to_dense(self) -> np.ndarray:
        """ELL → dense (reference ``ell_to_dense``,
        ``ell_matrix.cpp:162-182``)."""
        dense = np.zeros((self.num_rows, self.num_cols), np.float32)
        if self.max_nnz_per_row == 0 or self.num_rows == 0:
            return dense
        vals = self.values.reshape(self.max_nnz_per_row, self.num_rows)
        cols = self.col_indices.reshape(self.max_nnz_per_row, self.num_rows)
        for k in range(self.max_nnz_per_row):
            valid = cols[k] >= 0
            dense[np.nonzero(valid)[0], cols[k][valid]] = vals[k][valid]
        return dense

    def get_element(self, row: int, col: int) -> float:
        """Reference ``ell_get_element`` (``ell_matrix.cpp:184-200``): the
        first slot of the row holding ``col``, 0 where none does."""
        if not (0 <= row < self.num_rows and 0 <= col < self.num_cols):
            return 0.0
        for k in range(self.max_nnz_per_row):
            idx = ell_index(row, k, self.num_rows)
            if self.col_indices[idx] == col:
                return float(self.values[idx])
        return 0.0

    @property
    def nnz(self) -> int:
        """Stored nonzeros (padding has ``col = -1``), the count the
        reference recounts on the host for its metrics
        (``spmv_kernels.cu:399-405``)."""
        return int((self.col_indices >= 0).sum())

    def serialize(self, path: str | os.PathLike | BinaryIO) -> None:
        """The reference binary layout (``ell_matrix.cpp:254-280``): an int32
        header {rows, cols, max_nnz}, then values f32[rows*max_nnz] and
        col_indices i32[rows*max_nnz], column-major, little-endian."""
        own = not hasattr(path, "write")
        try:
            f = open(path, "wb") if own else path
        except OSError as e:
            raise FileIOError(str(e)) from e
        try:
            f.write(np.array([self.num_rows, self.num_cols,
                              self.max_nnz_per_row], dtype="<i4").tobytes())
            if self.values.size:
                f.write(self.values.astype("<f4").tobytes())
                f.write(self.col_indices.astype("<i4").tobytes())
        except OSError as e:
            raise FileIOError(str(e)) from e
        finally:
            if own:
                f.close()

    @staticmethod
    def deserialize(path: str | os.PathLike | BinaryIO) -> "ELLMatrix":
        """Reference ``ell_deserialize`` (``ell_matrix.cpp:282-324``); a
        short or corrupt file raises :class:`FileIOError`."""
        own = not hasattr(path, "read")
        try:
            f = open(path, "rb") if own else path
        except OSError as e:
            raise FileIOError(str(e)) from e
        try:
            header = np.frombuffer(f.read(12), dtype="<i4")
            if len(header) != 3:
                raise FileIOError("truncated ELL header")
            rows, cols, max_nnz = (int(v) for v in header)
            if rows < 0 or cols < 0 or max_nnz < 0:
                raise FileIOError("corrupt ELL header")
            size = rows * max_nnz
            values = read_array(f, size, "<f4", "ELL")
            col_indices = read_array(f, size, "<i4", "ELL")
            return ELLMatrix(rows, cols, max_nnz, values.copy(),
                             col_indices.copy())
        except OSError as e:
            raise FileIOError(str(e)) from e
        finally:
            if own:
                f.close()

    def to_device(self, device="cuda") -> "DeviceELL":
        """The matrix on ``device`` (the card unless the caller names
        another), cached per device; the last one is the default of
        :meth:`from_device`."""
        import torch

        key = ("_device", str(torch.device(device)))
        if key not in self._plan_cache or self._plan_cache[key].deleted:
            self._plan_cache[key] = DeviceELL.from_host(self, device)
        self._device_cache = self._plan_cache[key]
        return self._device_cache

    def from_device(self, dev: "DeviceELL | None" = None) -> None:
        """Copy a device matrix back into host storage (reference
        ``ell_from_gpu``, ``ell_matrix.cpp:219-252``): the slot-major
        ``(slots, rows_pad)`` form cropped to ``(max_nnz_per_row,
        num_rows)`` and flattened column-major.  ``dev=None`` takes this
        matrix's last device form."""
        dev = dev if dev is not None else self._device_cache
        if dev is None:
            raise InvalidArgumentError("from_device: no device matrix")
        if dev.num_rows != self.num_rows or dev.num_cols != self.num_cols \
                or dev.max_nnz_per_row != self.max_nnz_per_row:
            raise InvalidDimensionError("from_device: dimension mismatch")
        k, r = self.max_nnz_per_row, self.num_rows
        self.values = dev.values[:k, :r].cpu().numpy().reshape(-1).copy()
        self.col_indices = \
            dev.col_indices[:k, :r].cpu().numpy().reshape(-1).copy()

    def free_device(self) -> None:
        """Drop the device forms and every cached plan (they hold device
        memory); the next call uploads or plans again."""
        self._device_cache = None
        self._plan_cache.clear()


@dataclasses.dataclass(frozen=True)
class DeviceELL:
    """An ELL matrix as slot-major ``(slots, rows_pad)`` tensors on one
    device (the JAX ``DeviceELL``, ``tpu_spmv/ell.py:255-306``): ``slots``
    is ``max(max_nnz_per_row, 1)``, ``rows_pad`` the 1024-bucket of the
    rows; pad entries keep ``col = -1, value = 0``."""

    values: "torch.Tensor"        # f32 (slots, rows_pad)
    col_indices: "torch.Tensor"   # i32 (slots, rows_pad)
    num_rows: int
    num_cols: int
    max_nnz_per_row: int

    @property
    def device(self):
        return self.values.device

    @property
    def rows_pad(self) -> int:
        return int(self.values.shape[1])

    @property
    def stream_bytes(self) -> float:
        """Bytes the flat ELL path moves at least: values and column
        indices of every slot (padding included), the gathered x and y,
        4 B each."""
        return 4.0 * (2 * self.values.numel() + self.num_cols
                      + self.num_rows)

    def delete(self) -> None:
        """Drop the device tensors (the JAX ``DeviceELL.delete``): their
        memory goes back to the allocator once nothing else holds them,
        and the form is empty; a host matrix that cached it uploads
        again on its next :meth:`ELLMatrix.to_device`."""
        for name in ("values", "col_indices"):
            object.__setattr__(self, name, None)

    @property
    def deleted(self) -> bool:
        return self.values is None

    @staticmethod
    def from_host(mat: ELLMatrix, device="cuda") -> "DeviceELL":
        """Upload ``mat`` after checking on the host that every stored
        column lies inside the matrix (the flat path gathers without
        checking); negative columns are padding."""
        if mat.col_indices.size and int(mat.col_indices.max()) \
                >= mat.num_cols:
            raise InvalidFormatError("ELL matrix: column index out of range")
        rows_pad = _bucket(mat.num_rows)
        slots = max(mat.max_nnz_per_row, 1)
        vals = np.zeros((slots, rows_pad), np.float32)
        cols = np.full((slots, rows_pad), -1, np.int32)
        if mat.num_rows and mat.max_nnz_per_row:
            shape = (mat.max_nnz_per_row, mat.num_rows)
            vals[:shape[0], :shape[1]] = mat.values.reshape(shape)
            cols[:shape[0], :shape[1]] = mat.col_indices.reshape(shape)
        return DeviceELL(guarded_upload(vals, device),
                         guarded_upload(cols, device), mat.num_rows,
                         mat.num_cols, mat.max_nnz_per_row)


# ---- the reference header's C-style names (``ell_matrix.h``) ----

def ell_create(num_rows: int, num_cols: int,
               max_nnz_per_row: int) -> ELLMatrix:
    return ELLMatrix.create(num_rows, num_cols, max_nnz_per_row)


def ell_from_dense(dense, num_rows=None, num_cols=None) -> ELLMatrix:
    return ELLMatrix.from_dense(dense, num_rows, num_cols)


def ell_from_csr(csr: CSRMatrix) -> ELLMatrix:
    return ELLMatrix.from_csr(csr)


def ell_to_dense(mat: ELLMatrix) -> np.ndarray:
    return mat.to_dense()


def ell_get_element(mat: ELLMatrix, row: int, col: int) -> float:
    return mat.get_element(row, col)


def ell_to_device(mat: ELLMatrix, device="cuda") -> DeviceELL:
    return mat.to_device(device)


def ell_from_device(mat: ELLMatrix, dev: DeviceELL | None = None) -> None:
    mat.from_device(dev)


def ell_serialize(mat: ELLMatrix, path) -> SpMVError:
    if mat is None or path is None:
        raise InvalidArgumentError("ell_serialize: null argument")
    mat.serialize(path)
    return SpMVError.SUCCESS


def ell_deserialize(path) -> ELLMatrix:
    return ELLMatrix.deserialize(path)
