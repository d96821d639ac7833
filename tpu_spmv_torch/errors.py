"""Error codes and exception types (port of ``tpu_spmv/errors.py``).

The :class:`SpMVError` values are the reference library's codes, unchanged,
so results and error codes compare one to one with the JAX package.  Device
failures during an upload map to the typed exceptions the dispatch turns
into codes (the no-throw contract of ``spmv_csr``).
"""

from __future__ import annotations

import enum


class SpMVError(enum.IntEnum):
    """Error codes with the same numeric values as the reference enum."""

    SUCCESS = 0
    INVALID_DIMENSION = -1
    DEVICE_ALLOC = -2       # reference: CUDA_MALLOC
    DEVICE_TRANSFER = -3    # reference: CUDA_MEMCPY
    EXECUTION = -4          # reference: KERNEL_LAUNCH
    INVALID_FORMAT = -5
    FILE_IO = -6
    OUT_OF_MEMORY = -7
    INVALID_ARGUMENT = -8


_ERROR_STRINGS = {
    SpMVError.SUCCESS: "Success",
    SpMVError.INVALID_DIMENSION: "Invalid matrix/vector dimension",
    SpMVError.DEVICE_ALLOC: "Device memory allocation failed",
    SpMVError.DEVICE_TRANSFER: "Device memory copy failed",
    SpMVError.EXECUTION: "Device program execution failed",
    SpMVError.INVALID_FORMAT: "Invalid sparse matrix format",
    SpMVError.FILE_IO: "File I/O error",
    SpMVError.OUT_OF_MEMORY: "Out of memory",
    SpMVError.INVALID_ARGUMENT: "Invalid argument",
}


def spmv_error_string(err: SpMVError | int) -> str:
    """String for an error code."""
    try:
        return _ERROR_STRINGS[SpMVError(err)]
    except ValueError:
        return "Unknown error"


class SpMVException(Exception):
    """Base exception; carries a :class:`SpMVError` code."""

    code: SpMVError = SpMVError.INVALID_ARGUMENT

    def __init__(self, message: str | None = None):
        super().__init__(message or spmv_error_string(self.code))


class InvalidDimensionError(SpMVException):
    code = SpMVError.INVALID_DIMENSION


class InvalidFormatError(SpMVException):
    code = SpMVError.INVALID_FORMAT


class InvalidArgumentError(SpMVException):
    code = SpMVError.INVALID_ARGUMENT


class FileIOError(SpMVException):
    code = SpMVError.FILE_IO


class DeviceException(SpMVException):
    """CUDA runtime failure (a kernel launch or execution error)."""

    code = SpMVError.EXECUTION

    def __init__(self, original: BaseException | str):
        self.original = original
        super().__init__(f"Device error: {original}")


class DeviceAllocError(SpMVException):
    """Device memory allocation failed (reference ``CUDA_MALLOC``)."""

    code = SpMVError.DEVICE_ALLOC


class DeviceTransferError(SpMVException):
    """Host↔device transfer failed (reference ``CUDA_MEMCPY``)."""

    code = SpMVError.DEVICE_TRANSFER


class OutOfMemoryError(SpMVException):
    """Host allocation failed (reference ``OUT_OF_MEMORY``)."""

    code = SpMVError.OUT_OF_MEMORY


def guarded_upload(array, device):
    """Copy a NumPy array or tensor to ``device`` as a tensor, with the
    reference's error discrimination: CUDA out-of-memory →
    :class:`DeviceAllocError`; any other CUDA runtime error during the copy
    → :class:`DeviceTransferError`; host ``MemoryError`` →
    :class:`OutOfMemoryError`.  Other errors (bad dtype, …) are caller bugs
    and propagate unchanged."""
    import torch

    try:
        if isinstance(array, torch.Tensor):
            t = array
        else:   # torch does not wrap read-only arrays (np.asarray of JAX)
            t = torch.from_numpy(array if array.flags.writeable
                                 else array.copy())
        return t.to(device)
    except torch.cuda.OutOfMemoryError as e:
        raise DeviceAllocError(str(e)) from e
    except MemoryError as e:
        raise OutOfMemoryError(str(e)) from e
    except RuntimeError as e:
        if "CUDA" not in str(e) and "cuda" not in str(e):
            raise
        raise DeviceTransferError(str(e)) from e


def target_device(device, what: str):
    """``device`` as a ``torch.device``: the card unless the caller names
    another; :class:`DeviceAllocError` (the code the reference's first
    device allocation gives without a card) where it is a CUDA device and
    none is present."""
    import torch

    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise DeviceAllocError(f"{what}: no CUDA device is available")
    return device
