"""A device buffer with explicit ownership (port of ``tpu_spmv/buffer.py``,
the reference's ``CudaBuffer<T>``, ``include/spmv/cuda_buffer.h:13-101``).

A :class:`DeviceBuffer` owns one 1-D tensor on its device, the card unless
the caller names another: constructing it with a size allocates zeros;
``copy_from_host`` and ``copy_to_host`` move data (the upload through
:func:`~tpu_spmv_torch.errors.guarded_upload`, so its failures carry the
reference's codes); ``resize`` reallocates and drops the contents, as the
reference does; ``release`` drops the tensor at once.  Python has no move
semantics: ``take`` hands the tensor over and leaves the buffer empty.
"""

from __future__ import annotations

import numpy as np
import torch

from .errors import (InvalidArgumentError, SpMVError, guarded_upload,
                     target_device)


def _torch_dtype(dtype) -> torch.dtype:
    """A torch dtype from a torch dtype, a NumPy dtype or a name."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.zeros(0, np.dtype(dtype))).dtype


class DeviceBuffer:
    """A 1-D device tensor of a fixed dtype with eager release
    (``cuda_buffer.h:13-101``)."""

    def __init__(self, size: int = 0, dtype=torch.float32, device=None):
        if size < 0:
            raise InvalidArgumentError("DeviceBuffer size must be >= 0")
        self._dtype = _torch_dtype(dtype)
        self._device = target_device(device, "DeviceBuffer")
        self._tensor: torch.Tensor | None = None
        if size > 0:
            self._tensor = self._zeros(size)

    def _zeros(self, size: int) -> torch.Tensor:
        return guarded_upload(torch.zeros(size, dtype=self._dtype),
                              self._device)

    # -- observers (cuda_buffer.h:56-58) --
    @property
    def size(self) -> int:
        return 0 if self._tensor is None else int(self._tensor.shape[0])

    @property
    def empty(self) -> bool:
        return self.size == 0

    @property
    def dtype(self) -> torch.dtype:
        return self._dtype

    def get(self) -> torch.Tensor:
        """The tensor (the raw pointer getter's counterpart)."""
        if self._tensor is None:
            raise InvalidArgumentError("DeviceBuffer is empty/released")
        return self._tensor

    # -- transfer (cuda_buffer.h:61-74) --
    def copy_from_host(self, host, count: int | None = None) -> None:
        """Copy the first ``count`` values (all by default) of ``host`` into
        the buffer's first ``count`` slots; :class:`InvalidArgumentError`
        where they do not fit (``cuda_buffer.h:62-63``)."""
        host = torch.as_tensor(np.asarray(host)).to(self._dtype)
        n = len(host) if count is None else count
        if n > len(host) or n > self.size:
            raise InvalidArgumentError(
                "copy_from_host: count exceeds buffer size")
        if n == 0:
            return
        if n == self.size:
            self._tensor = guarded_upload(host[:n].contiguous(),
                                          self._device)
        else:
            self._tensor[:n] = guarded_upload(host[:n].contiguous(),
                                              self._device)

    def copy_to_host(self, out: np.ndarray | None = None,
                     count: int | None = None) -> np.ndarray:
        """The first ``count`` values (all by default) as a NumPy array, or
        written into ``out``."""
        n = self.size if count is None else count
        if n > self.size:
            raise InvalidArgumentError(
                "copy_to_host: count exceeds buffer size")
        host = self.get()[:n].cpu().numpy()
        if out is not None:
            if len(out) < n:
                raise InvalidArgumentError("copy_to_host: output too small")
            out[:n] = host
            return out
        return host.copy()

    # -- lifetime (cuda_buffer.h:77-96) --
    def resize(self, new_size: int) -> None:
        """Reallocate to ``new_size`` zeros; the contents are dropped, as
        the reference reallocates without a copy (``cuda_buffer.h:77-87``)."""
        if new_size < 0:
            raise InvalidArgumentError("resize: negative size")
        self.release()
        if new_size > 0:
            self._tensor = self._zeros(new_size)

    def release(self) -> None:
        """Drop the tensor now (``cuda_buffer.h:90-96``): its memory goes
        back to PyTorch's allocator once no one else holds it."""
        self._tensor = None

    def take(self) -> torch.Tensor:
        """Hand the tensor over and leave the buffer empty (the move
        constructor's counterpart, ``cuda_buffer.h:38-53``)."""
        t = self.get()
        self._tensor = None
        return t

    def put(self, tensor: torch.Tensor) -> None:
        """Adopt a tensor of the buffer's dtype (a swap-style update)."""
        if tensor.dtype != self._dtype:
            raise InvalidArgumentError("put: dtype mismatch")
        self._tensor = tensor

    def swap(self, other: "DeviceBuffer") -> None:
        """Exchange the two tensors (PageRank's double buffer,
        ``pagerank.cu:130``)."""
        self._tensor, other._tensor = other._tensor, self._tensor

    def __len__(self) -> int:
        return self.size

    def __repr__(self) -> str:
        return (f"DeviceBuffer(size={self.size}, dtype={self._dtype}, "
                f"device={self._device})")


def buffer_status(buf: DeviceBuffer) -> SpMVError:
    """``SUCCESS`` for a buffer that holds data, else
    ``INVALID_ARGUMENT``."""
    return SpMVError.SUCCESS if not buf.empty else SpMVError.INVALID_ARGUMENT
