"""The slot-major flat ELL path (port of ``tpu_spmv/kernels/ell_kernel.py``).

The reference runs one thread per row over its column-major slots with a
pad test (``spmv_kernels.cu:191-213``); the JAX package vectorises the same
traversal over all rows at once on the slot-major ``(slots, rows_pad)``
:class:`~tpu_spmv_torch.ell.DeviceELL` and leaves it to XLA, outside any
Pallas kernel.  So it is plain PyTorch ops here too: gather x at every
slot, multiply, mask the padding (``col < 0``) to zero, and sum over the
slot axis.

The sum over slots is a reduction, not ``index_add_`` (atomics on CUDA), so
a call gives the same bits every time; nothing reads the device back, so a
call can be captured in a CUDA graph.  Its temporaries are three
``(slots, rows_pad)`` arrays: the clamped indices, the gathered and
multiplied values (in place), and the pad mask.
"""

from __future__ import annotations

import torch

from ..ell import DeviceELL


def spmv_ell_device(dev: DeviceELL, x: torch.Tensor) -> torch.Tensor:
    """``y = A @ x`` over a :class:`~tpu_spmv_torch.ell.DeviceELL`; ``x``
    holds at least ``num_cols`` f32 values on the matrix's device.  Returns
    ``(num_rows,)`` f32."""
    if x.device != dev.device or x.dim() != 1 or x.numel() < dev.num_cols:
        raise ValueError(f"the flat ELL path takes 1-D x of {dev.num_cols} "
                         f"values on {dev.device}; got {tuple(x.shape)} on "
                         f"{x.device}")
    if not (dev.max_nnz_per_row and dev.num_cols):
        return torch.zeros(dev.num_rows, dtype=torch.float32,
                           device=dev.device)
    cols = dev.col_indices
    prod = x.index_select(0, cols.clamp(min=0).view(-1)).view(cols.shape)
    prod.mul_(dev.values).masked_fill_(cols < 0, 0.0)
    return prod.sum(0)[:dev.num_rows]
