"""The flat CSR path (port of ``tpu_spmv/kernels/scalar.py``): the
universal floor of the dispatch.

    y = segment_sum(values * x[col_indices], row_ptrs)

a gather, a multiply and a reduction over the row pointers, as plain
PyTorch ops (the JAX package leaves this path to XLA, not Pallas, so it has
no kernel of its own).  It serves what every packed layout rejects, the
ELL_KERNEL type on a CSR, ``use_vmem_x=False``, and a composite plan's
tail.  It is deterministic: ``torch.segment_reduce`` sums each row in a
fixed order (on the card, one segmented reduction, no atomics); neither
``index_add_`` (atomics on CUDA) nor cuSPARSE is used.  It needs no
padding: the JAX package pads x (``pad_x``) and the matrix to static
shapes for XLA.
"""

from __future__ import annotations

import torch

from ..csr import DeviceCSR


def spmv_csr_scalar(dev: DeviceCSR, x: torch.Tensor) -> torch.Tensor:
    """``y = A @ x`` over a :class:`~tpu_spmv_torch.csr.DeviceCSR`; ``x``
    holds at least ``num_cols`` f32 values on the matrix's device.  Returns
    ``(num_rows,)`` f32, an empty row 0."""
    if x.device != dev.device or x.dim() != 1 or x.numel() < dev.num_cols:
        raise ValueError(f"the flat path takes 1-D x of {dev.num_cols} "
                         f"values on {dev.device}; got {tuple(x.shape)} on "
                         f"{x.device}")
    if not dev.nnz:
        return torch.zeros(dev.num_rows, dtype=torch.float32,
                           device=dev.device)
    prod = dev.values * x.index_select(0, dev.col_indices)
    # unsafe: the offsets were checked when the matrix was uploaded
    # (DeviceCSR.from_host); the checks would read them back to the host
    return torch.segment_reduce(prod, "sum", offsets=dev.row_ptrs,
                                unsafe=True)
