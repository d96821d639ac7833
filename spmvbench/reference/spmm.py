"""The plain SpMM reference, its byte and operation models, and the gap of
an output from it: ``Y = A @ H`` for a dense row-major ``H`` of ``(cols,
k)``, in float64 (gather, multiply, ``index_add_``).

It reads only a :class:`~spmvbench.reference.matrix.Matrix` and operands
the harness made, on whatever device it is given.  The product is taken
in blocks of :data:`BLOCK_COLS` columns and of ``plain.BLOCK_NNZ``
nonzeros, so that a block's gathered rows and products stay at 1 GiB each.
"""

from __future__ import annotations

import torch

from . import plain

# columns of H a block of the product takes (its float64 rows of H, Y and
# |A| @ |H|: rows x 32 x 8 B each)
BLOCK_COLS = 32


def spmm_bytes(rows: int, cols: int, nnz: int, k: int) -> int:
    """The least bytes of ``Y = A @ H`` for a ``(cols, k)`` f32 ``H``: the
    values and column indices read (8 B a nonzero), the row pointers read,
    ``H`` read once and ``Y`` written once."""
    return nnz * 8 + (rows + 1) * 4 + cols * k * 4 + rows * k * 4


def spmm_ops(nnz: int, k: int) -> int:
    """The floating-point operations of ``Y = A @ H`` for a ``(cols, k)``
    ``H``: a multiply and an add a nonzero and a column."""
    return 2 * nnz * k


def products(op: plain.Operator, h: torch.Tensor) -> tuple:
    """``(A @ h, |A| @ |h|)`` in float64 for a block ``h`` of columns."""
    h = h.to(op.device, torch.float64)
    ref = torch.zeros((op.n_rows, h.shape[1]), dtype=torch.float64,
                      device=op.device)
    scale = torch.zeros_like(ref)
    for lo, hi in op.blocks():
        v, g = op.vals[lo:hi, None], h[op.cols[lo:hi]]
        r = op.rows[lo:hi]
        ref.index_add_(0, r, v * g)
        scale.index_add_(0, r, v.abs() * g.abs())
    return ref, scale


def output_gap(op: plain.Operator, H: torch.Tensor, ys: list) -> float:
    """The widest entry of ``|y − A @ H| ÷ (|A| @ |H|)`` over the rows and
    columns of each ``y`` in ``ys`` (an entry with nothing to add is held
    to 0 absolutely), ``A`` the operator ``op``; ``inf`` for a ``y`` that
    is missing or of another shape."""
    k = H.shape[1]
    if any(y is None or tuple(y.shape) != (op.n_rows, k) for y in ys):
        return float("inf")
    gap = 0.0
    for c0 in range(0, k, BLOCK_COLS):
        ref, scale = products(op, H[:, c0:c0 + BLOCK_COLS])
        for y in ys:
            gap = max(gap, plain.output_gap(y[:, c0:c0 + BLOCK_COLS], ref,
                                            scale))
        del ref, scale
    return gap
