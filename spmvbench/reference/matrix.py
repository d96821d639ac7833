"""The benchmark's own CSR container and the transition matrix.

The harness makes every matrix as a :class:`Matrix` of NumPy arrays and
hands the same arrays to the program (wrapped in its own container) and to
the plain reference; nothing the program derives from them is read back.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class Matrix:
    """CSR in three arrays: ``values`` f32, ``col_indices`` i32,
    ``row_ptrs`` i32 of ``num_rows + 1``."""

    num_rows: int
    num_cols: int
    values: np.ndarray
    col_indices: np.ndarray
    row_ptrs: np.ndarray

    @property
    def nnz(self) -> int:
        return int(self.values.size)


def transition_matrix(adj: Matrix) -> Matrix:
    """The column-normalised transition matrix of ``adj``'s structure: every
    stored entry of column j is ``1 / outdeg(j)``, the column's count of
    stored entries (a frozen copy of ``tpu_spmv_torch.utils.testing``'s
    ``transition_matrix``, the JAX bench's PageRank matrix)."""
    outd = np.bincount(adj.col_indices,
                       minlength=adj.num_cols).astype(np.float32)
    vals = (1.0 / np.maximum(outd, 1.0)[adj.col_indices]).astype(np.float32)
    return Matrix(adj.num_rows, adj.num_cols, vals, adj.col_indices,
                  adj.row_ptrs)
