"""Matrix Market IO (port of ``tpu_spmv/io/matrix_market.py``).

Sparse workloads arrive as SuiteSparse ``.mtx`` files.  The file is parsed
by the planner library's native reader (streaming, symmetric entries
expanded) where it is built, else by a Python one, and converted to CSR by
its stable counting sort (:func:`~tpu_spmv_torch.native.mtx_read`,
:func:`~tpu_spmv_torch.native.coo_to_csr`).
"""

from __future__ import annotations

import numpy as np

from ..csr import CSRMatrix
from ..errors import FileIOError
from ..native import coo_to_csr, mtx_read


def load_matrix_market(path: str) -> CSRMatrix:
    """A coordinate Matrix Market file as a :class:`CSRMatrix`: real,
    integer or pattern fields, general or symmetric.  Duplicate
    coordinates are summed (Matrix Market semantics); each row's columns
    come out ascending, as ``from_dense`` gives them."""
    num_rows, num_cols, rows, cols, vals = mtx_read(path)
    if len(rows):
        key = rows.astype(np.int64) * num_cols + cols.astype(np.int64)
        order = np.argsort(key, kind="stable")
        key, vals = key[order], vals[order]
        uniq, start = np.unique(key, return_index=True)
        vals = np.add.reduceat(vals.astype(np.float64), start) \
            .astype(np.float32)
        rows = (uniq // num_cols).astype(np.int32)
        cols = (uniq % num_cols).astype(np.int32)
    row_ptrs, out_cols, out_vals = coo_to_csr(num_rows, rows, cols, vals)
    return CSRMatrix(num_rows, num_cols, out_vals, out_cols, row_ptrs)


def save_matrix_market(mat: CSRMatrix, path: str,
                       comment: str = "generated by tpu_spmv") -> None:
    """Write ``mat`` as a general real coordinate Matrix Market file, the
    values with 9 significant digits (an f32 read back exactly)."""
    try:
        with open(path, "w") as f:
            f.write("%%MatrixMarket matrix coordinate real general\n")
            f.write(f"% {comment}\n")
            f.write(f"{mat.num_rows} {mat.num_cols} {mat.nnz}\n")
            rows = np.repeat(np.arange(mat.num_rows), np.diff(mat.row_ptrs))
            for r, c, v in zip(rows, mat.col_indices, mat.values):
                f.write(f"{r + 1} {c + 1} {v:.9g}\n")
    except OSError as e:
        raise FileIOError(str(e)) from e
