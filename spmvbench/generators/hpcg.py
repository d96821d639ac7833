"""The HPCG operator: the 27-point stencil of ``GenerateProblem_ref`` (HPCG
3.1, ``src/GenerateProblem_ref.cpp``) on an ``nx × ny × nz`` local grid
of one rank, with no halo.

Rows are the grid points in natural order, x fastest: row ``ix + nx*iy +
nx*ny*iz``.  Each row holds the points ``(ix+sx, iy+sy, iz+sz)``, ``s*``
in {-1, 0, 1}, that lie in the grid, in HPCG's loop order (``sz``
outermost, ``sx`` innermost), so its columns ascend: 26.0 on the
diagonal and -1.0 for each neighbour.  A boundary row holds 8, 12 or 18
entries, an interior row 27.

The operator is fixed by the grid; nothing comes from the run's seed.

Configuration keys: ``nx``, ``ny``, ``nz``.
"""

from __future__ import annotations

import numpy as np

from spmvbench.reference.matrix import Matrix

DIAGONAL = 26.0
OFF_DIAGONAL = -1.0


def generate(config: dict, seed: int = 0, device=None) -> Matrix:
    """The operator of ``config``'s grid (the run's ``seed`` and ``device``
    are not used)."""
    return operator(int(config["nx"]), int(config["ny"]), int(config["nz"]))


def operator(nx: int, ny: int, nz: int) -> Matrix:
    """The 27-point operator on an ``nx × ny × nz`` grid as CSR, built one
    stencil offset at a time over all rows (27 passes of numpy, not a loop
    over the rows)."""
    n = nx * ny * nz
    ix = np.arange(nx, dtype=np.int64)
    iy = np.arange(ny, dtype=np.int64)
    iz = np.arange(nz, dtype=np.int64)
    cols = np.empty((n, 27), np.int64)
    valid = np.empty((n, 27), bool)
    k = 0
    for sz in (-1, 0, 1):
        for sy in (-1, 0, 1):
            for sx in (-1, 0, 1):
                inside = (((iz + sz >= 0) & (iz + sz < nz))[:, None, None]
                          & ((iy + sy >= 0) & (iy + sy < ny))[None, :, None]
                          & ((ix + sx >= 0) & (ix + sx < nx))[None, None, :])
                valid[:, k] = inside.ravel()
                cols[:, k] = np.arange(n, dtype=np.int64) \
                    + sz * nx * ny + sy * nx + sx
                k += 1
    row_ptrs = np.zeros(n + 1, np.int64)
    np.cumsum(valid.sum(axis=1), out=row_ptrs[1:])
    col_indices = cols[valid].astype(np.int32)
    values = np.where(col_indices == np.repeat(
        np.arange(n, dtype=np.int32), np.diff(row_ptrs)),
        np.float32(DIAGONAL), np.float32(OFF_DIAGONAL))
    return Matrix(n, n, values.astype(np.float32), col_indices,
                  row_ptrs.astype(np.int32))
