"""Power-law row lengths, uniform distinct columns: a frozen copy of
``tpu_spmv_torch.utils.testing.RandomGenerator.power_law_csr`` (the JAX
bench's headline law, ``bench.py:69-75``), draw for draw.

The structure is the deployment's, drawn from the configuration's
``structure_seed`` (so every run does the same work); the values, uniform
in [-10, 10) as that generator draws them, come from the run's seed.

Configuration keys: ``rows``, ``cols``, ``avg_nnz``, ``alpha``,
``structure_seed``.
"""

from __future__ import annotations

import numpy as np

from spmvbench.reference.matrix import Matrix


def generate(config: dict, seed: int, device=None) -> Matrix:
    """The matrix, on the host (as the program's law draws it)."""
    m = structure(config, int(config["structure_seed"]))
    vals = np.random.Generator(np.random.MT19937(seed)).uniform(
        -10, 10, m.nnz).astype(np.float32)
    vals[vals == 0.0] = 1.0
    return Matrix(m.num_rows, m.num_cols, vals, m.col_indices, m.row_ptrs)


def structure(config: dict, seed: int) -> Matrix:
    """The frozen copy itself: the matrix ``power_law_csr`` draws from
    ``seed``, values and all."""
    rng = np.random.Generator(np.random.MT19937(seed))
    rows, cols = int(config["rows"]), int(config["cols"])
    raw = rng.pareto(float(config["alpha"]), rows) + 1.0
    lens = np.minimum((raw * float(config["avg_nnz"]) / raw.mean())
                      .astype(np.int64), cols)
    row_ptrs = np.zeros(rows + 1, np.int32)
    np.cumsum(lens, out=row_ptrs[1:])
    nnz = int(row_ptrs[-1])
    cols_arr = np.empty(nnz, np.int32)
    for i in range(rows):  # sorted unique columns per row
        k = int(lens[i])
        if k:
            cols_arr[row_ptrs[i]:row_ptrs[i + 1]] = np.sort(
                rng.choice(cols, size=k, replace=False))
    vals = rng.uniform(-10, 10, nnz).astype(np.float32)
    vals[vals == 0.0] = 1.0
    return Matrix(rows, cols, vals, cols_arr, row_ptrs)
