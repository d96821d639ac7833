"""Test utilities (port of ``tpu_spmv/utils/testing.py``).

The generators make the same NumPy draws in the same order as the JAX
package's, so one seed gives the identical matrix in both packages.
:func:`clustered_csr` and :func:`scrambled_banded_csr` plant the block-coarse
locality that block reordering (:mod:`tpu_spmv_torch.kernels.reorder`)
recovers; :func:`web_graph_csr` and :func:`transition_matrix` make the
JAX bench's PageRank matrix, :func:`stencil_csr` its 5-point stencil.
"""

from __future__ import annotations

import numpy as np

DEFAULT_SEED = 42


class RandomGenerator:
    """Seeded RNG (reference mt19937 with seed 42, ``test_utils.h:12-32``)."""

    def __init__(self, seed: int = DEFAULT_SEED):
        self.rng = np.random.Generator(np.random.MT19937(seed))

    def uniform(self, lo: float, hi: float) -> float:
        return float(self.rng.uniform(lo, hi))

    def uniform_int(self, lo: int, hi: int) -> int:
        """Inclusive range, like std::uniform_int_distribution."""
        return int(self.rng.integers(lo, hi + 1))

    def dense_matrix(self, rows: int, cols: int, density: float = 0.1,
                     lo: float = -10.0, hi: float = 10.0) -> np.ndarray:
        """Random dense matrix with ~density fraction of non-zeros
        (reference ``generateRandomDenseMatrix``)."""
        keep = self.rng.random((rows, cols)) < density
        vals = self.rng.uniform(lo, hi, (rows, cols)).astype(np.float32)
        return np.where(keep, vals, np.float32(0.0)).astype(np.float32)

    def vector(self, n: int, lo: float = -10.0,
               hi: float = 10.0) -> np.ndarray:
        """Random f32 vector (reference ``generateRandomVector``)."""
        return self.rng.uniform(lo, hi, n).astype(np.float32)

    def csr(self, rows: int, cols: int, density: float = 0.1):
        """Random CSRMatrix via a dense round trip."""
        from ..csr import CSRMatrix

        return CSRMatrix.from_dense(self.dense_matrix(rows, cols, density))

    def power_law_csr(self, rows: int, cols: int, avg_nnz: float = 8.0,
                      alpha: float = 1.5):
        """Skewed (power-law row-length) CSRMatrix — the workload class the
        merge-path kernel targets."""
        from ..csr import CSRMatrix

        raw = self.rng.pareto(alpha, rows) + 1.0
        lens = np.minimum((raw * avg_nnz / raw.mean()).astype(np.int64), cols)
        row_ptrs = np.zeros(rows + 1, np.int32)
        np.cumsum(lens, out=row_ptrs[1:])
        nnz = int(row_ptrs[-1])
        cols_arr = np.empty(nnz, np.int32)
        for i in range(rows):  # sorted unique columns per row
            k = int(lens[i])
            if k:
                cols_arr[row_ptrs[i]:row_ptrs[i + 1]] = np.sort(
                    self.rng.choice(cols, size=k, replace=False)
                )
        vals = self.rng.uniform(-10, 10, nnz).astype(np.float32)
        vals[vals == 0.0] = 1.0
        return CSRMatrix(rows, cols, vals, cols_arr, row_ptrs)


def web_graph_csr(rng: RandomGenerator, rows: int, cols: int,
                  avg_nnz: float = 16.0, alpha_row: float = 1.6,
                  col_beta: float = 2.5):
    """Web-graph-like CSR: power-law row lengths and power-law column
    popularity (hub columns), ``tpu_spmv/utils/testing.py:76-102``."""
    from ..csr import CSRMatrix

    raw = rng.rng.pareto(alpha_row, rows) + 1.0
    lens = np.minimum((raw * avg_nnz / raw.mean()).astype(np.int64), cols)
    total = int(lens.sum())
    rr = np.repeat(np.arange(rows, dtype=np.int64), lens)
    u = rng.rng.random(total)
    cc = np.minimum((cols * u ** col_beta).astype(np.int64), cols - 1)
    key = np.unique(rr * cols + cc)   # dedupe + sort (rows major, cols asc)
    rr2 = (key // cols).astype(np.int64)
    cc2 = (key % cols).astype(np.int32)
    row_ptrs = np.zeros(rows + 1, np.int32)
    np.cumsum(np.bincount(rr2, minlength=rows), out=row_ptrs[1:])
    vals = rng.rng.uniform(0.1, 1.0, len(key)).astype(np.float32)
    return CSRMatrix(rows, cols, vals, cc2, row_ptrs)


def transition_matrix(adj):
    """The column-normalised transition matrix of ``adj``'s structure, as
    the JAX bench makes its PageRank matrix (``bench.py:291-297``): every
    stored entry of column j is ``1 / outdeg(j)``, the column's count of
    stored entries."""
    from ..csr import CSRMatrix

    outd = np.bincount(adj.col_indices,
                       minlength=adj.num_cols).astype(np.float32)
    vals = (1.0 / np.maximum(outd, 1.0)[adj.col_indices]).astype(np.float32)
    return CSRMatrix(adj.num_rows, adj.num_cols, vals, adj.col_indices,
                     adj.row_ptrs)


def clustered_csr(rng: RandomGenerator, n: int, n_clusters: int = 32,
                  avg_nnz: float = 14.0, p_out: float = 0.05,
                  alpha_row: float = 1.6, block_shuffle: bool = True):
    """Square CSR with planted block-coarse locality: rows fall into
    contiguous latent clusters, each row keeps ``1 - p_out`` of its
    (power-law-length) edges inside its cluster, and the labels are then
    scrambled by a random symmetric permutation of 128-blocks (the community
    graph class that block reordering recovers).  ``block_shuffle=False``
    returns the latent order."""
    from ..csr import CSRMatrix

    gen = rng.rng
    raw = gen.pareto(alpha_row, n) + 1.0
    lens = np.minimum((raw * avg_nnz / raw.mean()).astype(np.int64), n)
    total = int(lens.sum())
    rr = np.repeat(np.arange(n, dtype=np.int64), lens)
    c_of = rr * n_clusters // n
    c_lo = c_of * n // n_clusters
    c_hi = (c_of + 1) * n // n_clusters
    cc = c_lo + (gen.random(total) * (c_hi - c_lo)).astype(np.int64)
    out = gen.random(total) < p_out                  # global (noise) edges
    cc[out] = (gen.random(int(out.sum())) * n).astype(np.int64)
    if block_shuffle:
        nb = -(-n // 128)
        bperm = gen.permutation(nb)                  # latent blk -> new blk
        rr = bperm[rr // 128] * 128 + rr % 128
        cc = bperm[cc // 128] * 128 + cc % 128
        n = nb * 128
    key = np.unique(rr * n + cc)
    rr2, cc2 = key // n, (key % n).astype(np.int32)
    row_ptrs = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(rr2, minlength=n), out=row_ptrs[1:])
    vals = gen.uniform(0.1, 1.0, len(key)).astype(np.float32)
    return CSRMatrix(int(n), int(n), vals, cc2, row_ptrs)


def scrambled_banded_csr(rng: RandomGenerator, n: int, bandwidth: int = 4096,
                         avg_nnz: float = 12.0, alpha_row: float = 1.8,
                         scramble: bool = True):
    """Square CSR with latent banded structure (the mesh and road-network
    class: every edge within ``bandwidth`` of the diagonal), scrambled by a
    random symmetric 128-block permutation unless ``scramble=False``."""
    from ..csr import CSRMatrix

    gen = rng.rng
    lens = np.maximum(np.minimum(
        ((gen.pareto(alpha_row, n) + 1.0) * avg_nnz / 2).astype(np.int64),
        bandwidth), 1)
    rr = np.repeat(np.arange(n, dtype=np.int64), lens)
    off = (gen.random(len(rr)) * 2 * bandwidth - bandwidth).astype(np.int64)
    cc = np.clip(rr + off, 0, n - 1)
    if scramble:
        nb = -(-n // 128)
        bperm = gen.permutation(nb)
        rr = bperm[rr // 128] * 128 + rr % 128
        cc = bperm[cc // 128] * 128 + cc % 128
        n = nb * 128
    key = np.unique(rr * n + cc)
    rr2, cc2 = key // n, (key % n).astype(np.int32)
    row_ptrs = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(rr2, minlength=n), out=row_ptrs[1:])
    vals = gen.uniform(0.1, 1.0, len(key)).astype(np.float32)
    return CSRMatrix(int(n), int(n), vals, cc2, row_ptrs)


def stencil_csr(g: int):
    """The 5-point Laplacian stencil on a ``g x g`` grid (4 on the
    diagonal, -1 at each of the four neighbours), rows sorted by column:
    the JAX bench's ELL matrix (``bench.py:226-245``)."""
    from ..csr import CSRMatrix

    N = g * g
    ii = np.arange(N)
    rl, cl, vl = [], [], []
    for (dr, dc, v) in [(0, 0, 4.0), (-1, 0, -1.0), (1, 0, -1.0),
                        (0, -1, -1.0), (0, 1, -1.0)]:
        r, c = ii // g, ii % g
        rr2, cc2 = r + dr, c + dc
        m = (rr2 >= 0) & (rr2 < g) & (cc2 >= 0) & (cc2 < g)
        rl.append(ii[m])
        cl.append((rr2 * g + cc2)[m])
        vl.append(np.full(int(m.sum()), v, np.float32))
    ra = np.concatenate(rl)
    ca = np.concatenate(cl)
    va = np.concatenate(vl)
    o = np.lexsort((ca, ra))
    rp = np.zeros(N + 1, np.int32)
    np.cumsum(np.bincount(ra, minlength=N), out=rp[1:])
    return CSRMatrix(N, N, va[o], ca[o].astype(np.int32), rp)


def abs_row_scale(csr, x) -> np.ndarray:
    """``(|A| |x|)_i`` per row: the magnitude that bounds the rounding error
    of any summation order of row ``i``."""
    scale = np.zeros(csr.num_rows, np.float32)
    if csr.nnz:
        mags = np.abs(csr.values) \
            * np.abs(np.asarray(x, np.float32))[csr.col_indices]
        row_ids = np.repeat(np.arange(csr.num_rows), np.diff(csr.row_ptrs))
        np.add.at(scale, row_ids, mags)
    return scale


def spmv_matches(y_dev, csr, x, rel_tol: float = 1e-6) -> bool:
    """Device-vs-oracle comparison with the backward-error bound for
    reordered summation: per element, either the plain relative test of
    :func:`spmv_rel_equal` holds for the whole vector, or
    ``|y - ŷ|_i <= rel_tol * max((|A| |x|)_i, 1)``."""
    from ..ops.cpu_reference import spmv_cpu_csr

    y_dev = np.asarray(y_dev, np.float32)
    y_ref = np.zeros(csr.num_rows, np.float32)
    spmv_cpu_csr(csr, x, y_ref)
    if y_dev.shape != y_ref.shape:
        return False
    diff = np.abs(y_dev - y_ref)
    plain = spmv_rel_equal(y_dev, y_ref, rel_tol)
    return bool(plain or np.all(
        diff <= rel_tol * np.maximum(abs_row_scale(csr, x), 1.0)))


def spmv_rel_equal(gpu, cpu, rel_tol: float = 1e-6) -> bool:
    """Relative tolerance with an absolute floor when both magnitudes are
    below 1e-10 (reference ``test_spmv.cu:18-35``)."""
    gpu = np.asarray(gpu, np.float32)
    cpu = np.asarray(cpu, np.float32)
    if gpu.shape != cpu.shape:
        return False
    both_tiny = (np.abs(gpu) < 1e-10) & (np.abs(cpu) < 1e-10)
    diff = np.abs(gpu - cpu)
    denom = np.maximum(np.abs(cpu), 1e-30)
    ok = both_tiny | (diff <= 1e-6) | (diff / denom <= rel_tol)
    return bool(np.all(ok))
