"""The plain reference: a float64 CSR product and a float64 power
iteration in plain PyTorch (gather, multiply, ``index_add_``), and the
bfloat16 power iteration that stands in as the PageRank control.

It reads only a :class:`~spmvbench.reference.matrix.Matrix` and vectors
the harness made; the dangling mask and the column sums are worked out
here again.  It runs on whatever device it is given, in blocks of nonzeros
so that its temporaries stay small.
"""

from __future__ import annotations

import numpy as np
import torch

from .matrix import Matrix

# nonzeros a block of the product gathers at once
BLOCK_NNZ = 1 << 22


class Operator:
    """``A`` on ``device``, its values in ``dtype``, for repeated
    products."""

    def __init__(self, A: Matrix, device, dtype=torch.float64):
        self.n_rows, self.n_cols = A.num_rows, A.num_cols
        self.device = torch.device(device)
        ptr = A.row_ptrs.astype(np.int64)
        self.ptr = ptr
        rows = np.repeat(np.arange(A.num_rows, dtype=np.int64), np.diff(ptr))
        self.rows = torch.from_numpy(rows).to(self.device)
        self.cols = torch.from_numpy(
            A.col_indices.astype(np.int64)).to(self.device)
        self.vals = torch.from_numpy(A.values).to(self.device).to(dtype)
        self.dtype = dtype

    def blocks(self):
        """``(lo, hi)`` nonzero ranges of at most ``BLOCK_NNZ``."""
        nnz = int(self.ptr[-1])
        for lo in range(0, nnz, BLOCK_NNZ):
            yield lo, min(lo + BLOCK_NNZ, nnz)

    def matvec(self, x: torch.Tensor, absolute: bool = False,
               acc=torch.float64) -> torch.Tensor:
        """``A @ x`` (or ``|A| @ |x|``), the products and sums in ``acc``."""
        x = x.to(self.device, self.dtype)
        y = torch.zeros(self.n_rows, dtype=acc, device=self.device)
        for lo, hi in self.blocks():
            v, xg = self.vals[lo:hi].to(acc), x[self.cols[lo:hi]].to(acc)
            p = (v.abs() * xg.abs()) if absolute else v * xg
            y.index_add_(0, self.rows[lo:hi], p)
        return y


def csr_product(A: Matrix, xs: torch.Tensor, device) -> tuple:
    """``(A @ x, |A| @ |x|)`` in float64 for each row of ``xs``."""
    op = Operator(A, device)
    ys, scales = [], []
    for x in xs:
        ys.append(op.matvec(x))
        scales.append(op.matvec(x, absolute=True))
    return ys, scales


def output_gap(y: torch.Tensor, ref: torch.Tensor,
               scale: torch.Tensor) -> float:
    """The widest gap of ``y`` from ``ref`` over the rows, each against
    ``(|A| @ |x|)`` of its row, the size its rounding scales with (a row
    with nothing to add is held to 0 absolutely)."""
    if y is None or y.shape != ref.shape:
        return float("inf")
    den = torch.where(scale > 0, scale, torch.ones_like(scale))
    gap = (y.to(ref.device, torch.float64) - ref).abs() / den
    g = float(gap.max()) if gap.numel() else 0.0
    return float("inf") if g != g else g


def dangling_mask(A: Matrix, device) -> torch.Tensor:
    """1.0 for every column whose stored values sum to zero, in float64."""
    sums = np.zeros(A.num_cols, np.float64)
    np.add.at(sums, A.col_indices, A.values.astype(np.float64))
    return torch.from_numpy((sums == 0.0).astype(np.float64)).to(device)


def pagerank_iterates(P: Matrix, damping: float, tolerance: float,
                      max_iterations: int, keep: set, device) -> tuple:
    """The power iteration of ``tpu_spmv_torch.pagerank`` in float64:
    ``r_new = d*(P @ r) + d*(mask . r)/n + (1-d)/n`` from ``r = 1/n``,
    stopping at the first iteration whose L2 step is not at least the
    tolerance, or at ``max_iterations``.  It runs on past that stop as far
    as the largest count in ``keep``.  Returns ``(stop, {k: ranks after k
    iterations, renormalised to sum 1, for k in keep}, [the L2 step of
    each iteration])``."""
    n = P.num_rows
    op = Operator(P, device)
    mask = dangling_mask(P, device)
    r = torch.full((n,), 1.0 / n, dtype=torch.float64, device=device)
    out, steps, stop = {}, [], None
    last = max(keep, default=0)
    while stop is None or len(steps) < last:
        r_new = damping * op.matvec(r) + damping * torch.dot(mask, r) / n \
            + (1.0 - damping) / n
        steps.append(float(torch.linalg.vector_norm(r_new - r)))
        r, k = r_new, len(steps)
        if k in keep:
            out[k] = r / r.sum()
        if stop is None and (not steps[-1] >= tolerance
                             or k >= max_iterations):
            stop = k
    return stop, out, steps


def pagerank_bf16(P: Matrix, damping: float, tolerance: float,
                  max_iterations: int, device) -> tuple:
    """The control: the same power iteration with the matrix and the ranks
    held in bfloat16, products and sums in float32, the precision below
    the configuration's float32.  Returns ``(iterations, ranks)`` like
    ``PageRankResult``, the ranks float32 and renormalised."""
    n = P.num_rows
    op = Operator(P, device, dtype=torch.bfloat16)
    mask = dangling_mask(P, device).float()
    r = torch.full((n,), 1.0 / n, dtype=torch.float32,
                   device=device).bfloat16()
    k = 0
    while k < max_iterations:
        rf = r.float()
        r_new = damping * op.matvec(r, acc=torch.float32) \
            + damping * torch.dot(mask, rf) / n + (1.0 - damping) / n
        res = float(torch.linalg.vector_norm(r_new - rf))
        r, k = r_new.bfloat16(), k + 1
        if not res >= tolerance:
            break
    rf = r.float()
    return k, rf / rf.sum()
