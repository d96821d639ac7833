"""Byte models and the table of peaks: the least work an SpMV needs.

Both models count what the inputs need, read once, and the output written
once, whatever a plan streams (its padding, tables and partial sums are the
program's cost, not the problem's), so a plan that pads less reads a
higher share of the roofline.
"""

from __future__ import annotations

# Published HBM bandwidth of each card, bytes/s: NVIDIA's H100 SXM data
# sheet (80 GB HBM3, 3.35 TB/s at the full 700 W power limit).  A card not
# in the table has no roofline: its readers report nothing.
PEAK_BYTES_PER_S = {
    "NVIDIA H100 80GB HBM3": 3.35e12,
}


def csr_bytes(rows: int, cols: int, nnz: int) -> int:
    """The CSR byte model of ``y = A @ x`` (the reference's
    ``bandwidth.cpp:34-42``): values and column indices read, 8 B a
    nonzero; the row pointers and ``x`` read; ``y`` written."""
    return nnz * 8 + (rows + 1) * 4 + cols * 4 + rows * 4


def pattern_bytes(n: int, nnz: int) -> int:
    """The byte model of one PageRank SpMV on a column-normalised ``n x n``
    matrix: its values are one per column, so the product reads the column
    indices (4 B a nonzero), the row pointers, the column scale and the
    ranks, and writes the new ranks."""
    return nnz * 4 + (n + 1) * 4 + 2 * n * 4 + n * 4


def peak_bytes_per_s(kind: str) -> float | None:
    """The published peak of the card named ``kind``, or ``None``."""
    return PEAK_BYTES_PER_S.get(kind)
