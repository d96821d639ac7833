"""GCN's renormalised adjacency of Graph500's Kronecker graph.

A GCN layer (Kipf & Welling, "Semi-Supervised Classification with Graph
Convolutional Networks", ICLR 2017, eq. 2, the renormalisation trick)
propagates node features as ``H' = σ(Â · H · W)`` with ``Â = D̃^-1/2 (A +
I) D̃^-1/2``: the undirected graph's adjacency ``A`` with a self-loop on
every vertex, scaled on both sides by ``D̃``, the degrees counted with
that loop.  Its sparse step, ``Â · H``, is what this law's matrix serves.

The graph is the ``graph500`` law's (``graph500.py``'s ``structure``:
Graph500's Kronecker edges, labels permuted, self-loops dropped,
duplicates merged, each edge stored both ways), drawn from the
configuration's ``structure_seed``.  Here a self-loop is added to every
vertex, and each entry ``(i, j)`` of ``Â`` is ``1 / sqrt(d̃_i d̃_j)``,
worked out in float64 and stored in float32; an isolated vertex keeps its
loop alone and reads 1.  ``Â`` is symmetric and fixed by the graph: the
run's seed draws nothing here (the loop draws the operands from it).

Configuration keys: those of ``graph500.py`` (``structure_seed``,
``scale``, ``edgefactor``, ``a``, ``b``, ``c``).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from spmvbench.reference.matrix import Matrix
from spmvbench.run import load_module

graph500 = load_module(os.path.join(os.path.dirname(os.path.abspath(
    __file__)), "graph500.py"), "generator_graph500")


def generate(config: dict, seed: int = 0, device="cpu") -> Matrix:
    """``Â`` of the configuration's graph, drawn and normalised on
    ``device`` (the run's ``seed`` is not used)."""
    return normalised(graph500.structure(
        config, int(config["structure_seed"]), device), device)


def normalised(m: Matrix, device) -> Matrix:
    """``D̃^-1/2 (m + I) D̃^-1/2`` of the pattern of ``m`` (square, with no
    stored diagonal), as host arrays: the loops merged into each row in
    column order, the values from float64 degrees."""
    n = m.num_rows
    ptr = torch.from_numpy(m.row_ptrs.astype(np.int64)).to(device)
    rows = torch.repeat_interleave(torch.arange(n, device=device),
                                   torch.diff(ptr))
    cols = torch.from_numpy(m.col_indices.astype(np.int64)).to(device)
    key = torch.cat((rows * n + cols,
                     torch.arange(n, device=device) * (n + 1)))
    del rows, cols, ptr
    key = torch.sort(key).values
    rows, cols = key // n, key % n
    del key
    deg = torch.bincount(rows, minlength=n)
    scale = deg.double().rsqrt()
    vals = (scale[rows] * scale[cols]).float()
    row_ptrs = torch.zeros(n + 1, dtype=torch.int64, device=device)
    row_ptrs[1:] = torch.cumsum(deg, 0)
    return Matrix(n, n, vals.cpu().numpy(), cols.int().cpu().numpy(),
                  row_ptrs.int().cpu().numpy())
