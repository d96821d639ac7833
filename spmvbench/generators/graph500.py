"""Graph500's Kronecker graph, undirected, drawn on the run's device.

The edge list follows the Graph500 reference generator
(``kronecker_generator.m`` of the Graph500 specification, as
``tpu_spmv_torch.benchmarks.mtx_bench``'s ``rmat_csr`` draws it on the
host): ``edgefactor * 2**scale`` edges, each of the ``scale`` bits of an
edge's two ends falling into the initiator's quadrants A, B, C and
D = 1 - A - B - C.  As the specification's generator does, the vertex
labels are then permuted at random; as its kernel 1 may, self-loops are
dropped and duplicate edges merged; and each edge is stored in both
directions, so the matrix is the symmetric adjacency of the undirected
graph.

The draws are made on the device with a ``torch.Generator`` in a few large
calls (the structure of a CUDA run is the same on every run of one
machine; a CPU run draws another graph of the same law).  The graph is the
deployment's, drawn from the configuration's ``structure_seed`` (so every
run does the same work); the edge values, uniform in [0.1, 1), come from
the run's seed.

Configuration keys: ``structure_seed``, ``scale`` (``2**scale``
vertices, Graph500's SCALE), ``edgefactor`` (edges a vertex, before
duplicates merge), ``a``, ``b``, ``c`` (the initiator's quadrants).
"""

from __future__ import annotations

import numpy as np
import torch

from spmvbench.reference.matrix import Matrix


def generate(config: dict, seed: int, device) -> Matrix:
    m = structure(config, int(config["structure_seed"]), device)
    g = generator(seed, device)
    vals = torch.rand(m.nnz, generator=g, device=device) * 0.9 + 0.1
    return Matrix(m.num_rows, m.num_cols, vals.cpu().numpy(), m.col_indices,
                  m.row_ptrs)


def generator(seed: int, device) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded from all the bits of
    ``seed`` (the CPU's keeps only the low 32 of the seed it is given)."""
    g = torch.Generator(device=device)
    g.manual_seed(int(np.random.SeedSequence(seed).generate_state(
        1, np.uint64)[0]) >> 1)
    return g


def kronecker_edges(g: torch.Generator, scale: int, edgefactor: int,
                    a: float, b: float, c: float) -> tuple:
    """``(sources, targets)``, int64 on ``g``'s device, unpermuted: bit
    ``k`` of a source is 1 with probability ``1 - A - B``; the target's,
    given it, ``B / (A + B)`` or ``D / (C + D)``."""
    n = 1 << scale
    m = n * edgefactor
    dev = g.device
    p0 = b / (a + b)
    p1 = (1 - (a + b + c)) / max(1 - (a + b + c) + c, 1e-9)
    rows = torch.zeros(m, dtype=torch.int32, device=dev)
    cols = torch.zeros(m, dtype=torch.int32, device=dev)
    for lvl in range(scale):
        bit_r = torch.rand(m, generator=g, device=dev) >= a + b
        u = torch.rand(m, generator=g, device=dev)
        bit_c = torch.where(bit_r, u < p1, u < p0)
        del u
        rows |= bit_r.int() << lvl
        cols |= bit_c.int() << lvl
    return rows.long(), cols.long()


def structure(config: dict, seed: int, device) -> Matrix:
    """The undirected graph drawn from ``seed`` on ``device``, every value
    1, as host arrays."""
    g = generator(seed, device)
    scale = int(config["scale"])
    n = 1 << scale
    src, dst = kronecker_edges(g, scale, int(config["edgefactor"]),
                               float(config["a"]), float(config["b"]),
                               float(config["c"]))
    perm = torch.randperm(n, generator=g, device=g.device)
    src, dst = perm[src], perm[dst]
    keep = src != dst
    src, dst = src[keep], dst[keep]
    key = torch.unique(torch.cat((src * n + dst, dst * n + src)))
    del src, dst, keep, perm
    row_ptrs = torch.zeros(n + 1, dtype=torch.int64, device=g.device)
    row_ptrs[1:] = torch.cumsum(torch.bincount(key // n, minlength=n), 0)
    cols = (key % n).int().cpu().numpy()
    return Matrix(n, n, np.ones(cols.size, np.float32), cols,
                  row_ptrs.int().cpu().numpy())
