"""The plain reference against dense products, and the frozen generators
against the program's own."""

import numpy as np
import pytest
import torch

from spmvbench.generators import graph500, power_law
from spmvbench.reference import plain
from spmvbench.reference.matrix import Matrix, transition_matrix


def dense(A: Matrix) -> np.ndarray:
    d = np.zeros((A.num_rows, A.num_cols))
    for i in range(A.num_rows):
        lo, hi = A.row_ptrs[i], A.row_ptrs[i + 1]
        d[i, A.col_indices[lo:hi]] += A.values[lo:hi]
    return d


@pytest.fixture
def small():
    return power_law.generate({"rows": 300, "cols": 77, "avg_nnz": 9,
                               "alpha": 1.4, "structure_seed": 4}, 2**31 + 5,
                              "cpu")


def test_product_against_dense(small, monkeypatch):
    monkeypatch.setattr(plain, "BLOCK_NNZ", 100)   # many blocks
    x = torch.linspace(-1, 1, small.num_cols)
    op = plain.Operator(small, "cpu")
    d = dense(small)
    np.testing.assert_allclose(op.matvec(x).numpy(), d @ x.double().numpy(),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(op.matvec(x, absolute=True).numpy(),
                               np.abs(d) @ np.abs(x.double().numpy()),
                               rtol=1e-12, atol=1e-12)


def test_output_gap(small):
    x = torch.linspace(-1, 1, small.num_cols)
    (ref,), (scale,) = plain.csr_product(small, [x], "cpu")
    y = ref.float()
    assert plain.output_gap(y, ref, scale) < 1e-6
    bad = y.clone()
    bad[7] += 1e-3 * float(scale[7])
    assert plain.output_gap(bad, ref, scale) >= 1e-3 * 0.99
    assert plain.output_gap(y[:-1], ref, scale) == float("inf")
    assert plain.output_gap(None, ref, scale) == float("inf")
    nan = y.clone()
    nan[0] = float("nan")
    assert plain.output_gap(nan, ref, scale) == float("inf")


def test_power_iteration_against_dense():
    g = graph500.generate({"scale": 8, "edgefactor": 6, "a": 0.57,
                           "b": 0.19, "c": 0.19, "structure_seed": 3}, 9,
                          "cpu")
    P = transition_matrix(g)
    d = dense(P)
    n = P.num_rows
    mask = (d.sum(axis=0) == 0).astype(float)
    r = np.full(n, 1.0 / n)
    want, stop = {}, None
    for k in range(1, 101):
        new = 0.85 * d @ r + 0.85 * mask @ r / n + 0.15 / n
        res = np.linalg.norm(new - r)
        r = new
        want[k] = r / r.sum()
        if stop is None and res < 1e-6:
            stop = k
            break
    got_stop, got, steps = plain.pagerank_iterates(
        P, 0.85, 1e-6, 100, {1, stop, stop + 2}, "cpu")
    assert got_stop == stop and len(steps) == stop + 2
    assert steps[stop - 1] < 1e-6 <= steps[stop - 2]
    for k in (1, stop):
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=1e-12)
    assert stop + 2 in got                 # run on past the stop
    it, ranks = plain.pagerank_bf16(P, 0.85, 1e-6, 100, "cpu")
    assert ranks.dtype == torch.float32 and ranks.shape == (n,)
    assert abs(float(ranks.sum()) - 1.0) < 1e-5
    gap = float(((ranks.double() - got[stop]).abs() / got[stop]).max()) \
        if it == stop else None
    assert gap is None or gap > 1e-4       # bf16 shows


def test_generators_follow_the_programs():
    from tpu_spmv_torch.benchmarks.mtx_bench import rmat_csr
    from tpu_spmv_torch.utils.testing import (RandomGenerator,
                                              transition_matrix as tm)

    seed = 2**33 + 3
    pl = {"rows": 500, "cols": 200, "avg_nnz": 10, "alpha": 1.6,
          "structure_seed": seed}
    a = power_law.structure(pl, seed)
    b = RandomGenerator(seed).power_law_csr(500, 200, 10, 1.6)
    g = graph500.structure({"scale": 9, "edgefactor": 16, "a": 0.57,
                            "b": 0.19, "c": 0.19}, seed, "cpu")
    for mine, theirs in ((a, b), (transition_matrix(g), tm(g))):
        assert (mine.num_rows, mine.num_cols) == (theirs.num_rows,
                                                  theirs.num_cols)
        for f in ("values", "col_indices", "row_ptrs"):
            np.testing.assert_array_equal(getattr(mine, f),
                                          getattr(theirs, f))
    # the Kronecker law is rmat_csr's: the same share of distinct edges
    # and the same heaviest row, within sampling
    gen = torch.Generator().manual_seed(seed)
    src, dst = graph500.kronecker_edges(gen, 14, 16, 0.57, 0.19, 0.19)
    key = np.unique((src * 2**14 + dst).numpy())
    r = rmat_csr(RandomGenerator(seed).rng, scale=14, avg_nnz=16)
    assert abs(key.size / r.nnz - 1) < 0.01
    heaviest = np.bincount(key // 2**14).max()
    assert abs(heaviest / np.diff(r.row_ptrs).max() - 1) < 0.1


def test_kronecker_bits_fall_into_the_quadrants():
    gen = torch.Generator().manual_seed(11)
    src, dst = graph500.kronecker_edges(gen, 6, 2**14, 0.57, 0.19, 0.19)
    for k in range(6):
        i, j = (src >> k) & 1, (dst >> k) & 1
        got = [float(((i == p) & (j == q)).double().mean())
               for p, q in ((0, 0), (0, 1), (1, 0), (1, 1))]
        np.testing.assert_allclose(got, [0.57, 0.19, 0.19, 0.05], atol=3e-3)


def test_graph500_graph_is_undirected_and_simple():
    conf = {"scale": 10, "edgefactor": 16, "a": 0.57, "b": 0.19, "c": 0.19}
    g = graph500.structure(conf, 5, "cpu")
    d = dense(g)
    assert g.num_rows == g.num_cols == 1024
    np.testing.assert_array_equal(d, d.T)              # both directions
    assert not d.diagonal().any()                      # no self-loops
    assert set(np.unique(d)) <= {0.0, 1.0}             # duplicates merged
    rows = np.repeat(np.arange(1024), np.diff(g.row_ptrs))
    assert (np.diff(rows * 1024 + g.col_indices) > 0).all()   # sorted
    assert g.col_indices.dtype == g.row_ptrs.dtype == np.int32
    # the labels are permuted: unpermuted, the heaviest vertex is 0
    deg = np.diff(g.row_ptrs)
    assert deg.argmax() != 0 and 0.1 < (deg == 0).mean() < 0.5


@pytest.mark.parametrize("law, conf, lo, hi", [
    (power_law, {"rows": 400, "cols": 90, "avg_nnz": 7, "alpha": 1.6},
     -10.0, 10.0),
    (graph500, {"scale": 8, "edgefactor": 8, "a": 0.57, "b": 0.19,
                "c": 0.19}, 0.1, 1.0)])
def test_the_structure_is_fixed_and_the_values_follow_the_seed(law, conf,
                                                               lo, hi):
    conf = {**conf, "structure_seed": 42}
    a, b, c = (law.generate(conf, s, "cpu") for s in (1, 2**40 + 1, 1))
    for f in ("col_indices", "row_ptrs"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
        np.testing.assert_array_equal(
            getattr(a, f), getattr(law.generate(conf, 42, "cpu"), f))
    np.testing.assert_array_equal(a.values, c.values)     # seed → values
    assert not np.array_equal(a.values, b.values)
    assert a.values.dtype == np.float32
    assert lo <= a.values.min() and a.values.max() <= hi
    assert not (a.values == 0).any()
