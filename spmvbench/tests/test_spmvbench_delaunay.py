"""The ``delaunay`` law (the ``mesh1m`` configuration's) at small sizes on
the CPU: its pattern, its values, its numbering and its seed; and a tiny
cell of the law under the ``solve`` mix, correct as the benchmark drives
it, with its control and a planted fault incorrect."""

import json
import os
import time

import numpy as np
import pytest
import torch

from conftest import make_root
from spmvbench import run as harness
from spmvbench.generators import delaunay

SMALL = {"generator": "delaunay", "scale": 14, "patch": 128,
         "structure_seed": 42}
# the tiny cell: 2^16 points, where the port's probe already admits the
# scrambled mesh, as it does the configuration's 2^20
TINY_MESH = {**SMALL, "scale": 16}


def csr_pattern(m):
    rows = np.repeat(np.arange(m.num_rows), np.diff(m.row_ptrs))
    return rows, m.col_indices.astype(np.int64)


def test_the_pattern_is_the_triangulation_and_the_diagonal():
    """One entry an edge of the triangulation, both ways, and the
    diagonal: 2 (3n - 3 - h) off-diagonal entries by Euler's formula, ``h``
    the hull's vertices."""
    from scipy.spatial import ConvexHull

    points, tri, label = delaunay.mesh(SMALL)
    m = delaunay.stiffness(points, tri, label)
    n = 1 << SMALL["scale"]
    assert m.num_rows == m.num_cols == n and len(tri) > n
    h = len(ConvexHull(points).vertices)
    assert m.nnz - n == 2 * (3 * n - 3 - h)
    lt = label[tri]
    edges = np.concatenate([lt[:, [0, 1]], lt[:, [1, 2]], lt[:, [2, 0]]])
    want = np.unique(np.concatenate([edges[:, 0] * n + edges[:, 1],
                                     edges[:, 1] * n + edges[:, 0],
                                     np.arange(n) * (n + 1)]))
    rows, cols = csr_pattern(m)
    assert np.array_equal(rows * n + cols, want)   # sorted in each row
    assert m.values.dtype == np.float32 and m.col_indices.dtype == np.int32


def test_the_stiffness_is_symmetric_with_rows_summing_to_zero():
    """Symmetric to the bit (each pair of entries sums the same triangles'
    terms in the same order), a positive diagonal, and each row's sum zero
    to float32's rounding of its entries."""
    from scipy.sparse import csr_matrix

    m = delaunay.generate(SMALL)
    A = csr_matrix((m.values, m.col_indices, m.row_ptrs),
                   shape=(m.num_rows, m.num_cols))
    assert (A != A.T).nnz == 0
    rows, cols = csr_pattern(m)
    diag = m.values[rows == cols]
    assert (diag > 0).all() and (m.values[rows != cols] != 0).all()
    sums = np.bincount(rows, weights=m.values.astype(np.float64),
                       minlength=m.num_rows)
    assert np.abs(sums).max() <= 1e-6 * diag.max()


def test_the_scramble_permutes_whole_patches():
    """The scrambled labels are the Morton ranks with their 128-patches
    renumbered by one permutation, offsets inside a patch kept."""
    points, _, scrambled = delaunay.mesh(SMALL)
    _, _, morton = delaunay.mesh({**SMALL, "scramble": False})
    n = len(points)
    assert np.array_equal(np.sort(morton), np.arange(n))
    assert np.array_equal(np.sort(scrambled), np.arange(n))
    assert np.array_equal(scrambled % 128, morton % 128)
    perm = np.full(n // 128, -1)
    perm[morton // 128] = scrambled // 128
    assert np.array_equal(perm[morton // 128], scrambled // 128)
    assert np.array_equal(np.sort(perm), np.arange(n // 128))
    assert not np.array_equal(perm, np.arange(n // 128))
    # the Morton order: each patch's points lie in a small part of the square
    spread = np.ptp(points[np.argsort(morton)].reshape(-1, 128, 2), axis=1)
    assert np.median(spread.max(axis=1)) < 0.2


def test_the_structure_seed_fixes_the_matrix_and_the_run_seed_does_not():
    a = delaunay.generate(SMALL, 1)
    b = delaunay.generate(SMALL, 2**40 + 7)
    c = delaunay.generate({**SMALL, "structure_seed": 43}, 1)
    for name in ("values", "col_indices", "row_ptrs"):
        assert np.array_equal(getattr(a, name), getattr(b, name)), name
    assert not np.array_equal(a.col_indices, c.col_indices)


@pytest.fixture
def mesh_root(tmp_path):
    """A checkout root with the tiny cells and ``tinymesh.solve``: the law
    at 2^16 points under the ``solve`` mix, reporting ``mesh1m.solve``'s
    metrics."""
    root = make_root(tmp_path)
    rel = "spmvbench/configs/tinymesh.json"
    with open(os.path.join(root, rel), "w") as f:
        json.dump(TINY_MESH, f)
    path = os.path.join(root, "BENCHMARK.json")
    with open(path) as f:
        bench = json.load(f)
    bench["configs"].append({"name": "tinymesh", "source": "tests",
                             "file": rel, "reduced": [], "why": "tests"})
    bench["workloads"].append({"name": "tinymesh.solve",
                               "config": "tinymesh", "traffic": "solve",
                               "chips": 1, "why": "tests"})
    for group in ("end_to_end", "per_layer"):
        for m in bench[group]:
            if "mesh1m.solve" in m.get("workloads", ()):
                m["workloads"].append("tinymesh.solve")
    with open(path, "w") as f:
        json.dump(bench, f)
    return root


def run(root, control=False, traced=False, device="cpu"):
    return harness.run_cell(root, "tinymesh.solve", 2**33 + 17, 0.3, traced,
                            torch.device(device), time.perf_counter(),
                            control=control)


def test_a_tiny_mesh_run_is_correct_and_its_control_is_not(mesh_root):
    result, checks = run(mesh_root)
    assert result["correct"], checks
    assert result["failed"] == 0 and result["attempted"] > 0
    assert set(result["metrics"]) == {"setup_s", "spmv_us", "spmv_p95_us"}
    result, checks = run(mesh_root, control=True)
    assert not result["correct"]
    assert checks["y_gap"][0] > checks["y_gap"][1]


def test_a_tiny_mesh_run_with_rows_left_out_is_not_correct(mesh_root,
                                                           monkeypatch):
    import tpu_spmv_torch

    real = tpu_spmv_torch.spmv_csr

    def broken(A, x, cfg=None, **kw):
        res = real(A, x, cfg, **kw)
        res.y = res.y.clone()
        res.y[res.y.shape[0] // 2:] = 0.0
        return res

    monkeypatch.setattr(tpu_spmv_torch, "spmv_csr", broken)
    result, checks = run(mesh_root)
    assert not result["correct"], checks


@pytest.mark.cuda
def test_a_traced_tiny_mesh_run_on_the_card_reads_the_reorder(mesh_root):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from tpu_spmv_torch import profiling

    profiling.clear()
    result, checks = run(mesh_root, traced=True, device="cuda")
    profiling.clear()
    assert result["correct"], checks
    metrics = result["metrics"]
    assert metrics["reorder_host_us.spmv"]["value"] > 0
    assert 1.0 < metrics["slots_per_nnz.spmv"]["value"] < 8.0
    assert 0 < metrics["spmv_roofline"]["value"] <= 100
