"""The P1 finite-element Poisson stiffness matrix of a Delaunay mesh, its
vertices numbered in scrambled patches.

The mesh is the DIMACS10 ``delaunay_n<scale>`` construction (SuiteSparse
Matrix Collection, DIMACS10 group): the Delaunay triangulation of
``2**scale`` points uniform in the unit square, made here with SciPy's
Qhull (``scipy.spatial.Delaunay``).  The operator is the stiffness matrix
of piecewise-linear elements on it, assembled in float64 from each
triangle's local matrix ``(e_i . e_j) / (4 |T|)`` (``e_i`` the edge
opposite vertex ``i``, ``|T|`` the triangle's area: the cotangent
weights), and stored in float32: one row a vertex, its diagonal and one
entry an edge of the triangulation, every row summing to zero.

The numbering: the vertices in Morton (Z-curve) order of their points,
cut into patches of ``patch`` vertices, and the patches numbered by a
random permutation, as a mesh stitched from patches numbered in arbitrary
order (part by part after a partitioner) is.  With ``scramble`` false
the patches keep their Morton order.

The points, then the patch permutation, are drawn from the
configuration's ``structure_seed``; nothing comes from the run's seed,
since the stiffness is fixed by the mesh.  The assembly sorts the
triangles' entries once.

Configuration keys: ``scale``, ``patch``, ``structure_seed`` and,
optionally, ``scramble`` (default true).
"""

from __future__ import annotations

import numpy as np

from spmvbench.reference.matrix import Matrix

# bits a coordinate keeps in the Morton code
MORTON_BITS = 16


def generate(config: dict, seed: int = 0, device=None) -> Matrix:
    """The matrix of ``config`` (the run's ``seed`` and ``device`` are not
    used: the mesh and its stiffness come from ``structure_seed``)."""
    points, tri, label = mesh(config)
    return stiffness(points, tri, label)


def mesh(config: dict) -> tuple:
    """``(points, triangles, labels)``: ``2**scale`` points uniform in
    [0, 1)^2, the vertex triples of their Delaunay triangulation (indices
    into ``points``) and each vertex's label (:func:`numbering`).  Qhull is
    handed the points in Morton order, where it runs faster."""
    from scipy.spatial import Delaunay

    rng = np.random.default_rng(int(config["structure_seed"]))
    points = rng.random((1 << int(config["scale"]), 2))
    order = np.argsort(morton(points), kind="stable")
    tri = order[Delaunay(points[order]).simplices]
    label = numbering(order, int(config["patch"]), rng,
                      bool(config.get("scramble", True)))
    return points, tri, label


def morton(points: np.ndarray) -> np.ndarray:
    """The Z-curve code of each point of [0, 1)^2, ``MORTON_BITS`` bits a
    coordinate interleaved (x in the even bits)."""
    q = np.minimum((points * (1 << MORTON_BITS)).astype(np.int64),
                   (1 << MORTON_BITS) - 1)
    code = np.zeros(len(points), np.int64)
    for b in range(MORTON_BITS):
        code |= ((q[:, 0] >> b) & 1) << (2 * b)
        code |= ((q[:, 1] >> b) & 1) << (2 * b + 1)
    return code


def numbering(order: np.ndarray, patch: int, rng: np.random.Generator,
              scramble: bool = True) -> np.ndarray:
    """Each vertex's label: its rank in the Morton ``order`` (the vertices
    in that order), the patch of ``patch`` ranks it falls in renumbered by
    a permutation of the patches drawn from ``rng`` where ``scramble``."""
    n = len(order)
    rank = np.empty(n, np.int64)
    rank[order] = np.arange(n)
    if not scramble:
        return rank
    perm = rng.permutation(-(-n // patch))
    return perm[rank // patch] * patch + rank % patch


def local_stiffness(points: np.ndarray, tri: np.ndarray) -> np.ndarray:
    """Each triangle's 3 x 3 P1 stiffness matrix in float64:
    ``(e_i . e_j) / (4 |T|)``, ``e_i`` the edge opposite vertex ``i``."""
    p = points[tri]                                   # (m, 3, 2)
    e = p[:, [2, 0, 1]] - p[:, [1, 2, 0]]             # e_i = p_{i-1} - p_{i+1}
    area4 = 2.0 * np.abs(e[:, 1, 0] * e[:, 2, 1] - e[:, 1, 1] * e[:, 2, 0])
    return np.einsum("mik,mjk->mij", e, e) / area4[:, None, None]


def stiffness(points: np.ndarray, tri: np.ndarray,
              label: np.ndarray) -> Matrix:
    """The assembled stiffness matrix of the triangles ``tri`` (indices
    into ``points``), row and column ``label[v]`` for vertex ``v``, as CSR
    with sorted columns: the triangles' local entries summed in float64
    over one sort of their keys, then stored in float32."""
    n = len(points)
    lt = label[tri]
    rows = np.repeat(lt, 3, axis=1).ravel()
    cols = np.tile(lt, (1, 3)).ravel()
    vals = local_stiffness(points, tri).ravel()
    key = rows * n + cols
    order = np.argsort(key, kind="stable")
    key, vals = key[order], vals[order]
    start = np.flatnonzero(np.r_[True, key[1:] != key[:-1]])
    summed = np.add.reduceat(vals, start)
    key = key[start]
    row_ptrs = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(key // n, minlength=n), out=row_ptrs[1:])
    return Matrix(n, n, summed.astype(np.float32),
                  (key % n).astype(np.int32), row_ptrs.astype(np.int32))
