"""PageRank: damped power iteration on the device (port of
``tpu_spmv/pagerank.py``, the reference's ``src/pagerank.cu:50-153``).

Each iteration is

    r_new = d*(A @ r_old) + d*(danglingᵀ r_old)/n + (1-d)/n

with the SpMV through :func:`~tpu_spmv_torch.spmv.spmv_csr`'s dispatch and
the dangling dot, the update and the L2 residual as torch ops on the same
device (the SpMV through any plan the dispatch serves: a single, banded or
composite plan, its pattern form, or the flat path); only the residual (one
scalar per iteration, for a positive tolerance's stop test) and the final
ranks come back.  Column-normalised transition matrices factor as
``B·diag(1/outdeg)``, so the dispatch runs them on the pattern fast path
(``SpMVConfig(pattern=True)``: a pattern plan over pre-scaled ranks, no value
stream).

Semantics kept from the JAX package and the reference:

* dangling nodes are the columns with zero column sum, found once up front;
* the loop stops at the first iteration whose residual is not at least the
  tolerance (below it, or NaN), or after ``max_iterations``; the returned
  ranks are that iteration's ``r_new``, renormalised to sum 1;
* ``pagerank_top_k`` gives the ranks in descending order (``torch.topk``);
* ``pagerank_save_state``/``pagerank_load_state`` write and read the JAX
  package's ``.npz`` keys, so each package reads the other's files.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .csr import CSRMatrix
from .errors import SpMVError, SpMVException, guarded_upload
from .kernels.plan import WindowEllOverflow
from .spmv import KernelType, SpMVConfig, _resolve_csr_kernel, _run


@dataclasses.dataclass
class PageRankConfig:
    """Reference ``PageRankConfig`` (``pagerank.h:9-15``), with the JAX
    package's choice of SpMV kernel (the reference hardwires VECTOR_CSR)."""

    damping_factor: float = 0.85
    tolerance: float = 1e-6
    max_iterations: int = 100
    kernel_type: KernelType = KernelType.VECTOR_CSR


@dataclasses.dataclass
class PageRankResult:
    """Reference ``PageRankResult`` (``pagerank.h:18-26``); ``plan`` is the
    plan that served the SpMVs (the port's addition, as in
    :class:`~tpu_spmv_torch.spmv.SpMVResult`)."""

    ranks: torch.Tensor | None = None
    iterations: int = 0
    final_residual: float = 0.0
    converged: bool = False
    error_code: int = 0
    plan: object = None

    def ranks_host(self) -> np.ndarray | None:
        return self.ranks.cpu().numpy() if self.ranks is not None else None


@dataclasses.dataclass
class TopKNode:
    """Reference ``TopKNode`` (``pagerank.h:21-24``)."""

    node_id: int
    rank: float


def find_dangling_mask(adj: CSRMatrix) -> np.ndarray:
    """Indicator vector of zero-column-sum nodes (reference
    ``find_dangling_nodes``, ``pagerank.cu:20-48``)."""
    col_sums = np.zeros(adj.num_cols, np.float32)
    if adj.nnz:
        np.add.at(col_sums, adj.col_indices, adj.values)
    return (col_sums == 0.0).astype(np.float32)


def column_scale_factor(adj: CSRMatrix) -> np.ndarray | None:
    """Per-column scale ``s`` when ``A = B·diag(s)`` for a 0/1 pattern ``B``
    (every stored value of a column the same), as a column-normalised
    transition matrix is (values ``1/outdeg(col)``); ``None`` when the
    factorisation does not hold exactly."""
    if adj.nnz == 0:
        return np.zeros(adj.num_cols, np.float32)
    scale = np.zeros(adj.num_cols, np.float32)
    scale[adj.col_indices] = adj.values       # the last value per column
    if not np.array_equal(adj.values, scale[adj.col_indices]):
        return None
    return scale


def _iterate(spmv, mask: torch.Tensor, r: torch.Tensor, n: int,
             damping: float, tolerance: float,
             max_iterations: int) -> tuple:
    """The power iteration from ``r``, ``spmv(r)`` giving ``A @ r`` (``n``
    values): ``(iterations, ranks, residual)``, the ranks renormalised.  It
    stops as the JAX loop does, at the first iteration whose residual fails
    ``residual >= tolerance`` (a NaN residual too), that iteration counted.

    With ``tolerance > 0`` the residual is read back once per iteration for
    the stop test, so the loop ends early.  With ``tolerance <= 0`` only a
    NaN residual stops it, and the test stays on the device: the loop runs
    ``max_iterations`` steps, and a flag taken from the previous step's
    residual (the JAX ``cond`` before ``body``) keeps ``r``, the residual
    and the count once it is false; the count and the residual are read
    back once, after the loop."""
    inv_n = 1.0 / n
    residual = torch.tensor(float("inf"), device=r.device)

    def step(r):
        r_new = damping * spmv(r) \
            + damping * torch.dot(mask, r) * inv_n + (1.0 - damping) * inv_n
        return r_new, torch.linalg.vector_norm(r_new - r)

    if tolerance > 0:
        it = 0
        while it < max_iterations:
            r, residual = step(r)
            it += 1
            if not float(residual) >= tolerance:
                break
    else:
        count = torch.zeros((), dtype=torch.int32, device=r.device)
        for _ in range(max_iterations):
            going = residual >= tolerance
            r_new, res_new = step(r)
            r = torch.where(going, r_new, r)
            residual = torch.where(going, res_new, residual)
            count += going
        it, residual = torch.stack(
            [count.double(), residual.double()]).tolist()
        it = int(it)
    total = r.sum()
    ranks = torch.where(total > 0.0, r / total, r)
    return it, ranks, float(residual)


def pagerank(adj_matrix: CSRMatrix | None,
             config: PageRankConfig | None = None, initial_ranks=None,
             device=None) -> PageRankResult:
    """Damped power iteration on a column-normalised adjacency matrix
    (reference ``pagerank``, ``pagerank.cu:50-153``).

    ``initial_ranks`` (an array or tensor) resumes from a saved state
    (:func:`pagerank_save_state`).  ``device`` is the card unless the caller
    names another; with no CUDA device and none named the result carries
    ``DEVICE_ALLOC``.  A non-square matrix gives ``INVALID_DIMENSION``,
    ``None`` an empty result.  The SpMV route is the dispatch's for
    ``SpMVConfig(pattern=True)`` and ``config.kernel_type``: a pattern plan
    (or banded stack) for column-scaled values, else the f32 plan, banded
    stack or composite; where the packed layout rejects the matrix,
    SCALAR_CSR's (``tpu_spmv/pagerank.py:163-169``)."""
    result = PageRankResult()
    if adj_matrix is None:
        return result
    if config is None:
        config = PageRankConfig()
    n = adj_matrix.num_rows
    if adj_matrix.num_cols != n:
        result.final_residual = float("nan")
        result.error_code = int(SpMVError.INVALID_DIMENSION)
        return result
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        result.error_code = int(SpMVError.DEVICE_ALLOC)
        return result
    if n == 0:
        result.ranks = torch.zeros(0, dtype=torch.float32, device=device)
        return result
    try:
        try:
            plan = _resolve_csr_kernel(
                adj_matrix, KernelType(config.kernel_type),
                SpMVConfig(pattern=True), device)
        except WindowEllOverflow:
            plan = _resolve_csr_kernel(adj_matrix, KernelType.SCALAR_CSR,
                                       SpMVConfig(), device)
        mask = guarded_upload(find_dangling_mask(adj_matrix)[:n], device)
        if initial_ranks is not None:
            r0 = initial_ranks if isinstance(initial_ranks, torch.Tensor) \
                else torch.from_numpy(np.asarray(initial_ranks, np.float32))
            r0 = guarded_upload(r0[:n].float().contiguous(), device)
        else:
            r0 = torch.full((n,), 1.0 / n, dtype=torch.float32,
                            device=device)
        it, ranks, residual = _iterate(
            lambda r: _run(plan, r)[:n], mask, r0, n,
            float(config.damping_factor), float(config.tolerance),
            int(config.max_iterations))
    except SpMVException as e:
        result.error_code = int(e.code)
        return result
    result.ranks = ranks
    result.iterations = it
    result.final_residual = residual
    result.converged = residual < config.tolerance
    result.plan = plan
    return result


def pagerank_top_k(result: PageRankResult, num_nodes: int,
                   k: int) -> list[TopKNode]:
    """Top-k nodes by rank, descending (reference ``pagerank_top_k``,
    ``pagerank.cu:162-185``)."""
    if result is None or result.ranks is None or k <= 0:
        return []
    actual_k = min(k, num_nodes)
    vals, idx = torch.topk(result.ranks[:num_nodes], actual_k)
    return [TopKNode(int(i), float(v))
            for i, v in zip(idx.tolist(), vals.tolist())]


def _state_path(path) -> str:
    """``np.savez`` appends ``.npz`` to a name without it; save and load
    agree on the name."""
    path = str(path)
    return path if path.endswith(".npz") else path + ".npz"


def pagerank_save_state(result: PageRankResult, path) -> None:
    """Write ranks, iteration count and residual for a later resume, in the
    JAX package's ``.npz`` keys."""
    with open(_state_path(path), "wb") as f:
        np.savez(f, ranks=result.ranks_host(),
                 iterations=np.int64(result.iterations),
                 final_residual=np.float64(result.final_residual))


def pagerank_load_state(path) -> PageRankResult:
    """Read a saved state (the port's or the JAX package's); feed
    ``.ranks`` to ``pagerank(..., initial_ranks=...)`` to resume."""
    data = np.load(_state_path(path))
    r = PageRankResult()
    r.ranks = torch.from_numpy(np.asarray(data["ranks"], np.float32))
    r.iterations = int(data["iterations"])
    r.final_residual = float(data["final_residual"])
    return r
