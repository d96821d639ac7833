"""Block reordering for wide square matrices (port of
``tpu_spmv/kernels/reorder.py``).

The window-ELL layout packs densely when each superblock's columns fall into
few 1024-column windows.  Meshes, road-like and community graphs often have
that locality, hidden under a scrambled labeling.  This module recovers it
at 128-block granularity and serves the matrix through a plan built on the
permuted matrix.

Host part (NumPy, equal to the JAX module's on the same matrix):

* :func:`block_order`: Reverse Cuthill-McKee over the pruned, symmetrized
  quotient graph of 128-row/column blocks (SciPy's RCM where installed, a
  BFS fallback otherwise);
* :func:`reorder_gain` scores a candidate order with the superblock
  selector's sampled packing model (:func:`~.plan._sampled_sup_costs`);
* :func:`permute_csr` applies it symmetrically;
* :func:`maybe_reorder` is the dispatch probe with all its gates.

Device part:

* :func:`permute_chunks` (K3, ``csrc/permute.cu``, defined beside the
  gather table's set-up in :mod:`.window_ell`) gathers 128-element chunks;
  beside it, its plain version :func:`permute_chunks_plain`;
* :class:`ReorderedPlan` is the inner window-ELL plan (or row-banded
  stack) plus the two gather maps; :func:`spmv_reordered` runs a single
  inner plan as its SpMV with the x permute fused into the gather table's
  set-up (K3) and the row permute composed into K2's tile map, so each
  vector is written once, and a banded inner plan as the JAX package does:
  ``permute_chunks`` of x, the banded SpMV, ``permute_chunks`` of its rows
  (K2's tile map maps one plan's tiles, not several bands');
* :func:`build_reordered` (through :func:`build_reordered_host`, the host
  half the dispatch caches) and :func:`reordered_from_arrays` make one,
  from a host CSR or from a JAX ``ReorderedPlan``'s arrays.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from .. import profiling
from ..csr import CSRMatrix
from ..errors import InvalidFormatError, guarded_upload
from .plan import (LANE, SUP_LEVELS, HostBanded, HostPlan,
                   _sampled_sup_costs, build_auto)
from .window_ell import permute_chunks, permute_chunks_plain  # noqa: F401
from .window_ell import (BandedPlan, PlanFile, WindowEllPlan, banded_from_host,
                         gather_table, plan_from_arrays, setup_bytes,
                         spmv_banded, spmv_on_table)

BLOCK = LANE            # permutation granularity: one 128-element chunk
# top-K quotient-graph pruning: each block keeps its K heaviest neighbours,
# so hub blocks do not connect everything
TOPK = 16
# the permuted plan must cost at most this share of the natural plan under
# the sampled packing model (it pays two vector gathers per call and a
# costlier build; the margin also keeps iid matrices from flipping on noise)
GAIN_THRESHOLD = 0.85
# the JAX package's cap (x in one TPU VMEM block), kept so both packages
# probe the same matrices
MAX_COLS = 1 << 21


def _enabled() -> bool:
    return os.environ.get("TPU_SPMV_REORDER", "1") not in ("0", "")


def _coords(csr: CSRMatrix) -> tuple[np.ndarray, np.ndarray]:
    rows_of = np.repeat(np.arange(csr.num_rows, dtype=np.int64),
                        np.diff(csr.row_ptrs).astype(np.int64))
    return rows_of, csr.col_indices.astype(np.int64)


def _rcm(indptr: np.ndarray, indices: np.ndarray, n: int) -> np.ndarray:
    """Reverse Cuthill-McKee on a symmetric adjacency (CSR arrays): SciPy's
    where it is installed, else a BFS in degree order (the quotient graph
    has rows/128 nodes, so either is quick)."""
    try:
        from scipy.sparse import csr_matrix as _sp
        from scipy.sparse.csgraph import reverse_cuthill_mckee

        g = _sp((np.ones(len(indices), np.int8), indices, indptr),
                shape=(n, n))
        return np.asarray(reverse_cuthill_mckee(g, symmetric_mode=True),
                          dtype=np.int64)
    except ImportError:
        deg = np.diff(indptr)
        order, seen = [], np.zeros(n, bool)
        for start in np.argsort(deg, kind="stable"):
            if seen[start]:
                continue
            seen[start] = True
            queue = [int(start)]
            while queue:
                u = queue.pop(0)
                order.append(u)
                nbr = indices[indptr[u]:indptr[u + 1]]
                nbr = nbr[~seen[nbr]]
                seen[nbr] = True
                queue.extend(nbr[np.argsort(deg[nbr], kind="stable")])
        return np.asarray(order[::-1], dtype=np.int64)


def block_order(csr: CSRMatrix, topk: int = TOPK) -> np.ndarray:
    """RCM order of 128-blocks from the pruned symmetric quotient graph.

    Returns ``order``, where ``order[j]`` is the original block at new
    position ``j``.  Square matrices only (the permutation is symmetric)."""
    if csr.num_rows != csr.num_cols:
        raise ValueError("block_order: symmetric reordering needs a "
                         "square matrix")
    nb = -(-max(csr.num_rows, 1) // BLOCK)
    rows_of, cols64 = _coords(csr)
    key = (rows_of // BLOCK) * nb + cols64 // BLOCK
    uk, w = np.unique(key, return_counts=True)
    i, j = uk // nb, uk % nb
    # symmetrize the weights, drop self-loops
    ii = np.concatenate([i, j])
    jj = np.concatenate([j, i])
    ww = np.concatenate([w, w])
    off = ii != jj
    ii, jj, ww = ii[off], jj[off], ww[off]
    if len(ii) == 0:
        return np.arange(nb, dtype=np.int64)
    us, inv = np.unique(ii * nb + jj, return_inverse=True)
    wsum = np.zeros(len(us), np.int64)
    np.add.at(wsum, inv, ww)
    ii, jj = us // nb, us % nb
    # prune: drop edges under 1/8 of their source block's heaviest (iid
    # noise carries a few nonzeros, cluster edges hundreds), then keep at
    # most top-K per block by weight (hub blocks)
    o = np.lexsort((-wsum, ii))
    ii, jj, wsum = ii[o], jj[o], wsum[o]
    starts = np.searchsorted(ii, np.arange(nb))
    wmax = np.zeros(nb, np.int64)
    has = starts < len(ii)
    wmax[has] = wsum[np.minimum(starts, len(ii) - 1)][has]
    rank = np.arange(len(ii)) - starts[ii]
    keep = (rank < topk) & (wsum * 8 >= wmax[ii])
    ii, jj = ii[keep], jj[keep]
    # re-symmetrize the pruned edges (RCM wants a symmetric structure)
    sk = np.unique(np.concatenate([ii * nb + jj, jj * nb + ii]))
    ii, jj = sk // nb, sk % nb
    indptr = np.zeros(nb + 1, np.int64)
    np.cumsum(np.bincount(ii, minlength=nb), out=indptr[1:])
    return _rcm(indptr, jj.astype(np.int64), nb)


def _inverse(order: np.ndarray) -> np.ndarray:
    """``pos`` with ``pos[order[j]] = j``: each original block's new
    position."""
    pos = np.empty(len(order), np.int64)
    pos[order] = np.arange(len(order))
    return pos


def _relabel(coord: np.ndarray, pos: np.ndarray) -> np.ndarray:
    """New element labels under a block permutation (offsets inside a block
    are kept)."""
    return pos[coord // BLOCK] * BLOCK + coord % BLOCK


def reorder_gain(csr: CSRMatrix, order: np.ndarray) -> tuple[float, float]:
    """``(natural_cost, permuted_cost)`` under the sampled packing model, in
    the model's units; ``inf`` where every superblock level is ruled out."""
    rows_of, cols64 = _coords(csr)
    pos = _inverse(order)
    n_pad = len(order) * BLOCK

    def best(r, c, nr, nc):
        costs = _sampled_sup_costs(r, c, nr, nc)
        return min((c0 for c0, _ in costs.values()), default=float("inf"))

    nat = best(rows_of, cols64, csr.num_rows, csr.num_cols)
    prm = best(_relabel(rows_of, pos), _relabel(cols64, pos), n_pad, n_pad)
    return nat, prm


def permute_csr(csr: CSRMatrix, order: np.ndarray) -> CSRMatrix:
    """The symmetrically block-permuted matrix, its dimensions padded to
    whole blocks (the padding rows are empty, its columns never hit)."""
    pos = _inverse(order)
    n_pad = len(order) * BLOCK
    rows_of, cols64 = _coords(csr)
    new_r = _relabel(rows_of, pos)
    new_c = _relabel(cols64, pos)
    o = np.argsort(new_r * n_pad + new_c, kind="stable")
    new_r, new_c = new_r[o], new_c[o]
    ptr = np.zeros(n_pad + 1, np.int64)
    np.cumsum(np.bincount(new_r, minlength=n_pad), out=ptr[1:])
    return CSRMatrix(n_pad, n_pad, csr.values[o], new_c.astype(np.int32), ptr)


def maybe_reorder(csr: CSRMatrix, force: bool = False) -> np.ndarray | None:
    """The dispatch probe: an RCM block order where it pays, else ``None``.

    Gates, cheapest first: ``TPU_SPMV_REORDER`` is not ``0``; the matrix is
    square, at most ``MAX_COLS`` wide, and has at least 65,536 nonzeros and
    four narrow superblocks of rows; and the sampled packing model puts the
    permuted matrix at no more than ``GAIN_THRESHOLD`` of the natural cost.
    iid structure fails the last gate.  ``force=True`` skips it.

    The JAX probe (``tpu_spmv/kernels/reorder.py``) has one gate more: it
    turns away every matrix whose superblock choice is narrow before the
    packing model is asked.  The port does not.  A scrambled mesh of about
    7 nonzeros a row picks the narrow superblock because its natural plan
    packs badly at every height, which is what the reorder cures (the
    DIMACS10 ``delaunay_n20`` stiffness matrix under a scrambled patch
    numbering: a permuted cost 0.71 of the natural one, the plans built
    streaming 6.1x fewer slots).  So the port admits such a matrix where
    JAX serves it unpermuted; its verdict does not depend on the superblock
    choice, nor on the merge-path split."""
    if not _enabled():
        return None
    if csr.num_rows != csr.num_cols or csr.num_cols > MAX_COLS:
        return None
    if csr.nnz < (1 << 16) or csr.num_rows < 4 * SUP_LEVELS[0]:
        return None
    order = block_order(csr)
    if force:
        return order
    nat, prm = reorder_gain(csr, order)
    # a finite permuted cost only: (inf, inf) would pass "prm <= 0.85*nat"
    if np.isfinite(prm) and prm <= GAIN_THRESHOLD * nat:
        return order
    return None


# ---- the reordered plan ----

@dataclasses.dataclass(frozen=True)
class ReorderedPlan(PlanFile):
    """A window-ELL plan (or row-banded stack) built on the block-permuted
    matrix, plus the two gather maps that make it serve the original order
    (the JAX ``ReorderedPlan``, ``tpu_spmv/kernels/reorder.py:277-306``)."""

    inner: WindowEllPlan | BandedPlan  # in the permuted space, dims padded
    #                                    to blocks
    col_src: torch.Tensor    # i32 (nb,) new chunk j reads x chunk col_src[j]
    row_src: torch.Tensor    # i32 (nb,) output chunk b reads inner's
    #                          chunk row_src[b]
    num_rows: int            # the original dims
    num_cols: int

    @property
    def occupancy(self) -> float:
        return self.inner.occupancy

    @property
    def n_groups(self) -> int:
        return self.inner.n_groups

    @property
    def stream_bytes(self) -> float:
        """Bytes one SpMV moves: the inner plan's, x and ``col_src`` read
        by the gather table's set-up (:func:`~.window_ell.setup_bytes`),
        and ``row_src`` read by K2, 4 B an output tile.  A banded inner
        plan reads the permuted x instead, so the x permute also writes it,
        and the row permute reads the bands' rows and writes ``y``."""
        b = self.inner.stream_bytes \
            + setup_bytes(self.num_cols, len(self.col_src)) \
            + 4 * -(-self.num_rows // LANE)
        if isinstance(self.inner, BandedPlan):
            b += 4 * (self.inner.num_cols + self.inner.num_rows
                      + self.num_rows)
        return b


def spmv_reordered(rp: ReorderedPlan, x: torch.Tensor) -> torch.Tensor:
    """``y = A @ x`` through a reordered plan
    (``tpu_spmv/kernels/reorder.py:320-328``: gather x into the plan's
    block order, run the inner plan, gather the rows back).  On a single
    inner plan neither gather is a pass of its own: the gather table's
    set-up (K3) reads x's chunks in ``col_src`` order, and K2 writes the
    output tile ``b`` from the inner plan's tile ``row_src[b]``, trimmed
    to ``num_rows``.  On a banded inner plan each gather is a
    :func:`permute_chunks` (K3) around :func:`~.window_ell.spmv_banded`.
    Recorded as the span ``spmv.reorder``, whose count is the standalone
    :func:`permute_chunks` calls it made (:func:`standalone_permutes`)."""
    if profiling.on:
        span = profiling.begin("spmv.reorder")
    if isinstance(rp.inner, BandedPlan):
        xp = permute_chunks(x, rp.col_src, rp.inner.num_cols)
        y = permute_chunks(spmv_banded(rp.inner, xp), rp.row_src,
                           rp.num_rows)
    else:
        table = gather_table(rp.inner, x, rp.col_src)
        y = spmv_on_table(rp.inner, table, rp.row_src, rp.num_rows)
    if profiling.on:
        profiling.end(span, standalone_permutes(rp))
    return y


def standalone_permutes(rp: ReorderedPlan) -> int:
    """The :func:`permute_chunks` calls of their own that one
    :func:`spmv_reordered` makes: 2 on a banded inner plan (``x`` into the
    block order, the rows back), else 0 (the table's set-up and K2's tile
    map take both gathers)."""
    return 2 if isinstance(rp.inner, BandedPlan) else 0


def _check_maps(col_src: np.ndarray, row_src: np.ndarray, num_rows: int,
                num_cols: int, inner_rows: int, inner_cols: int) -> None:
    nb = len(col_src)
    if col_src.shape != (nb,) or row_src.shape != (nb,) \
            or not np.array_equal(np.sort(col_src), np.arange(nb)) \
            or not np.array_equal(row_src[col_src], np.arange(nb)):
        raise InvalidFormatError("reordered plan: col_src must be a block "
                                 "permutation and row_src its inverse")
    if not (-(-num_rows // LANE) == nb == -(-num_cols // LANE)
            and inner_rows == inner_cols == nb * LANE):
        raise InvalidFormatError(
            f"reordered plan: {nb} blocks for {num_rows}x{num_cols}, inner "
            f"{inner_rows}x{inner_cols}")


def reordered_from_arrays(inner_leaves: dict, inner_aux: dict,
                          col_src: np.ndarray, row_src: np.ndarray,
                          num_rows: int, num_cols: int, device="cuda",
                          occupancy: float = 0.0,
                          values_dtype: str = "float32") -> ReorderedPlan:
    """Make a device plan from NumPy arrays: the inner plan's leaves and
    static fields (as :func:`~.window_ell.plan_from_arrays` takes them, from
    a JAX ``ReorderedPlan``'s inner plan or a port ``HostPlan``), the two
    gather maps and the original dims.  Checks that the maps are a block
    permutation and its inverse, sized to the inner plan.  ``device`` is
    the card unless the caller names another; ``values_dtype`` as
    :func:`~.window_ell.plan_from_arrays` takes it."""
    col_src = np.ascontiguousarray(col_src, np.int32)
    row_src = np.ascontiguousarray(row_src, np.int32)
    _check_maps(col_src, row_src, num_rows, num_cols,
                inner_aux["num_rows"], inner_aux["num_cols"])
    inner = plan_from_arrays(inner_leaves, inner_aux, device, occupancy,
                             values_dtype)
    return ReorderedPlan(inner, guarded_upload(col_src, device),
                         guarded_upload(row_src, device), num_rows, num_cols)


def reordered_from_host(inner: HostPlan | HostBanded, order: np.ndarray,
                        num_rows: int, num_cols: int,
                        device="cuda") -> ReorderedPlan:
    """The device plan of a port-built inner plan (or banded stack) and its
    block order."""
    if isinstance(inner, HostPlan):
        return reordered_from_arrays(inner.leaves(), inner.aux(), order,
                                     _inverse(order), num_rows, num_cols,
                                     device, inner.occupancy,
                                     inner.values_dtype)
    col_src = np.ascontiguousarray(order, np.int32)
    row_src = _inverse(order).astype(np.int32)
    _check_maps(col_src, row_src, num_rows, num_cols, inner.num_rows,
                inner.num_cols)
    return ReorderedPlan(banded_from_host(inner, device),
                         guarded_upload(col_src, device),
                         guarded_upload(row_src, device), num_rows, num_cols)


def build_reordered_host(csr: CSRMatrix, order: np.ndarray | None = None,
                         split_rows: int | None = None,
                         step_groups: int | None = None,
                         permute_rows: bool | None = None,
                         values_dtype=np.float32
                         ) -> tuple[HostPlan | HostBanded, np.ndarray]:
    """The host half of :func:`build_reordered`: ``(inner plan, order)``,
    the inner plan (a single plan or a banded stack)
    :func:`~.plan.build_auto` of the matrix permuted by ``order`` (default:
    the RCM block order), with a ``values_dtype`` (float32 or bfloat16)
    value stream.  Raises :class:`~.plan.WindowEllOverflow` where every
    packed layout rejects it."""
    if order is None:
        order = block_order(csr)
    inner = build_auto(permute_csr(csr, order), split_rows=split_rows,
                       step_groups=step_groups, permute_rows=permute_rows,
                       values_dtype=values_dtype)
    return inner, order


def build_reordered(csr: CSRMatrix, order: np.ndarray | None = None,
                    split_rows: int | None = None,
                    step_groups: int | None = None, device="cuda",
                    permute_rows: bool | None = None,
                    values_dtype=np.float32) -> ReorderedPlan:
    """A :class:`ReorderedPlan` on ``device`` (the card unless the caller
    names another) under ``order``, as the JAX ``build_reordered`` builds it
    (``tpu_spmv/kernels/reorder.py:331-357``): :func:`build_reordered_host`,
    then the upload."""
    inner, order = build_reordered_host(csr, order, split_rows, step_groups,
                                        permute_rows, values_dtype)
    return reordered_from_host(inner, order, csr.num_rows, csr.num_cols,
                               device)
