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

* :func:`permute_chunks` (K3, ``csrc/permute.cu``) gathers 128-element
  chunks; beside it, its plain version :func:`permute_chunks_plain`.  The
  wrapper takes the plain version only for a tensor on the CPU, and counts
  its launches in ``permute_chunks.launches``;
* :class:`ReorderedPlan` is the inner window-ELL plan plus the two gather
  maps; :func:`spmv_reordered` runs it as
  ``unpermute(inner(permute(x)))``;
* :func:`build_reordered` (through :func:`build_reordered_host`, the host
  half the dispatch caches) and :func:`reordered_from_arrays` make one,
  from a host CSR or from a JAX ``ReorderedPlan``'s arrays.
"""

from __future__ import annotations

import ctypes
import dataclasses
import os

import numpy as np
import torch

from ..csr import CSRMatrix
from ..errors import DeviceException, InvalidFormatError, guarded_upload
from .plan import (LANE, SUP_LEVELS, HostPlan, _choose_sup,
                   _sampled_sup_costs, build_auto)
from .window_ell import WindowEllPlan, plan_from_arrays, spmv_window_ell

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


def maybe_reorder(csr: CSRMatrix, choice: tuple | None = None,
                  force: bool = False,
                  split_rows: int | None = None) -> np.ndarray | None:
    """The dispatch probe: an RCM block order where it pays, else ``None``.

    Gates, cheapest first: ``TPU_SPMV_REORDER`` is not ``0``; the matrix is
    square, at most ``MAX_COLS`` wide, has at least 65,536 nonzeros and four
    narrow superblocks of rows; the superblock choice (``choice``, or the
    selector's) is wide; and the sampled packing model puts the permuted
    matrix at no more than ``GAIN_THRESHOLD`` of the natural cost.  iid
    structure fails the last gate.  ``force=True`` skips the last two."""
    if not _enabled():
        return None
    if csr.num_rows != csr.num_cols or csr.num_cols > MAX_COLS:
        return None
    if csr.nnz < (1 << 16) or csr.num_rows < 4 * SUP_LEVELS[0]:
        return None
    if force:
        return block_order(csr)
    sup = (choice[0] if choice is not None
           else _choose_sup(csr, split_rows=split_rows))
    if sup <= SUP_LEVELS[0]:
        return None
    order = block_order(csr)
    nat, prm = reorder_gain(csr, order)
    # a finite permuted cost only: (inf, inf) would pass "prm <= 0.85*nat"
    if np.isfinite(prm) and prm <= GAIN_THRESHOLD * nat:
        return order
    return None


# ---- K3: the chunk permute ----

def _check_permute(x: torch.Tensor, src: torch.Tensor, out_len: int) -> None:
    if x.dtype != torch.float32 or x.ndim != 1 or src.dtype != torch.int32 \
            or src.ndim != 1:
        raise ValueError("permute_chunks takes float32 x and int32 src, "
                         "both 1-D")
    if not 0 <= out_len <= src.numel() * LANE:
        raise ValueError(f"permute_chunks: out_len {out_len} for "
                         f"{src.numel()} chunks")
    if x.device != src.device:
        raise ValueError(f"x on {x.device}, src on {src.device}")


def permute_chunks_plain(x: torch.Tensor, src: torch.Tensor,
                         out_len: int) -> torch.Tensor:
    """K3's plain version: ``index_select`` of 128-element chunks from x
    zero-padded by one chunk, every source chunk outside
    ``[0, ceil(len(x)/128))`` mapped to that zero chunk; flattened and
    trimmed to ``out_len``."""
    _check_permute(x, src, out_len)
    n_src = -(-x.numel() // LANE)
    x2d = torch.zeros(n_src + 1, LANE, dtype=torch.float32, device=x.device)
    x2d.view(-1)[:x.numel()] = x
    idx = src.long()
    idx = torch.where((idx >= 0) & (idx < n_src), idx, n_src)
    return x2d.index_select(0, idx).reshape(-1)[:out_len]


def permute_chunks(x: torch.Tensor, src: torch.Tensor,
                   out_len: int) -> torch.Tensor:
    """K3: ``out[j*128 + e] = x[src[j]*128 + e]`` for the first ``out_len``
    elements, a chunk or element past the end of x reading as 0
    (``permute_chunks``, ``tpu_spmv/kernels/reorder.py:260-271``).  Launches
    ``csrc/permute.cu`` for CUDA tensors; the plain version for CPU ones."""
    _check_permute(x, src, out_len)
    if x.device.type == "cpu":
        return permute_chunks_plain(x, src, out_len)
    if x.device.type != "cuda":
        raise ValueError(f"no permute kernel for {x.device}")
    from ._build import kernels

    x, src = x.contiguous(), src.contiguous()
    out = torch.empty(out_len, dtype=torch.float32, device=x.device)
    err = kernels().tsp_permute_chunks(
        x.data_ptr(), x.numel(), src.data_ptr(), out.data_ptr(), out_len,
        ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream))
    if err:
        raise DeviceException(f"permute_chunks launch: cudaError {err}")
    permute_chunks.launches += 1
    return out


permute_chunks.launches = 0


def permute_bytes(out_len: int) -> int:
    """Bytes one chunk permute moves: read and write 4 B per element kept,
    and 4 B of ``src`` per chunk."""
    return out_len * 8 + -(-out_len // LANE) * 4


# ---- the reordered plan ----

@dataclasses.dataclass(frozen=True)
class ReorderedPlan:
    """A window-ELL plan built on the block-permuted matrix, plus the two
    gather maps that make it serve the original order (the JAX
    ``ReorderedPlan``, ``tpu_spmv/kernels/reorder.py:277-306``)."""

    inner: WindowEllPlan     # in the permuted space, dims padded to blocks
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
        """Bytes one SpMV moves: the inner plan's and both permutes'."""
        return self.inner.stream_bytes + permute_bytes(self.inner.num_cols) \
            + permute_bytes(self.num_rows)


def spmv_reordered(rp: ReorderedPlan, x: torch.Tensor) -> torch.Tensor:
    """``y = A @ x`` through a reordered plan: gather x into the plan's block
    order, run the inner plan, gather the rows back
    (``tpu_spmv/kernels/reorder.py:320-328``)."""
    inner = rp.inner
    xp = permute_chunks(x, rp.col_src, inner.num_cols)
    return permute_chunks(spmv_window_ell(inner, xp), rp.row_src,
                          rp.num_rows)


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


def reordered_from_host(inner: HostPlan, order: np.ndarray, num_rows: int,
                        num_cols: int, device="cuda") -> ReorderedPlan:
    """The device plan of a port-built inner plan and its block order."""
    return reordered_from_arrays(inner.leaves(), inner.aux(), order,
                                 _inverse(order), num_rows, num_cols, device,
                                 inner.occupancy, inner.values_dtype)


def build_reordered_host(csr: CSRMatrix, order: np.ndarray | None = None,
                         split_rows: int | None = None,
                         step_groups: int | None = None,
                         permute_rows: bool | None = None,
                         values_dtype=np.float32
                         ) -> tuple[HostPlan, np.ndarray]:
    """The host half of :func:`build_reordered`: ``(inner plan, order)``,
    the inner plan :func:`~.plan.build_auto` of the matrix permuted by
    ``order`` (default: the RCM block order), with a ``values_dtype``
    (float32 or bfloat16) value stream.  Raises
    :class:`~.plan.WindowEllOverflow` where every packed layout rejects it,
    and ``NotImplementedError`` (ROADMAP M7) where the JAX planner would
    build a row-banded plan."""
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
