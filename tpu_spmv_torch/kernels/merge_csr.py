"""K4, the merge-path CSR SpMV (``csrc/merge_csr.cu``): its plan, its
wrapper and its plain version.

The window-ELL plan (K1) pads each 1024 x 1024 tile of the matrix to whole
groups of 1,024 slots; on a matrix whose tiles hold a few dozen nonzeros
it streams ten slots a nonzero.  K4 reads the CSR arrays as they are, so a
call streams each nonzero once.  The dispatch serves it where the
planner's packing model predicts that window-ELL pads more than K4 costs
(:func:`~tpu_spmv_torch.spmv.merge_route`); no TPU kernel stands behind
it.

* :class:`HostMerge` is the host side: the CSR arrays and whether the plan
  streams values (a pattern plan streams none: the caller hands it
  ``scale * x``, as the pattern route of window-ELL does).
* :func:`merge_starts` cuts the merge path (the matrix's row ends and
  nonzeros as one list of ``rows + nnz`` items) into ``n_ctas`` equal
  shares, one a CTA, and each share into ``tiles`` tiles of at most
  :data:`TILE` items, and gives every tile's start ``(row, nonzero)``.
* :func:`merge_from_host` makes the device plan (:class:`MergePlan`): the
  arrays padded for the kernel's bulk copies and the tile starts, for as
  many CTAs as the card holds at once (:data:`CPU_CTAS` on the CPU).
* :func:`spmv_merge` runs one SpMV: on a CUDA tensor it launches K4 and its
  fix-up (two launches, one where the plan has a single CTA) or raises; on
  a CPU tensor it runs :func:`spmv_merge_plain`, which follows the same
  split and carries: each CTA's part of each row it touches, the row
  written by the CTA that closes it, the parts of the CTAs before it (their
  carries) added in CTA order.  ``spmv_merge.launches`` counts the kernel
  launches.

K5, the merge-path CSR SpMM (``Y = A @ H`` for a dense ``(num_cols, k)``
``H``, a graph network's features or several right-hand sides), runs on
the same split with shares for warps: :func:`spmm_from_host` cuts K4's
plan arrays into :func:`spmm_shares` shares (a few for each warp the card
holds at once, :data:`SPMM_WAVES`; :data:`CPU_CTAS` off the card), and
:func:`spmm_merge` launches K5 and its k-wide fix-up on a CUDA tensor, or
runs :func:`spmm_merge_plain` (:func:`merge_parts` over blocks of columns,
then the fix-up) on a CPU tensor.  ``spmm_merge.launches`` counts its
launches.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..errors import DeviceException, guarded_upload
from ._build import kernels
from .window_ell import _current_stream, on_device

# merge items (row ends and nonzeros) one tile of a CTA takes: the kernel's
# 256 threads times 8 items (kTile in csrc/merge_csr.cu)
TILE = 2048
# CTAs the plan splits a matrix into on a device that is not a card
CPU_CTAS = 8
# slots of a window-ELL group, the unit of ``spmv.resolve``'s count
GROUP_SLOTS = 1024
_ALIGN = 4     # the bulk copies move whole 16-byte words of 4-byte entries
# K5's shares a warp slot: the card's warps at once times this many, so a
# share that gathers more of its rows of H from HBM than its neighbours do
# holds up less of the call
SPMM_WAVES = 4
# elements of the products a block of the plain SpMM's columns holds
_PLAIN_ELEMS = 1 << 24


@dataclasses.dataclass(frozen=True)
class HostMerge:
    """A matrix as K4 plans it on the host: its CSR arrays, and ``values``
    ``None`` for a pattern plan (every stored entry 1.0)."""

    row_ptrs: np.ndarray
    col_indices: np.ndarray
    values: np.ndarray | None
    num_rows: int
    num_cols: int


@dataclasses.dataclass(frozen=True)
class MergePlan:
    """K4's plan on one device: ``row_end`` (``row_ptrs[1:]``, then ``nnz``
    to a multiple of 4 entries past ``num_rows``), ``cols`` and ``vals``
    (``None`` on a pattern plan), zero-padded to a multiple of 4 entries,
    and the start ``(tile_row, tile_nz)`` of each of the ``n_ctas *
    tiles`` tiles, then the end of the merge path: CTA ``c`` takes tiles
    ``c * tiles`` to ``(c + 1) * tiles - 1``."""

    row_end: torch.Tensor     # i32 (ceil4(num_rows + 1),)
    cols: torch.Tensor        # i32 (ceil4(nnz) or 4,)
    vals: torch.Tensor | None  # f32, as cols; None for a pattern plan
    tile_row: torch.Tensor    # i32 (n_ctas * tiles + 1,)
    tile_nz: torch.Tensor     # i32 (n_ctas * tiles + 1,)
    num_rows: int
    num_cols: int
    nnz: int
    n_ctas: int
    tiles: int

    @property
    def device(self) -> torch.device:
        return self.cols.device

    @property
    def pat(self) -> bool:
        return self.vals is None

    @property
    def n_groups(self) -> int:
        """The nonzeros in window-ELL groups of 1,024 slots, rounded up: a
        plan with no padding, in the unit of a window-ELL plan's
        ``n_groups`` (the count of the dispatch's ``spmv.resolve``)."""
        return -(-self.nnz // GROUP_SLOTS)

    @property
    def stream_bytes(self) -> float:
        """Bytes one SpMV streams at least: the columns and values (4 B
        each; no values on a pattern plan), the row ends, x once and y."""
        per_nz = 4.0 if self.pat else 8.0
        return self.nnz * per_nz + 4.0 * (2 * self.num_rows + 1
                                          + self.num_cols)


def _ceil(n: int, q: int = _ALIGN) -> int:
    return -(-n // q) * q


def merge_starts(row_ptrs: np.ndarray, n_ctas: int) -> tuple:
    """``(tiles, tile_row, tile_nz)``: the merge path of a matrix with row
    pointers ``row_ptrs`` cut into ``n_ctas`` shares that differ by at most
    one item (CTA ``c`` from item ``c * items // n_ctas``), each share into
    ``tiles`` tiles of at most :data:`TILE` items (the last ones of a share
    shorter or empty), and each tile's start as ``(rows closed before it,
    nonzeros before it)``, int32, with the path's end ``(rows, nnz)``
    last.  A row's end lies after its nonzeros: item ``row_ptrs[r + 1] +
    r`` of the path."""
    ptr = np.asarray(row_ptrs, dtype=np.int64)
    rows = len(ptr) - 1
    items = rows + int(ptr[-1])
    if items >= 1 << 31:
        raise ValueError(f"merge path of {items} items: K4 indexes it in "
                         "32 bits")
    n_ctas = max(int(n_ctas), 1)
    share = -(-items // n_ctas)
    tiles = max(-(-share // TILE), 1)
    start = np.arange(n_ctas + 1, dtype=np.int64) * items // n_ctas
    diag = np.minimum(start[:-1, None] + np.arange(tiles) * TILE,
                      start[1:, None]).ravel()
    diag = np.append(diag, items)
    closes = ptr[1:] + np.arange(rows, dtype=np.int64)
    row = np.searchsorted(closes, diag, side="left")
    return tiles, row.astype(np.int32), (diag - row).astype(np.int32)


def host_merge(csr, pattern: bool) -> HostMerge:
    """The :class:`HostMerge` of a :class:`~tpu_spmv_torch.csr.CSRMatrix`
    (its arrays, not copies)."""
    return HostMerge(csr.row_ptrs, csr.col_indices,
                     None if pattern else csr.values, csr.num_rows,
                     csr.num_cols)


def card_ctas(device: torch.device, pattern: bool) -> int:
    """The CTAs of K4 that ``device`` (a card) holds at once."""
    with on_device(device.index if device.index is not None
                   else torch.cuda.current_device()):
        n = kernels().tsp_merge_csr_ctas(int(pattern))
    if n <= 0:
        raise DeviceException("K4: the occupancy query failed")
    return n


def merge_from_host(hm: HostMerge, device="cuda",
                    n_ctas: int | None = None) -> MergePlan:
    """The device plan of ``hm`` (on the card unless the caller names
    another device).  ``n_ctas`` defaults to the CTAs the card holds at
    once (:data:`CPU_CTAS` off the card), and is never more than the
    path's tiles of :data:`TILE` items."""
    device = torch.device(device)
    if n_ctas is None:
        n_ctas = card_ctas(device, hm.values is None) \
            if device.type == "cuda" else CPU_CTAS
    items = hm.num_rows + int(hm.row_ptrs[-1])
    return _merge_plan(hm, device, min(int(n_ctas), -(-items // TILE)))


def _merge_plan(hm: HostMerge, device: torch.device,
                n_ctas: int) -> MergePlan:
    """The device plan of ``hm`` split into ``n_ctas`` shares (at least
    one)."""
    ptr = np.asarray(hm.row_ptrs, dtype=np.int64)
    rows, nnz = hm.num_rows, int(ptr[-1])
    n_ctas = max(1, int(n_ctas))
    tiles, tile_row, tile_nz = merge_starts(ptr, n_ctas)

    def padded(a, n: int, fill, dtype) -> np.ndarray:
        out = np.full(n, fill, dtype=dtype)
        out[:len(a)] = a
        return out

    row_end = padded(ptr[1:], _ceil(rows + 1), nnz, np.int32)
    n_pad = max(_ceil(nnz), _ALIGN)
    cols = padded(hm.col_indices, n_pad, 0, np.int32)
    vals = None if hm.values is None \
        else padded(hm.values, n_pad, 0.0, np.float32)

    def put(a):
        return None if a is None else guarded_upload(a, device)

    return MergePlan(put(row_end), put(cols), put(vals), put(tile_row),
                     put(tile_nz), rows, hm.num_cols, nnz, n_ctas, tiles)


def merge_parts(plan: MergePlan, x: torch.Tensor) -> tuple:
    """What K4 leaves before its fix-up, by the plan's split: ``(y, carry
    rows, carry parts)``.  ``y[r]`` is row ``r``'s part in the CTA that
    closes it (0 for an empty row); CTA ``c``'s carry is the row open at
    its last item and that row's part in it (row -1 where it is the path's
    end).  Each part is an ``index_add_`` of its products; on any device.
    ``x`` may be ``(num_cols, k)``: each part is then k wide (K5's, whose
    shares are the plan's CTAs)."""
    return _parts(plan, _segments(plan, x.device), x)


def _segments(plan: MergePlan, dev) -> tuple:
    """The plan's split as :func:`_parts` reads it, on ``dev``: ``(cols,
    vals, seg, seg_row, seg_cta, final, carry_row)``: each nonzero's
    segment (its row's part in one CTA), each segment's row and CTA,
    whether that CTA closes the row, and each CTA's carry row."""
    k, rows, n = plan.nnz, plan.num_rows, plan.n_ctas
    cta_row = plan.tile_row[::plan.tiles].to(dev, torch.int64)
    cta_nz = plan.tile_nz[::plan.tiles].to(dev, torch.int64)
    cols = plan.cols[:k].to(dev, torch.int64)
    vals = None if plan.pat else plan.vals[:k].to(dev)
    ends = plan.row_end[:rows].to(dev, torch.int64)
    counts = torch.diff(ends, prepend=ends.new_zeros(1))
    row_of = torch.repeat_interleave(
        torch.arange(rows, device=dev), counts)
    cta_of = torch.searchsorted(cta_nz[1:-1],
                                torch.arange(k, device=dev), right=True)
    key, seg = torch.unique_consecutive(row_of * n + cta_of,
                                        return_inverse=True)
    seg_row, seg_cta = key // n, key % n
    closer = torch.searchsorted(cta_row[1:-1], seg_row, right=True)
    carry_row = torch.where(cta_row[1:] < rows, cta_row[1:], -1)
    return cols, vals, seg, seg_row, seg_cta, seg_cta == closer, carry_row


def _parts(plan: MergePlan, segs: tuple, x: torch.Tensor) -> tuple:
    """:func:`merge_parts` of ``x`` over the split ``segs``."""
    cols, vals, seg, seg_row, seg_cta, final, carry_row = segs
    dev, wide = x.device, x.shape[1:]
    prod = x[cols]
    if vals is not None:
        prod = (vals.view(-1, *(1,) * len(wide)) * prod)
    part = torch.zeros((len(seg_row),) + wide, dtype=torch.float32,
                       device=dev)
    part.index_add_(0, seg, prod)
    y = torch.zeros((plan.num_rows,) + wide, dtype=torch.float32,
                    device=dev)
    y[seg_row[final]] = part[final]
    carry_val = torch.zeros((plan.n_ctas,) + wide, dtype=torch.float32,
                            device=dev)
    carry_val[seg_cta[~final]] = part[~final]
    return y, carry_row, carry_val


def spmv_merge_plain(plan: MergePlan, x: torch.Tensor) -> torch.Tensor:
    """K4's plain version: :func:`merge_parts`, then the fix-up, each
    carry added to its row."""
    y, carry_row, carry_val = merge_parts(plan, x)
    live = carry_row >= 0
    return y.index_add_(0, carry_row[live], carry_val[live])


def _check(plan: MergePlan, x: torch.Tensor) -> None:
    if x.dtype != torch.float32 or x.shape != (plan.num_cols,) \
            or not x.is_contiguous():
        raise ValueError(f"K4 takes contiguous float32 x of shape "
                         f"({plan.num_cols},); got {x.dtype} "
                         f"{tuple(x.shape)}")
    if x.device != plan.device:
        raise ValueError(f"x on {x.device}, plan on {plan.device}")


def spmv_merge(plan: MergePlan, x: torch.Tensor) -> torch.Tensor:
    """``y = A @ x`` through K4 (``y = B @ x`` for a pattern plan of the
    0/1 structure B: the caller scales ``x``).  On a CUDA tensor launches
    ``csrc/merge_csr.cu`` on the current stream (K4, then its fix-up where
    the plan has more than one CTA) or raises; on a CPU tensor runs
    :func:`spmv_merge_plain`.  Returns ``(num_rows,)`` f32."""
    _check(plan, x)
    if not x.is_cuda:
        if x.is_cpu:
            return spmv_merge_plain(plan, x)
        raise ValueError(f"no K4 kernel for {x.device}")
    dev = x.get_device()
    y = torch.empty(plan.num_rows, dtype=torch.float32, device=x.device)
    if plan.num_rows == 0:
        return y
    carry = torch.empty(2 * plan.n_ctas, dtype=torch.int32, device=x.device)
    with on_device(dev):
        err = kernels().tsp_merge_csr(
            plan.row_end.data_ptr(), plan.cols.data_ptr(),
            None if plan.vals is None else plan.vals.data_ptr(),
            x.data_ptr(), plan.tile_row.data_ptr(), plan.tile_nz.data_ptr(),
            plan.n_ctas, plan.tiles, plan.num_rows, y.data_ptr(),
            carry.data_ptr(), _current_stream(dev))
    if err:
        raise DeviceException(f"merge_csr launch: cudaError {err}")
    spmv_merge.launches += 1 + (plan.n_ctas > 1)
    return y


spmv_merge.launches = 0


# ---- K5: the merge-path CSR SpMM ----

@dataclasses.dataclass(frozen=True)
class SpmmPlan:
    """K5's plan on one device: K4's arrays of the matrix (``merge``, an
    f32 value stream), its merge path cut into ``merge.n_ctas`` shares, one
    a warp."""

    merge: MergePlan

    @property
    def n_shares(self) -> int:
        return self.merge.n_ctas

    @property
    def n_groups(self) -> int:
        """As :attr:`MergePlan.n_groups`: the plan pads nothing."""
        return self.merge.n_groups


def spmm_shares(device: torch.device) -> int:
    """K5's shares on ``device``: :data:`SPMM_WAVES` for each warp the card
    holds at once, :data:`CPU_CTAS` off the card.  The split does not
    depend on k, so one plan serves every width."""
    if device.type != "cuda":
        return CPU_CTAS
    with on_device(device.index if device.index is not None
                   else torch.cuda.current_device()):
        n = kernels().tsp_merge_spmm_warps()
    if n <= 0:
        raise DeviceException("K5: the occupancy query failed")
    return n * SPMM_WAVES


def spmm_from_host(hm: HostMerge, device="cuda",
                   n_shares: int | None = None) -> SpmmPlan:
    """K5's device plan of ``hm`` (an f32 value stream), on the card unless
    the caller names another device: ``n_shares`` (default
    :func:`spmm_shares`) shares of the merge path, never more than its
    items."""
    if hm.values is None:
        raise ValueError("K5 takes an f32 value stream")
    device = torch.device(device)
    if n_shares is None:
        n_shares = spmm_shares(device)
    items = hm.num_rows + int(hm.row_ptrs[-1])
    return SpmmPlan(_merge_plan(hm, device, min(int(n_shares), items)))


def spmm_merge_plain(plan: SpmmPlan, x: torch.Tensor) -> torch.Tensor:
    """K5's plain version on any device: :func:`merge_parts` of blocks of
    ``x``'s columns (their products at most ``_PLAIN_ELEMS`` elements),
    then the fix-up, each carry added to its row."""
    m = plan.merge
    k = x.shape[1]
    y = torch.empty((m.num_rows, k), dtype=torch.float32, device=x.device)
    segs = _segments(m, x.device)
    live = segs[-1] >= 0
    step = max(1, _PLAIN_ELEMS // max(m.nnz, 1))
    for c0 in range(0, k, step):
        part, carry_row, carry_val = _parts(m, segs, x[:, c0:c0 + step])
        y[:, c0:c0 + step] = part.index_add_(0, carry_row[live],
                                             carry_val[live])
    return y


def spmm_merge(plan: SpmmPlan, x: torch.Tensor) -> torch.Tensor:
    """``Y = A @ x`` for a contiguous f32 ``x`` of ``(num_cols, k)``
    through K5.  On a CUDA tensor launches ``csrc/merge_csr.cu`` on the
    current stream (K5, then its fix-up where the plan has more than one
    share; the 16-byte path where k is a multiple of 4 and ``x`` is
    16-byte aligned) or raises; on a CPU tensor runs
    :func:`spmm_merge_plain`.  Returns ``(num_rows, k)`` f32."""
    m = plan.merge
    if x.dtype != torch.float32 or x.ndim != 2 \
            or x.shape[0] != m.num_cols or x.shape[1] < 1 \
            or not x.is_contiguous():
        raise ValueError(f"K5 takes contiguous float32 x of shape "
                         f"({m.num_cols}, k); got {x.dtype} "
                         f"{tuple(x.shape)}")
    if x.device != m.device:
        raise ValueError(f"x on {x.device}, plan on {m.device}")
    if not x.is_cuda:
        if x.is_cpu:
            return spmm_merge_plain(plan, x)
        raise ValueError(f"no K5 kernel for {x.device}")
    k = x.shape[1]
    y = torch.empty((m.num_rows, k), dtype=torch.float32, device=x.device)
    if m.num_rows == 0:
        return y
    vec = int(k % 4 == 0 and x.data_ptr() % 16 == 0)
    carry_row = torch.empty(m.n_ctas, dtype=torch.int32, device=x.device)
    carry_val = torch.empty((m.n_ctas, k), dtype=torch.float32,
                            device=x.device)
    dev = x.get_device()
    with on_device(dev):
        err = kernels().tsp_merge_spmm(
            m.row_end.data_ptr(), m.cols.data_ptr(), m.vals.data_ptr(),
            x.data_ptr(), m.tile_row.data_ptr(), m.tile_nz.data_ptr(),
            m.n_ctas, m.tiles, m.num_rows, k, vec, y.data_ptr(),
            carry_row.data_ptr(), carry_val.data_ptr(), _current_stream(dev))
    if err:
        raise DeviceException(f"merge_spmm launch: cudaError {err}")
    spmm_merge.launches += 1 + (m.n_ctas > 1)
    return y


spmm_merge.launches = 0
