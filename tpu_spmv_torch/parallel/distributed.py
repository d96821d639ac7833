"""Row-sharded multi-device SpMV and PageRank (port of
``tpu_spmv/parallel/distributed.py``).

The matrix is cut into row blocks of near-equal nonzeros
(:func:`_nnz_balanced_bounds`, the JAX cut exactly), one per shard of a
:class:`RowMesh`, and each shard runs the port's single-device machinery on
its block:

* flat (:func:`shard_csr`, :func:`spmv_csr_sharded`): the flat CSR path
  (:mod:`..kernels.scalar`) on each shard, x replicated;
* replicated-packed (:func:`shard_csr_packed`,
  :func:`spmv_csr_sharded_packed`): one window-ELL plan per shard, run
  through K1-K3, x replicated.  Every shard has one superblock height,
  chosen once from the whole matrix with the row split the shards are
  built with (the JAX function chooses it without the split: fault F1);
* ring (:func:`shard_csr_ring`, :func:`spmv_csr_ring`): x stays cut into
  column blocks; each shard packs the columns of its block that other
  shards read, and the packed slices rotate round the ring, n-1 steps of
  rotate-then-accumulate over per-(shard, source) window-ELL plans.

The shards' outputs are stitched in true row order into one tensor on the
mesh's home device.  The JAX package stacks the shard plans into padded
arrays of one static shape for ``shard_map``; here a tuple holds each
shard's plan on its shard's device, and nothing is padded.

A :class:`RowMesh` moves data between shards in one of two ways behind one
interface (:func:`_gather_rows`: the row blocks to the home device;
:func:`_rotate`: a buffer one step round the ring):

* a local mesh: every shard lives in this process, each on a device of its
  own or repeating one (``["cpu"] * 8`` in the tests, ``["cuda:0"] * 4`` on
  one card): copies between devices.  Each shard's kernels launch on its
  device's current stream, the kernel wrappers making that device current
  around each launch;
* a process-group mesh (``torch.distributed`` initialised): one shard per
  rank, ``all_gather_into_tensor`` for the gather and ``batch_isend_irecv``
  for the rotation.  Each rank builds and runs its own shard only.

Correctness oracle: ``spmv_cpu_csr`` on the unpartitioned matrix.
"""

from __future__ import annotations

import dataclasses
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..csr import CSRMatrix, DeviceCSR
from ..errors import (DeviceAllocError, InvalidArgumentError,
                      InvalidDimensionError, InvalidFormatError, SpMVError,
                      guarded_upload)
from ..kernels.plan import (BAND_WORKERS, WindowEllOverflow, _choose_sup,
                            _slice_rows, build)
from ..kernels.scalar import spmv_csr_scalar
from ..kernels.window_ell import plan_from_host, spmv_window_ell

# the superblock height of every ring plan (``distributed.py:755-765``)
RING_SUP = 1024


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None) -> None:
    """Join this process to a process group, so that :func:`make_row_mesh`
    gives one shard per rank (the JAX ``init_distributed``,
    ``distributed.py:58-77``, on ``torch.distributed.init_process_group``:
    NCCL where a card is present, gloo on the CPU).

    ``coordinator_address`` is ``host:port`` or a URL.  With none of the
    arguments and none of ``COORDINATOR_ADDRESS``,
    ``JAX_COORDINATOR_ADDRESS`` and ``MASTER_ADDR`` set, it does nothing: a
    single process needs no group.  An argument left out comes from the
    environment (``WORLD_SIZE``, ``RANK``; ``env://`` for the address).  A
    process already in a group stays in it."""
    import torch.distributed as dist

    address = coordinator_address or os.environ.get(
        "COORDINATOR_ADDRESS") or os.environ.get("JAX_COORDINATOR_ADDRESS")
    if address is None and num_processes is None \
            and "MASTER_ADDR" not in os.environ:
        return
    if dist.is_initialized():
        return
    init = "env://" if address is None \
        else address if "://" in address else f"tcp://{address}"
    dist.init_process_group(
        "nccl" if torch.cuda.is_available() else "gloo", init_method=init,
        world_size=int(os.environ.get("WORLD_SIZE", 1))
        if num_processes is None else num_processes,
        rank=int(os.environ.get("RANK", 0))
        if process_id is None else process_id)


def _nnz_balanced_bounds(row_ptrs: np.ndarray, n_shards: int) -> np.ndarray:
    """Row bounds (``n_shards + 1``) that cut at the nnz quantiles, so the
    shards hold near-equal nonzeros (``distributed.py:80-95``)."""
    rows = len(row_ptrs) - 1
    nnz = int(row_ptrs[-1])
    targets = (np.arange(1, n_shards, dtype=np.int64) * nnz) // n_shards
    cuts = np.searchsorted(row_ptrs, targets, side="left")
    bounds = np.concatenate([[0], cuts, [rows]]).astype(np.int64)
    return np.maximum.accumulate(bounds)


def _imbalance_of(shard_nnz: tuple) -> float:
    """max/mean - 1 of per-shard nnz (0 = perfectly balanced)."""
    s = np.asarray(shard_nnz, np.float64)
    if s.size == 0 or s.mean() == 0:
        return 0.0
    return float(s.max() / s.mean() - 1.0)


@dataclasses.dataclass(frozen=True)
class RowMesh:
    """The shards' devices in row order, and how data moves between them.
    ``group`` is None for a local mesh (every shard in this process); else
    the process group whose rank ``r`` holds shard ``r``, this process
    being ``rank`` (its own device stands in every entry of ``devices``:
    a rank never touches another's shard)."""

    devices: tuple
    group: object = None
    rank: int = 0

    @property
    def n_shards(self) -> int:
        return len(self.devices)

    @property
    def local(self) -> tuple:
        """The shards this process holds."""
        return tuple(range(self.n_shards)) if self.group is None \
            else (self.rank,)

    @property
    def home(self) -> torch.device:
        """Where results land: the first shard's device, or this rank's."""
        return self.devices[0 if self.group is None else self.rank]


def make_row_mesh(n_devices: int | None = None,
                  devices=None) -> RowMesh:
    """A row mesh (the JAX ``make_row_mesh``, ``distributed.py:113-124``).

    With ``devices`` (a list of devices or names; one may repeat, as in
    ``["cuda:0"] * 4``): a local mesh over its first ``n_devices`` (all by
    default).  Else, in a process group (:func:`init_distributed`): one
    shard per rank, on card ``rank % device_count`` under NCCL and on the
    CPU under gloo.  Else a local mesh over the first ``n_devices`` cards
    (all by default).  Asking for more devices than there are raises
    :class:`InvalidArgumentError`; a card where none is present
    :class:`DeviceAllocError`."""
    import torch.distributed as dist

    if devices is not None:
        devs = tuple(torch.device(d) for d in devices)
        n = len(devs) if n_devices is None else n_devices
        if not 0 < n <= len(devs):
            raise InvalidArgumentError(
                f"requested {n} devices, have {len(devs)}")
        if any(d.type == "cuda" for d in devs[:n]) \
                and not torch.cuda.is_available():
            raise DeviceAllocError("make_row_mesh: no CUDA device is "
                                   "available")
        return RowMesh(devs[:n])
    if dist.is_available() and dist.is_initialized():
        world, rank = dist.get_world_size(), dist.get_rank()
        if n_devices not in (None, world):
            raise InvalidArgumentError(
                f"requested {n_devices} shards in a group of {world}")
        dev = torch.device("cuda", rank % torch.cuda.device_count()) \
            if dist.get_backend() == "nccl" else torch.device("cpu")
        return RowMesh((dev,) * world, dist.group.WORLD, rank)
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if count == 0:
        raise DeviceAllocError("make_row_mesh: no CUDA device is available "
                               "(name the devices to run elsewhere)")
    n = count if n_devices is None else n_devices
    if not 0 < n <= count:
        raise InvalidArgumentError(f"requested {n} devices, have {count}")
    return RowMesh(tuple(torch.device("cuda", i) for i in range(n)))


def _on_threads(fn, items) -> list:
    """``[fn(i) for i in items]``, the calls on threads: the planner's
    NumPy and native passes release the GIL for most of their time."""
    items = list(items)
    with ThreadPoolExecutor(max(1, min(BAND_WORKERS, len(items)))) as pool:
        return list(pool.map(fn, items))


def _stitch_rows(y_padded: torch.Tensor, bounds: tuple,
                 rps: int) -> torch.Tensor:
    """The true-order rows of a frame of ``rps`` rows per shard
    (``distributed.py:98-110``): each shard's valid prefix, joined."""
    return torch.cat([y_padded[d * rps: d * rps + bounds[d + 1] - bounds[d]]
                      for d in range(len(bounds) - 1)])


def _gather_rows(mesh: RowMesh, ys: dict, bounds: tuple,
                 rps: int) -> torch.Tensor:
    """The shards' outputs (``ys[d]``: shard ``d``'s rows first, on its
    device) in true row order, as one tensor on the home device: copies on
    a local mesh, ``all_gather_into_tensor`` of ``rps``-row frames in a
    process group."""
    if mesh.group is None:
        return torch.cat([
            ys[d][: bounds[d + 1] - bounds[d]].to(mesh.home,
                                                  non_blocking=True)
            for d in range(mesh.n_shards)])
    import torch.distributed as dist

    (d, y), = ys.items()
    frame = torch.zeros(rps, dtype=torch.float32, device=y.device)
    frame[: bounds[d + 1] - bounds[d]] = y[: bounds[d + 1] - bounds[d]]
    out = torch.empty(mesh.n_shards * rps, dtype=torch.float32,
                      device=y.device)
    dist.all_gather_into_tensor(out, frame, group=mesh.group)
    return _stitch_rows(out, bounds, rps)


def _rotate(mesh: RowMesh, bufs: dict) -> dict:
    """One step round the ring: shard ``d``'s buffer goes to shard ``d+1``
    (mod n); copies on a local mesh, ``batch_isend_irecv`` in a process
    group."""
    n = mesh.n_shards
    if mesh.group is None:
        return {(d + 1) % n: b.to(mesh.devices[(d + 1) % n],
                                  non_blocking=True)
                for d, b in bufs.items()}
    import torch.distributed as dist

    (d, b), = bufs.items()
    recv = torch.empty_like(b)
    ops = [dist.P2POp(dist.isend, b, (d + 1) % n, mesh.group),
           dist.P2POp(dist.irecv, recv, (d - 1) % n, mesh.group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return {d: recv}


def _partition(A: CSRMatrix, n: int) -> tuple:
    """``(bounds, rows_per_shard, shard_nnz)`` of ``A`` cut into ``n``
    nnz-balanced row blocks."""
    ptr = A.row_ptrs
    bounds = _nnz_balanced_bounds(ptr, n)
    rps = max(int(np.diff(bounds).max(initial=0)), 1)
    shard_nnz = ptr[bounds[1:]] - ptr[bounds[:-1]]
    return (tuple(int(b) for b in bounds), rps,
            tuple(int(v) for v in shard_nnz))


def _mesh_of(sharded, mesh: RowMesh | None) -> RowMesh:
    """The mesh a sharded matrix lives on; a different ``mesh`` is refused
    (its plans are on their shards' devices)."""
    if mesh is not None and mesh != sharded.mesh:
        raise InvalidArgumentError("the matrix is sharded over another mesh")
    return sharded.mesh


def _vector(x, n: int, device: torch.device) -> torch.Tensor:
    """``x`` (an array or tensor of ``n`` values) as f32 on ``device``."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.array(x, np.float32, copy=True))
    if x.dim() != 1 or x.numel() != n:
        raise InvalidDimensionError(
            f"x of shape {tuple(x.shape)} for {n} columns")
    return guarded_upload(x, device).float()


@dataclasses.dataclass(frozen=True)
class ShardedCSR:
    """A row-partitioned CSR matrix: shard ``d`` is the rows
    ``bounds[d]:bounds[d+1]`` as a :class:`~tpu_spmv_torch.csr.DeviceCSR` on
    its device (None for a shard another rank holds)."""

    shards: tuple
    mesh: RowMesh
    num_rows: int
    num_cols: int
    nnz: int
    rows_per_shard: int     # the tallest shard's rows
    bounds: tuple           # global row bounds per shard (n_shards + 1)
    shard_nnz: tuple = ()

    @property
    def n_shards(self) -> int:
        return len(self.shards)

    @property
    def nnz_imbalance(self) -> float:
        return _imbalance_of(self.shard_nnz)


def shard_csr(A: CSRMatrix, mesh: RowMesh) -> ShardedCSR:
    """Cut ``A`` into nnz-balanced row blocks over ``mesh`` and put each
    block on its shard's device (``distributed.py:171-212``)."""
    bounds, rps, shard_nnz = _partition(A, mesh.n_shards)
    shards = [None] * mesh.n_shards
    for d in mesh.local:
        shards[d] = DeviceCSR.from_host(
            _slice_rows(A, bounds[d], bounds[d + 1]), mesh.devices[d])
    return ShardedCSR(tuple(shards), mesh, A.num_rows, A.num_cols, A.nnz,
                      rps, bounds, shard_nnz)


def spmv_csr_sharded(sharded: ShardedCSR, x,
                     mesh: RowMesh | None = None) -> torch.Tensor:
    """``y = A @ x`` with A row-sharded and x replicated, each shard on the
    flat CSR path; the ``(num_rows,)`` result on the mesh's home device
    (``distributed.py:238-247``)."""
    mesh = _mesh_of(sharded, mesh)
    x = _vector(x, sharded.num_cols, mesh.home)
    ys = {}
    for d in mesh.local:
        ys[d] = spmv_csr_scalar(sharded.shards[d],
                                x.to(mesh.devices[d], non_blocking=True))
    return _gather_rows(mesh, ys, sharded.bounds, sharded.rows_per_shard)


@dataclasses.dataclass(frozen=True)
class ShardedWindowEll:
    """Row-partitioned window-ELL plans: shard ``d``'s plan packs the rows
    ``bounds[d]:bounds[d+1]``, padded with empty rows to ``rows_per_shard``,
    on its device (None for a shard another rank holds).  Every plan has
    one superblock height.  A pattern sharding keeps the column scale s of
    ``A = B·diag(s)`` on the home device, applied to x before the
    kernels."""

    plans: tuple
    col_scale: torch.Tensor | None
    mesh: RowMesh
    num_rows: int
    num_cols: int
    nnz: int
    rows_per_shard: int
    bounds: tuple
    shard_nnz: tuple = ()

    @property
    def n_shards(self) -> int:
        return len(self.plans)

    @property
    def nnz_imbalance(self) -> float:
        return _imbalance_of(self.shard_nnz)

    @property
    def _held(self) -> list:
        return [p for p in self.plans if p is not None]

    @property
    def pat(self) -> bool:
        return self._held[0].pat

    @property
    def has_lam(self) -> bool:
        """True when the shard plans are leveled (``permute_rows``)."""
        return self._held[0].lam is not None

    @property
    def sup(self) -> int:
        return self._held[0].sup


def shard_csr_packed(A: CSRMatrix, mesh: RowMesh,
                     split_rows: int | None = 128, pattern: bool = False,
                     permute_rows: bool = False,
                     values_dtype=np.float32) -> ShardedWindowEll:
    """Cut ``A`` into nnz-balanced row blocks over ``mesh`` and pack each
    with the window-ELL planner (``distributed.py:467-533``), the shards'
    plans built on threads.  The superblock height is chosen once from the
    whole matrix, at ``split_rows`` (F1).  Raises
    :class:`~tpu_spmv_torch.kernels.plan.WindowEllOverflow` where a shard's
    structure rejects the packed layout: callers fall back to
    :func:`shard_csr`.

    ``pattern=True`` needs ``A = B·diag(s)`` (every column's stored values
    equal, :func:`tpu_spmv_torch.pagerank.column_scale_factor`), else
    :class:`InvalidFormatError`; the plans then stream no values.
    ``permute_rows`` levels each shard's rows onto lanes; ``values_dtype``
    is float32 or bfloat16."""
    col_scale = None
    if pattern:
        from ..pagerank import column_scale_factor

        col_scale = column_scale_factor(A)
        if col_scale is None:
            raise InvalidFormatError(
                "shard_csr_packed(pattern=True): matrix values are not "
                "column-scaled (A = B*diag(s) does not hold)")
        col_scale = guarded_upload(col_scale, mesh.home)
    bounds, rps, shard_nnz = _partition(A, mesh.n_shards)
    sup = _choose_sup(A, split_rows=split_rows)

    def make(d):
        sub = _slice_rows(A, bounds[d], bounds[d + 1], pad_to=rps)
        return plan_from_host(
            build(sub, split_rows=split_rows, sup=sup, pattern=pattern,
                  permute_rows=permute_rows, values_dtype=values_dtype),
            mesh.devices[d])

    plans = [None] * mesh.n_shards
    for d, p in zip(mesh.local, _on_threads(make, mesh.local)):
        plans[d] = p
    return ShardedWindowEll(tuple(plans), col_scale, mesh, A.num_rows,
                            A.num_cols, A.nnz, rps, bounds, shard_nnz)


def spmv_csr_sharded_packed(sp: ShardedWindowEll, x,
                            mesh: RowMesh | None = None) -> torch.Tensor:
    """``y = A @ x`` with each row shard running its window-ELL plan and x
    replicated (a pattern sharding's x scaled first); the ``(num_rows,)``
    result on the mesh's home device (``distributed.py:577-590``)."""
    mesh = _mesh_of(sp, mesh)
    x = _vector(x, sp.num_cols, mesh.home)
    if sp.col_scale is not None:
        x = sp.col_scale * x
    ys = {}
    for d in mesh.local:
        ys[d] = spmv_window_ell(sp.plans[d],
                                x.to(mesh.devices[d], non_blocking=True))
    return _gather_rows(mesh, ys, sp.bounds, sp.rows_per_shard)


def pagerank_sharded(sharded, dangling_mask, config=None,
                     mesh: RowMesh | None = None):
    """PageRank over a row-sharded matrix (``distributed.py:250-327``): the
    power iteration of :func:`tpu_spmv_torch.pagerank.pagerank` (the same
    loop, :func:`~tpu_spmv_torch.pagerank._iterate`, so both stop on the
    same test), each iteration's SpMV through :func:`spmv_csr_sharded` or,
    for a :class:`ShardedWindowEll`, :func:`spmv_csr_sharded_packed` (a
    pattern sharding scales the ranks by its column scale).  The ranks live
    on the mesh's home device.  ``dangling_mask`` is
    :func:`~tpu_spmv_torch.pagerank.find_dangling_mask` of the
    unpartitioned matrix.  A non-square matrix gives
    ``INVALID_DIMENSION``, an empty one empty ranks."""
    from ..pagerank import PageRankConfig, PageRankResult, _iterate

    cfg = config or PageRankConfig()
    mesh = _mesh_of(sharded, mesh)
    spmv = {ShardedCSR: spmv_csr_sharded,
            ShardedWindowEll: spmv_csr_sharded_packed}.get(type(sharded))
    if spmv is None:
        raise InvalidArgumentError(
            f"pagerank_sharded takes a ShardedCSR or a ShardedWindowEll, "
            f"not a {type(sharded).__name__}")
    n = sharded.num_rows
    result = PageRankResult()
    if sharded.num_cols != n:
        result.error_code = int(SpMVError.INVALID_DIMENSION)
        result.final_residual = float("nan")
        return result
    if n == 0:
        result.ranks = torch.zeros(0, dtype=torch.float32, device=mesh.home)
        return result
    mask = _vector(np.asarray(dangling_mask, np.float32)[:n], n, mesh.home)
    r0 = torch.full((n,), 1.0 / n, dtype=torch.float32, device=mesh.home)
    it, ranks, residual = _iterate(
        lambda r: spmv(sharded, r), mask, r0, n, float(cfg.damping_factor),
        float(cfg.tolerance), int(cfg.max_iterations))
    result.ranks = ranks
    result.iterations = it
    result.final_residual = residual
    result.converged = residual < cfg.tolerance
    result.plan = sharded
    return result


def pagerank_step_sharded(sharded: ShardedCSR, ranks, dangling_mask,
                          damping: float = 0.85,
                          mesh: RowMesh | None = None) -> torch.Tensor:
    """One PageRank power iteration over a row-sharded matrix
    (``distributed.py:330-341``): the sharded SpMV, then the teleport and
    dangling terms, on the mesh's home device."""
    mesh = _mesh_of(sharded, mesh)
    n = sharded.num_rows
    r = _vector(ranks, n, mesh.home)
    mask = _vector(np.asarray(dangling_mask, np.float32)[:n], n, mesh.home)
    Ar = spmv_csr_sharded(sharded, r, mesh)
    return damping * Ar + damping * torch.dot(mask, r) / n \
        + (1.0 - damping) / n


# ---- the ring: x row-sharded, packed footprint slices rotated ----

@dataclasses.dataclass(frozen=True)
class RingShardedCSR:
    """Row-partitioned CSR with per-(shard, source) plans
    (``distributed.py:611-657``).  Per shard ``d`` (None where another rank
    holds it): ``diag_plans[d]`` over its own column block, which needs no
    communication; ``ring_plans[d]``, the n-1 plans for the sources in ring
    order (step ``r`` uses source ``(d - r) mod n``), each over the
    source's packed column footprint; ``pack_idx[d]``, the block-local
    columns of block ``d`` that other shards read (int32, ``u_max``
    entries, zero-padded), which shard ``d`` packs before the rotation."""

    diag_plans: tuple
    ring_plans: tuple
    pack_idx: tuple
    mesh: RowMesh
    num_rows: int
    num_cols: int
    nnz: int
    rows_per_shard: int
    cols_per_shard: int
    u_max: int               # the packed buffer's length
    bounds: tuple            # row bounds (n+1)
    col_bounds: tuple        # x block bounds (n+1)
    shard_nnz: tuple = ()
    pack_len: tuple = ()     # true footprint size per source block

    @property
    def n_shards(self) -> int:
        return len(self.pack_idx)

    @property
    def nnz_imbalance(self) -> float:
        return _imbalance_of(self.shard_nnz)


def _sub_block_csr(A: CSRMatrix, r0: int, r1: int, rps: int,
                   col_sel: np.ndarray, col_map: np.ndarray,
                   num_cols: int) -> CSRMatrix:
    """Rows [r0, r1) of A restricted to the selected columns, the columns
    remapped through ``col_map``, the rows padded to ``rps``
    (``distributed.py:660-676``)."""
    ptr = A.row_ptrs
    lo, hi = int(ptr[r0]), int(ptr[r1])
    cols = A.col_indices[lo:hi]
    vals = A.values[lo:hi]
    keep = col_sel[cols]
    rows_of = np.repeat(np.arange(r1 - r0, dtype=np.int64),
                        np.diff(ptr[r0:r1 + 1]).astype(np.int64))[keep]
    new_ptr = np.zeros(rps + 1, np.int32)
    np.cumsum(np.bincount(rows_of, minlength=rps), out=new_ptr[1:])
    return CSRMatrix(rps, num_cols, vals[keep],
                     col_map[cols[keep]].astype(np.int32), new_ptr)


def _ring_max_shards() -> int:
    """The ring's mesh-size cap (``distributed.py:679-692``): the ring
    builds n*(n-1) block-pair plans, so its build grows as the square of
    the mesh; past the cap callers fall back to the replicated-packed form.
    ``TPU_SPMV_RING_MAX`` overrides the default of 16."""
    return int(os.environ.get("TPU_SPMV_RING_MAX", 16))


def shard_csr_ring(A: CSRMatrix, mesh: RowMesh,
                   split_rows: int | None = 128) -> RingShardedCSR:
    """The ring-sharded form (``distributed.py:695-794``): nnz-balanced row
    blocks, even column blocks of x, per-(shard, source) plans at
    superblock height 1024 over the compressed column footprints, built on
    threads.  Raises
    :class:`~tpu_spmv_torch.kernels.plan.WindowEllOverflow` where a pair
    rejects the packed layout, or where the mesh is larger than
    :func:`_ring_max_shards`; callers then fall back to the
    replicated-packed form, as JAX callers do."""
    n = mesh.n_shards
    cap = _ring_max_shards()
    if n > cap:
        raise WindowEllOverflow(
            f"ring sharding builds n*(n-1)={n * (n - 1)} block-pair plans; "
            f"mesh size {n} exceeds the quadratic-build cap {cap} "
            f"(TPU_SPMV_RING_MAX) — use the replicated-packed form")
    bounds, rps, shard_nnz = _partition(A, n)
    ptr = A.row_ptrs
    cps = -(-max(A.num_cols, 1) // n)
    col_bounds = np.minimum(np.arange(n + 1, dtype=np.int64) * cps,
                            A.num_cols)

    # column footprints: for each source block e, its columns referenced by
    # any OTHER shard (diagonal use never travels)
    src_of_col = np.minimum(A.col_indices // cps, n - 1).astype(np.int64)
    used = np.zeros((n, A.num_cols), np.bool_)
    for d in range(n):
        lo, hi = int(ptr[bounds[d]]), int(ptr[bounds[d + 1]])
        cols_d = A.col_indices[lo:hi]
        used[d, cols_d[src_of_col[lo:hi] != d]] = True
    any_used = used.any(axis=0)
    pack_lists = [
        np.nonzero(any_used[col_bounds[e]:col_bounds[e + 1]])[0]
        .astype(np.int64) for e in range(n)]
    u_max = max(max((len(p) for p in pack_lists), default=0), 1)
    # the rotating buffer is padded to a multiple of 8 only, to keep the
    # footprint's compression; the table's set-up pads it to the plan's
    # cols_pad
    u_pad = -(-u_max // 8) * 8
    pack_idx = np.zeros((n, u_pad), np.int32)
    col_map = np.zeros(A.num_cols, np.int64)     # global col -> packed
    col_sel_other = np.zeros(A.num_cols, np.bool_)
    for e in range(n):
        c0 = int(col_bounds[e])
        pack_idx[e, : len(pack_lists[e])] = pack_lists[e]
        col_map[c0 + pack_lists[e]] = np.arange(len(pack_lists[e]))
        col_sel_other[c0 + pack_lists[e]] = True
    ident = np.arange(A.num_cols, dtype=np.int64)

    def make(task):
        """Step ``r`` of shard ``d``'s plans: 0 its own block, else the
        packed footprint of source ``(d - r) mod n``."""
        d, r = task
        r0, r1 = bounds[d], bounds[d + 1]
        e = (d - r) % n
        e0, e1 = int(col_bounds[e]), int(col_bounds[e + 1])
        sel = np.zeros(A.num_cols, np.bool_)
        if r == 0:
            sel[e0:e1] = True
            sub = _sub_block_csr(A, r0, r1, rps, sel, ident - e0, cps)
        else:
            sel[e0:e1] = col_sel_other[e0:e1]
            sub = _sub_block_csr(A, r0, r1, rps, sel, col_map, u_pad)
        return plan_from_host(build(sub, split_rows=split_rows,
                                    sup=RING_SUP), mesh.devices[d])

    tasks = [(d, r) for d in mesh.local for r in range(n)]
    built = dict(zip(tasks, _on_threads(make, tasks)))
    diag, ring, packs = [None] * n, [None] * n, [None] * n
    for d in mesh.local:
        diag[d] = built[d, 0]
        ring[d] = tuple(built[d, r] for r in range(1, n))
        packs[d] = guarded_upload(pack_idx[d], mesh.devices[d])
    return RingShardedCSR(
        tuple(diag), tuple(ring), tuple(packs), mesh, A.num_rows,
        A.num_cols, A.nnz, rps, cps, u_pad, bounds,
        tuple(int(b) for b in col_bounds), shard_nnz,
        tuple(len(p) for p in pack_lists))


def ring_traffic_report(rs: RingShardedCSR) -> dict:
    """The byte model per SpMV and device (``distributed.py:797-827``):
    ``replicate_bytes``, an all-gather of x before compute ((n-1)/n of x
    received); ``ring_bytes``, n-1 hops of the packed slice;
    ``ideal_pairwise_bytes``, the footprint-mean bound of an all-to-all of
    exactly the pairs' footprints."""
    n = rs.n_shards
    if n <= 1:
        return {"n_shards": 1, "replicate_bytes": 0, "ring_bytes": 0,
                "ideal_pairwise_bytes": 0, "compression": 1.0,
                "ring_wins": False}
    replicate = (n - 1) * rs.cols_per_shard * 4
    ring = (n - 1) * rs.u_max * 4
    ideal = (n - 1) * int(np.mean(rs.pack_len)) * 4
    return {
        "n_shards": n,
        "replicate_bytes": int(replicate),
        "ring_bytes": int(ring),
        "ideal_pairwise_bytes": int(ideal),
        "compression": float(replicate / max(ring, 1)),
        "ring_wins": bool(ring < replicate),
    }


def spmv_csr_ring(rs: RingShardedCSR, x,
                  mesh: RowMesh | None = None) -> torch.Tensor:
    """``y = A @ x`` with x cut into column blocks and ring-exchanged
    (``distributed.py:830-888``): each shard's SpMV over its own block, its
    packed slice, then n-1 steps of rotating the slices one shard on and
    adding the SpMV of the slice it now holds; the ``(num_rows,)`` result
    on the mesh's home device."""
    mesh = _mesh_of(rs, mesh)
    n, cps = rs.n_shards, rs.cols_per_shard
    x = torch.nn.functional.pad(_vector(x, rs.num_cols, mesh.home),
                                (0, n * cps - rs.num_cols))
    ys, bufs = {}, {}
    for d in mesh.local:
        xblk = x[d * cps:(d + 1) * cps].to(mesh.devices[d],
                                           non_blocking=True)
        ys[d] = spmv_window_ell(rs.diag_plans[d], xblk)
        bufs[d] = xblk.index_select(0, rs.pack_idx[d])
    for r in range(1, n):
        bufs = _rotate(mesh, bufs)
        for d in mesh.local:
            ys[d] = ys[d] + spmv_window_ell(rs.ring_plans[d][r - 1],
                                            bufs[d])
    return _gather_rows(mesh, ys, rs.bounds, rs.rows_per_shard)
