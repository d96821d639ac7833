"""SpMV dispatch, configuration and result types (port of
``tpu_spmv/spmv.py``).

``spmv_csr`` (and ``spmv_ell``, below) validates its arguments before any
device work, resolves the plan the JAX dispatch would
(``tpu_spmv/spmv.py:137-206``, ``:285-455``), runs it on the card unless the
caller names another device, and reports errors through
``SpMVResult.error_code`` with the JAX package's codes (the reference's
no-throw contract). The routes, in the JAX order:

* VECTOR_CSR and MERGE_PATH: the pattern plan of the 0/1 structure where
  ``SpMVConfig.pattern`` is set and the values are column-scaled (K4's
  plan where :func:`merge_route` says so, else a single plan or a
  row-banded stack); else, up to ``VMEM_X_MAX_COLS`` columns, the
  block-reordered plan where the reorder probe applies, else K4's plan
  (the merge-path CSR kernel, an f32 value stream) where
  :func:`merge_route` says so, else ``build_auto``'s single plan or
  row-banded stack (with an f32 or bf16 value stream); on the card, a
  window-ELL plan of an f32 stream (reordered or not) gives way to K4's
  where two trials on the card both time K4's call under ``ROUTE_MARGIN``
  of its own (:func:`_second_opinion`, once per matrix and device); past
  that width, or where ``build_auto`` overflows, the composite plan (f32
  levels and a flat tail); past ``PACKED_MAX_COLS``, column strips;
* SCALAR_CSR: the naive plan (no row splits, no spill), where it fits;
* the flat path (:mod:`.kernels.scalar`) for ELL_KERNEL on a CSR, for
  ``use_vmem_x=False``, and for a structure every packed layout rejects.

Besides the two entries, other modules reach plans through four names:
:func:`resolve_csr` and :func:`resolve_ell` give the plan that serves a
matrix, :func:`run_plan` runs one SpMV through a plan eagerly, and
:func:`cached` keeps what is derived from a matrix in its plan cache, on
the host and per device.

A call whose packed route overflows is served as SCALAR_CSR, as the JAX
dispatch does.  A route that runs out of device memory
(``torch.OutOfMemoryError``: the per-call gather table, output or partial
buffers, which the plan-time guards cannot see) ends the call with
``SpMVError.EXECUTION``, logged as a warning on the ``tpu_spmv_torch``
logger.  The JAX dispatch's fallback ladder (``tpu_spmv/spmv.py:246-282``,
``:502-531``) is not ported: its rungs would hand a packed route's call to
the flat path's torch ops on the card, and each needs more memory than the
buffer that failed.  No route is ever retried on another: a kernel that
fails to launch (:class:`~tpu_spmv_torch.errors.DeviceException`) ends the
call with ``EXECUTION`` too, and one that fails to build, like any other
error, propagates.

On the card the dispatch replays a plan's call as one CUDA graph
(:class:`CallGraph`) wherever the plan's whole call is the port's kernels
and torch ops that never wait on the host (:func:`graphable`: a window-ELL
plan, a banded stack, K4's plan, a pattern plan over any of them, a
reordered plan over the first two).  A matrix's first call on such a plan
runs eagerly, the second captures it, and every later call copies ``x``
in, replays the graph and copies ``y`` out into a tensor of its own: the
same kernels in the same order, so the output is the eager call's bit for
bit.  The graph is cached
on the matrix beside its plan (``free_device()`` drops both).  A call on
another stream than the capture's, or while another thread holds the
graph's buffers, runs eagerly; a plan whose capture fails runs eagerly
from then on, logged once.  ``measure=True``'s timed calls and PageRank's
SpMVs run the plan eagerly.

``spmv_csr`` also takes a 2-D operand ``X`` of ``(num_cols, k)`` (a graph
network's node features, several right-hand sides), which no JAX route
takes: K5, the merge-path CSR SpMM (:mod:`.kernels.merge_csr`), serves it
under every kernel type, from one plan a matrix and device
(:func:`resolve_spmm`), eagerly (a captured graph would copy the whole
operand in and the output out on every call), its f32 value stream only.

``spmv_ell`` routes an :class:`~tpu_spmv_torch.ell.ELLMatrix` as the JAX
``_resolve_ell_kernel`` does (``tpu_spmv/spmv.py:557-591``): up to
``VMEM_X_MAX_COLS`` columns the pattern route of its CSR form where
``SpMVConfig.pattern`` is set and the values are column-scaled, else one
window-ELL plan of its CSR form at the planner's defaults; up to
``PACKED_MAX_COLS``, column strips of its CSR form; else, or where the
single plan overflows or a strip rejects every packed layout, the
slot-major flat ELL path (:mod:`.kernels.ell_kernel`).
"""

from __future__ import annotations

import contextlib
import dataclasses
import enum
import logging
import os
import threading
import time

import numpy as np
import torch

from .bandwidth import (BandwidthMetrics, compute_bandwidth_csr,
                        compute_bandwidth_ell)
from .csr import CSRMatrix, DeviceCSR, column_scale_factor
from .ell import DeviceELL, ELLMatrix
from . import profiling
from .errors import (DeviceAllocError, DeviceException, SpMVError,
                     SpMVException, guarded_upload)
from .kernels import add_launch_counts, launch_counts, launch_total, upload
from .kernels.merge_csr import (GROUP_SLOTS, MergePlan, SpmmPlan,
                                host_merge, merge_from_host, spmm_from_host,
                                spmm_merge, spmv_merge)
from .kernels.plan import (K1_SLOT_PS, K4_NNZ_PS, K4_ROW_PS,
                           WindowEllOverflow, _choose_sup, build, build_auto,
                           build_composite)
from .kernels.ell_kernel import spmv_ell_device
from .kernels.reorder import (HostReordered, ReorderedPlan,
                              build_reordered_host, maybe_reorder,
                              spmv_reordered, standalone_permutes)
from .kernels.scalar import spmv_csr_scalar
from .kernels.strips import (STRIP_MAX_COLS, HostStrips, StripPlan,
                             build_strips_host, spmv_strips)
from .kernels.window_ell import (BandedPlan, CompositePlan, WindowEllPlan,
                                 spmv_banded, spmv_composite, spmv_pattern,
                                 spmv_pattern_banded, spmv_window_ell)
from .kernels.window_ell import _current_stream

# the JAX package's column caps (TPU VMEM limits), kept so both packages
# route the same matrices the same way; ROADMAP M13 revisits them
VMEM_X_MAX_COLS = 1 << 20
PACKED_MAX_COLS = 1 << 21

# merge-path row-splitting granularity: rows longer than this are
# stride-split into extra rows
MERGE_SPLIT_ROWS = 128

# measure=True: warm-up calls before the timed samples
MEASURE_WARMUP = 10

# the second opinion (_second_opinion): K4 takes a matrix the model kept on
# window-ELL only where its replayed call takes under this share of
# window-ELL's in each of two trials in turn, so that a near-tie keeps the
# JAX planner's plan and one noisy reading cannot take the route; a matrix
# whose two calls sit within the trials' noise of the margin can still get
# either route from one process to the next (and the two round
# differently); each call timed as the median of ROUTE_SAMPLES batches of
# ROUTE_ITERS back-to-back calls
ROUTE_MARGIN = 0.9
ROUTE_ITERS = 20
ROUTE_SAMPLES = 5

log = logging.getLogger("tpu_spmv_torch")

# host artefacts made by cached(), a count for the spmv.plan span
_host_builds = 0
# second opinions taken (_second_opinion), and those K4 won
_route_trials = 0
_route_wins = 0


class KernelType(enum.IntEnum):
    """Reference ``SpMVConfig::KernelType`` (``spmv.h:12-17``)."""

    SCALAR_CSR = 0   # naive packed layout; flat gather as the floor
    VECTOR_CSR = 1   # window-ELL kernel, lane-per-row
    MERGE_PATH = 2   # window-ELL + row splitting (equal work) + combine
    ELL_KERNEL = 3   # slot-major ELL kernel


@dataclasses.dataclass
class SpMVConfig:
    """Reference ``SpMVConfig`` (``spmv.h:11-24``) with the JAX package's
    knobs (see ``tpu_spmv/spmv.py`` for each)."""

    kernel_type: KernelType = KernelType.SCALAR_CSR
    block_size: int = 256          # step_groups = block_size // 2
    use_vmem_x: bool = True
    pattern: bool = False
    bf16_values: bool = False
    reorder: bool | None = None

    @property
    def step_groups(self) -> int | None:
        """Plan step width; ``None`` = the planner's default."""
        if self.block_size == 256:
            return None
        return max(8, self.block_size // 2)


@dataclasses.dataclass(frozen=True)
class PatternPlan:
    """The pattern fast path's plan: a pattern plan (or row-banded stack of
    them, or K4's pattern plan) of the 0/1 structure B of ``A =
    B·diag(scale)`` and the column scale, both on one device (the JAX
    dispatch's ``(spmv_pattern, (plan, scale))`` or
    ``(spmv_pattern_banded, ...)``)."""

    plan: WindowEllPlan | BandedPlan | MergePlan
    scale: torch.Tensor       # f32 (num_cols,)

    @property
    def stream_bytes(self) -> float:
        """The pattern plan's bytes, as the JAX bench counts them (the
        scale multiply, 12 B per column, left out)."""
        return self.plan.stream_bytes


# what serves an SpMV: a packed plan or stack of them, or the matrix itself
# on a flat path; K5's plan serves the SpMM of a 2-D operand
Plan = (WindowEllPlan | BandedPlan | CompositePlan | StripPlan | ReorderedPlan
        | MergePlan | PatternPlan | DeviceCSR | DeviceELL | SpmmPlan)


@dataclasses.dataclass
class SpMVResult:
    """Reference ``SpMVResult`` (``spmv.h:27-36``)."""

    y: torch.Tensor | None = None
    elapsed_ms: float = 0.0
    gflops: float = 0.0
    bandwidth_gb_s: float = 0.0
    error_code: int = 0
    bandwidth: BandwidthMetrics | None = None
    plan: Plan | None = None    # the plan that served it
    plan_seconds: float = 0.0   # plan resolution in this call (build +
    #                             upload; a cache hit takes microseconds)

    def y_host(self) -> np.ndarray | None:
        return self.y.cpu().numpy() if self.y is not None else None


def spmv_validate_dimensions(num_cols: int, vec_size: int) -> bool:
    """Reference inline validator (``spmv.h:52-54``)."""
    return num_cols == vec_size


def _split(kernel_type: KernelType) -> int | None:
    return MERGE_SPLIT_ROWS if kernel_type == KernelType.MERGE_PATH \
        else None


def _memo(A: CSRMatrix | ELLMatrix, key, make):
    """What ``A``'s plan cache holds under ``key``, ``make()`` on a miss."""
    if key not in A._plan_cache:
        A._plan_cache[key] = make()
    return A._plan_cache[key]


def cached(A: CSRMatrix | ELLMatrix, key, device: torch.device, make, put):
    """The device artefact cached on ``A`` under ``(key, str(device))``:
    ``put(host, device)`` of the host artefact cached under ``key``
    (``make()`` on a miss, counted in ``_host_builds``; ``None``
    remembers a rejection and gives ``None``).  Every plan the dispatch
    serves is cached so, and PageRank's dangling mask; ``free_device()``
    drops them all."""
    global _host_builds
    dkey = (key, str(device))
    if dkey not in A._plan_cache:
        if key not in A._plan_cache:
            _host_builds += 1
        host = _memo(A, key, make)
        A._plan_cache[dkey] = None if host is None else put(host, device)
    return A._plan_cache[dkey]


def _sup_choice(A: CSRMatrix, split: int | None) -> tuple:
    """The superblock choice and its estimated groups for ``A`` (a sampled
    O(nnz) model), once per ``split``, cached under ``("_sup", split)``."""
    return _memo(A, ("_sup", split),
                 lambda: _choose_sup(A, with_groups=True, split_rows=split))


def merge_route(A: CSRMatrix, split: int | None, pattern: bool) -> bool:
    """The first opinion on whether K4 (the merge-path CSR kernel) serves
    ``A`` in place of a window-ELL plan: where its predicted device time,
    ``nnz`` and ``rows`` at ``K4_NNZ_PS`` and ``K4_ROW_PS``, is below K1's,
    the superblock choice's estimated groups (a sampled O(nnz) model, once
    per ``split``, memoized for the build) × 1,024 slots at
    ``K1_SLOT_PS``, of the f32 or the pattern value stream
    (``kernels/plan.py``).  An estimate of 0 groups (unknown: the
    dense-narrow class) or one below the nonzeros prices K1 at one slot a
    nonzero, its least.  It reads the matrix alone.  Where it says K4, K4
    serves untimed; where it keeps an f32 window-ELL plan of the CSR entry,
    the card's timing of both calls is the second opinion
    (:func:`_second_opinion`)."""
    _, groups = _sup_choice(A, split)
    slots = max(groups, -(-A.nnz // GROUP_SLOTS)) * GROUP_SLOTS
    v = "pattern" if pattern else "float32"
    return A.nnz * K4_NNZ_PS[v] + A.num_rows * K4_ROW_PS[v] \
        < slots * K1_SLOT_PS[v]


def _host_plan(A: CSRMatrix, split: int | None, config: SpMVConfig):
    """The host plan for ``A`` in the order of ``tpu_spmv/spmv.py:156-205``:
    up to ``VMEM_X_MAX_COLS`` columns the reorder probe (O(nnz), once a
    matrix; the port's probe, unlike the JAX one, does not ask the
    superblock choice), the reordered build where the probe applies and the
    permuted matrix packs, else K4's plan of an f32 stream where
    :func:`merge_route` prefers it, else ``build_auto``'s plan or banded
    stack at the superblock choice (a sampled O(nnz) model, once per
    ``split``); past that width, or where that overflows, the composite
    plan (its levels f32, as in the JAX package).  A reordered build comes
    as a :class:`HostReordered`, K4's as a
    :class:`~.kernels.merge_csr.HostMerge`; a bf16 value stream stays on
    window-ELL (K4 has no bf16 instance).  ``None`` where no composite
    level packs the matrix (:class:`WindowEllOverflow`)."""
    vdt = "bfloat16" if config.bf16_values else "float32"
    if A.num_cols <= VMEM_X_MAX_COLS:
        if config.reorder is not False:
            order = _memo(A, ("_reorder", bool(config.reorder)),
                          lambda: maybe_reorder(A,
                                                force=config.reorder is True))
            if order is not None:
                try:
                    return HostReordered(*build_reordered_host(
                        A, order, split, config.step_groups,
                        values_dtype=vdt), A.num_rows, A.num_cols)
                except WindowEllOverflow:
                    pass   # the permuted matrix packs in no layout
        if not config.bf16_values and merge_route(A, split, pattern=False):
            return host_merge(A, pattern=False)
        try:
            return build_auto(A, step_groups=config.step_groups,
                              split_rows=split, choice=_sup_choice(A, split),
                              values_dtype=vdt)
        except WindowEllOverflow:
            pass
    try:
        return build_composite(A, step_groups=config.step_groups,
                               split_rows=split)
    except WindowEllOverflow:
        return None


def _resolve_pattern(A: CSRMatrix, kernel_type: KernelType,
                     config: SpMVConfig,
                     device: torch.device) -> PatternPlan | None:
    """The pattern fast path (``tpu_spmv/spmv.py:423-455``): a pattern plan
    (K4's where :func:`merge_route` prefers it, else a window-ELL plan or
    banded stack) of the 0/1 structure plus the factored-out column scale.
    Returns ``None`` (the f32 packed path serves) when the values are not
    column-scaled, the pattern plan overflows, or
    ``TPU_SPMV_NO_PATTERN`` is set.  The scale is cached under
    ``"_cscale"``, the host plan (or ``None`` for a rejection) under
    ``("pat", kernel type, step width)``, and the :class:`PatternPlan` under
    that key and the device."""
    if os.environ.get("TPU_SPMV_NO_PATTERN") \
            or A.num_cols > VMEM_X_MAX_COLS:
        return None

    def make():
        if _memo(A, "_cscale", lambda: column_scale_factor(A)) is None:
            return None
        split = _split(kernel_type)
        if merge_route(A, split, pattern=True):
            return host_merge(A, pattern=True)
        try:
            return build_auto(A, step_groups=config.step_groups,
                              split_rows=split, pattern=True,
                              choice=_sup_choice(A, split))
        except WindowEllOverflow:
            return None

    return cached(A, ("pat", int(kernel_type), config.step_groups), device,
                  make, lambda host, dev: PatternPlan(
                      upload(host, dev),
                      guarded_upload(A._plan_cache["_cscale"], dev)))


def _strips_host(A: CSRMatrix, kernel_type: KernelType,
                 config: SpMVConfig) -> HostStrips | None:
    """The host strips of ``A``, or ``None`` where a strip rejects every
    packed layout."""
    try:
        return build_strips_host(A, STRIP_MAX_COLS, config.step_groups,
                                 _split(kernel_type))
    except WindowEllOverflow:
        return None


def _resolve_strips(A: CSRMatrix, kernel_type: KernelType,
                    config: SpMVConfig,
                    device: torch.device) -> StripPlan | None:
    """Column strips (``tpu_spmv/spmv.py:399-420``), or ``None`` where a
    strip rejects every packed layout; the rejection is cached too."""
    return cached(A, ("strips", int(kernel_type), config.step_groups, None),
                  device, lambda: _strips_host(A, kernel_type, config),
                  upload)


def _resolve_naive(A: CSRMatrix, config: SpMVConfig,
                   device: torch.device) -> WindowEllPlan | None:
    """SCALAR_CSR's naive plan (``tpu_spmv/spmv.py:373-393``): the
    lane-per-row layout with no row splits, no spill (margin caps opened
    wide) and no leveling, or ``None`` where it overflows; cached under
    ``("naive", step width)``."""
    def make():
        try:
            return build(A, split_rows=None, step_groups=config.step_groups,
                         spill_beta=0.0, cap_margin=1e9, permute_rows=False)
        except WindowEllOverflow:
            return None

    return cached(A, ("naive", config.step_groups), device, make, upload)


def resolve_spmm(A: CSRMatrix, config: SpMVConfig,
                 device: torch.device) -> SpmmPlan:
    """K5's plan of ``A`` on ``device``, which serves the SpMM of every
    2-D operand whatever its width or the kernel type: cached on the
    matrix under ``"spmm"`` (the host arrays, not copies) and the device.
    K5 streams f32 values alone, so ``bf16_values`` or ``pattern`` raise
    ``INVALID_ARGUMENT``."""
    if config.bf16_values or config.pattern:
        raise SpMVException("a 2-D operand takes the f32 value stream "
                            "alone (no bf16_values, no pattern)")
    return cached(A, "spmm", device, lambda: host_merge(A, pattern=False),
                  spmm_from_host)


def run_plan(plan: Plan, x: torch.Tensor) -> torch.Tensor:
    """``y = A @ x`` through the resolved plan, by its type (``Y = A @ X``
    through K5's plan, recorded as the span ``spmv.spmm``, whose count is
    the operand's width)."""
    if isinstance(plan, SpmmPlan):
        if not profiling.on:
            return spmm_merge(plan, x)
        span = profiling.begin("spmv.spmm")
        y = spmm_merge(plan, x)
        profiling.end(span, x.shape[1])
        return y
    if isinstance(plan, ReorderedPlan):
        return spmv_reordered(plan, x)
    if isinstance(plan, PatternPlan):
        if isinstance(plan.plan, MergePlan):
            return spmv_merge(plan.plan, plan.scale * x)
        if isinstance(plan.plan, BandedPlan):
            return spmv_pattern_banded(plan.plan, plan.scale, x)
        return spmv_pattern(plan.plan, plan.scale, x)
    if isinstance(plan, MergePlan):
        return spmv_merge(plan, x)
    if isinstance(plan, BandedPlan):
        return spmv_banded(plan, x)
    if isinstance(plan, CompositePlan):
        return spmv_composite(plan, x)
    if isinstance(plan, StripPlan):
        return spmv_strips(plan, x)
    if isinstance(plan, DeviceCSR):
        return spmv_csr_scalar(plan, x)
    if isinstance(plan, DeviceELL):
        return spmv_ell_device(plan, x)
    return spmv_window_ell(plan, x)


def launches_per_call(plan: Plan) -> dict:
    """The port's kernel launches one :func:`run_plan` of ``plan`` makes, as
    ``{"fold", "section_epilogue", "unpermute", "permute_chunks",
    "merge_csr", "merge_spmm"}`` (K1's fold in whichever value stream the
    plan has): per
    window-ELL plan one table set-up (K3), one fold per section, a section
    epilogue after each but the last, and K2 where the plan is leveled, its
    last section split a superblock, or a reordered plan maps its tiles;
    summed over the bands, levels or strips of a stack, with two public
    chunk permutes around a reordered banded stack; K4 and its fix-up (none
    where the plan has one CTA) for K4's plan, K5 and its fix-up (none
    where it has one share) for K5's; none on a flat path (CSR or
    ELL)."""
    counts = dict.fromkeys(("fold", "section_epilogue", "unpermute",
                            "permute_chunks", "merge_csr", "merge_spmm"), 0)
    if isinstance(plan, SpmmPlan):
        counts["merge_spmm"] = 1 + (plan.n_shares > 1)
        return counts

    def add(p, mapped=False):
        if isinstance(p, MergePlan):
            counts["merge_csr"] += 1 + (p.n_ctas > 1)
            return
        if isinstance(p, (BandedPlan, CompositePlan, StripPlan)):
            for q in p.plans:
                add(q)
            return
        counts["permute_chunks"] += 1
        counts["fold"] += len(p.sections)
        counts["section_epilogue"] += max(len(p.sections) - 1, 0)
        counts["unpermute"] += int(
            mapped or p.lam is not None
            or bool(p.sections and p.sections[-1].n_split))

    if isinstance(plan, ReorderedPlan):
        banded = isinstance(plan.inner, BandedPlan)
        add(plan.inner, mapped=not banded)
        counts["permute_chunks"] += 2 * banded
    elif isinstance(plan, PatternPlan):
        add(plan.plan)
    elif not isinstance(plan, (DeviceCSR, DeviceELL)):
        add(plan)
    return counts


def _packed_groups(plan: Plan) -> int | None:
    """The packed groups (1,024 slots each) ``plan`` streams a call, summed
    over the bands, levels or strips of a stack (K4's plan: its nonzeros
    over 1,024, rounded up, as it pads none); ``None`` on a flat path (CSR
    or ELL).  The dispatch gives it to its ``spmv.resolve`` span as
    the span's count."""
    if isinstance(plan, (DeviceCSR, DeviceELL)):
        return None
    if isinstance(plan, PatternPlan):
        plan = plan.plan
    return plan.n_groups


def graphable(plan: Plan) -> bool:
    """Whether the dispatch captures ``plan``'s call in a CUDA graph: a
    plan whose whole :func:`run_plan` is the port's kernels and torch ops that
    never wait on the host, by its type (a window-ELL plan, a banded stack,
    K4's plan, a pattern plan over any of them, a reordered plan over the
    first two).  The flat paths, column strips and composite plans run
    eagerly."""
    if isinstance(plan, PatternPlan):
        plan = plan.plan
    elif isinstance(plan, ReorderedPlan):
        plan = plan.inner
    return isinstance(plan, (WindowEllPlan, BandedPlan, MergePlan))


class CallGraph:
    """One call of ``plan`` captured in a CUDA graph on ``x``'s device.

    The capture runs :func:`run_plan` on a side stream into the graph's private
    memory pool, over a static ``x`` of ``x``'s shape, and keeps the call's
    output, the port's kernels it launched (``launches``, as
    :func:`~tpu_spmv_torch.kernels.launch_counts` gives them; the wrappers
    count them once, at the capture) and the stream it serves: the one
    current on the device at the capture.  Nothing runs on the card until
    a call.  The span recorder records nothing during the capture.  Raises
    where the capture fails, its stream's capture ended."""

    def __init__(self, plan: Plan, x: torch.Tensor):
        self.device = x.get_device()
        self.stream = _current_stream(self.device)
        self.permutes = standalone_permutes(plan) \
            if isinstance(plan, ReorderedPlan) else None
        self.lock = threading.Lock()
        graph = torch.cuda.CUDAGraph()
        before = launch_counts()
        recording, profiling.on = profiling.on, False
        try:
            with torch.cuda.stream(torch.cuda.Stream(x.device)):
                graph.capture_begin(capture_error_mode="thread_local")
                try:
                    self.x = torch.empty(x.shape, dtype=x.dtype,
                                         device=x.device)
                    self.y = run_plan(plan, self.x)
                except BaseException:
                    with contextlib.suppress(RuntimeError):
                        graph.capture_end()
                    raise
                graph.capture_end()
        finally:
            profiling.on = recording
        after = launch_counts()
        self.launches = {k: after[k] - before[k] for k in after}
        self.graph = graph

    def __call__(self, x: torch.Tensor) -> torch.Tensor | None:
        """``y`` for ``x``: ``x`` copied into the static input, the graph
        replayed, the output copied into a fresh tensor, all on the current
        stream; recorded as ``spmv.reorder`` around the replay where the
        plan is reordered (its count the standalone permutes the graph
        runs).  ``None``, with nothing done, where the current stream is
        not the capture's or another thread holds the static buffers."""
        if _current_stream(self.device) != self.stream \
                or not self.lock.acquire(blocking=False):
            return None
        try:
            self.x.copy_(x)
            if profiling.on and self.permutes is not None:
                span = profiling.begin("spmv.reorder")
                self.graph.replay()
                profiling.end(span, self.permutes)
            else:
                self.graph.replay()
            return self.y.clone()
        finally:
            self.lock.release()


def _served(plan: Plan, x: torch.Tensor, cache: dict) -> tuple:
    """``(y, replayed)`` for a :func:`graphable` plan on the card, its
    graph cached in ``cache`` (the matrix's plan cache) under ``("_graph",
    id(plan))`` beside the plan: the first call eagerly; the second
    captured and replayed; later calls replayed (``replayed`` 1, each
    captured kernel counted as launched), or eagerly where the graph cannot
    serve them.  A capture that fails on a CUDA error or a launch error
    leaves the plan eager for good, logged once as a warning; out of
    memory there ends the call."""
    key = ("_graph", id(plan))
    held = cache.get(key)
    if held is None or held[0] is not plan:
        cache[key] = (plan, None)
        return run_plan(plan, x), 0
    graph, replayed = held[1], 1
    if graph is None:
        try:
            graph = CallGraph(plan, x)
        except torch.OutOfMemoryError:
            raise
        except (RuntimeError, DeviceException) as e:
            log.warning("spmv: %s not captured in a CUDA graph (%s); its "
                        "calls run eagerly", type(plan).__name__, e,
                        exc_info=True)
            graph = False
        cache[key] = (plan, graph)
        replayed = 0    # the capture counted the launches once
    y = graph(x) if graph else None
    if y is None:
        return run_plan(plan, x), 0
    if replayed:
        add_launch_counts(graph.launches)
    return y, replayed


def _execute(plan: Plan, x: torch.Tensor,
             cache: dict | None = None) -> torch.Tensor:
    """:func:`run_plan` for the dispatch, through the plan's CUDA graph
    (:func:`_served`) where ``cache`` (the matrix's plan cache) is given,
    ``x`` is on the card, the plan is :func:`graphable` and the caller is
    not capturing a graph of its own (which then takes the eager launches).
    A route that runs out of device memory, eagerly, at the capture or at a
    replay, raises :class:`DeviceException` (``EXECUTION``), logged as a
    warning; no other route is tried.  Recorded as the span
    ``spmv.launch``, whose count is the port's kernels the call ran
    (:func:`~tpu_spmv_torch.kernels.launch_total`, a replay's counted as
    launched), and inside it, where the graph serves, the span
    ``spmv.graph``, whose count is 1 where the call replayed the graph and
    0 where it ran eagerly or captured it."""
    if profiling.on:
        span = profiling.begin("spmv.launch")
        launched = launch_total()
    try:
        if cache is not None and x.is_cuda and graphable(plan) \
                and not torch.cuda.is_current_stream_capturing():
            if profiling.on:
                graph_span = profiling.begin("spmv.graph")
            y, replayed = _served(plan, x, cache)
            if profiling.on:
                profiling.end(graph_span, replayed)
        else:
            y = run_plan(plan, x)
    except torch.OutOfMemoryError as e:
        log.warning("spmv: %s ran out of device memory (%s)",
                    type(plan).__name__, e)
        raise DeviceException(e) from e
    if profiling.on:
        profiling.end(span, launch_total() - launched)
    return y


def _replay_seconds(plans: tuple, x: torch.Tensor) -> list:
    """Seconds a call of each of ``plans`` on ``x``'s card, each served as
    the dispatch serves a warm call: run once eagerly, then captured
    (:class:`CallGraph`) and replayed, ``x`` copied in and ``y`` copied
    out; timed in turns with CUDA events, the median of ``ROUTE_SAMPLES``
    batches of ``ROUTE_ITERS`` calls after a warm one
    (:func:`~.timing.time_turns`).  It records no span, takes its launches
    back off the kernels' counters and drops its graphs: the dispatch
    captures its own."""
    from .timing import time_turns

    before = launch_counts()
    recording, profiling.on = profiling.on, False
    try:
        graphs = []
        for plan in plans:
            run_plan(plan, x)
            graphs.append(CallGraph(plan, x))
        return time_turns([lambda g=g: g(x) for g in graphs],
                          iters=ROUTE_ITERS, samples=ROUTE_SAMPLES,
                          warmup=1, device=x.device)
    finally:
        profiling.on = recording
        after = launch_counts()
        add_launch_counts({k: before[k] - after[k] for k in after})


def _timer(device: torch.device):
    """The second opinion's timer on ``device``: :func:`_replay_seconds`
    on a card; ``None`` elsewhere, where the model's route stands."""
    return _replay_seconds if device.type == "cuda" else None


def _second_opinion(A: CSRMatrix, plan: Plan, config: SpMVConfig,
                    device: torch.device) -> Plan:
    """The device plan that serves ``A`` once the card has had its say.
    Where the model (:func:`merge_route`) kept a window-ELL plan of an f32
    value stream (a single plan, a banded stack, or a reordered plan over
    either), K4's plan of ``A`` is made too, both calls are timed on the
    card (:func:`_timer`) in two trials in turn, and K4 serves only where
    its call takes under ``ROUTE_MARGIN`` of window-ELL's in both (the
    second is skipped where the first keeps window-ELL); the loser and its
    graph are dropped.  ``plan`` serves untimed off a card, for a bf16
    value stream, where the caller forced the reordered plan
    (``reorder=True``), for K4's own plan and for a plan that is not
    :func:`graphable`; and, logged as a warning, where K4's plan or the
    trial finds no room on the card.  Any other failure of the trial (a
    build, launch or capture of K4 or of ``plan``) raises.  Recorded as
    the span ``spmv.route``, its count 1 where K4 won and 0 where
    window-ELL kept the matrix; counted in ``_route_trials`` and
    ``_route_wins``."""
    global _route_trials, _route_wins
    timer = _timer(device)
    if timer is None or config.bf16_values or config.reorder is True \
            or isinstance(plan, MergePlan) or not graphable(plan):
        return plan
    if profiling.on:
        span = profiling.begin("spmv.route")
    try:
        k4 = merge_from_host(host_merge(A, pattern=False), device)
        x = torch.ones(A.num_cols, device=device)
        won = all(k4_s < ROUTE_MARGIN * ell_s
                  for ell_s, k4_s in (timer((plan, k4), x) for _ in range(2)))
    except (torch.OutOfMemoryError, DeviceAllocError) as e:
        log.warning("spmv: no room on the card for the route trial (%s); "
                    "%s serves", e, type(plan).__name__)
        won = False
    _route_trials += 1
    _route_wins += won
    if profiling.on:
        profiling.end(span, int(won))
    return k4 if won else plan


def resolve_csr(A: CSRMatrix, kernel_type: KernelType, config: SpMVConfig,
                device: torch.device) -> Plan:
    """The plan that serves ``A`` on ``device`` (``tpu_spmv/spmv.py:137-206``,
    ``:353-396``), cached on the matrix: the one resolution
    :func:`spmv_csr`, PageRank and the benchmark harness share.  The packed
    plan is cached under the JAX package's key (kernel type, step width,
    bf16 flag, reorder flag).  Where its composite plan finds no level that
    packs (:class:`WindowEllOverflow`), SCALAR_CSR's plan serves, as in the
    JAX dispatch; the rejection is cached under that key as ``None``, so
    the composite is tried once a matrix, not once a call.  That plan
    reads only ``use_vmem_x`` and the step width of ``config``, so
    PageRank's ``SpMVConfig(pattern=True)`` gets the plan that the JAX
    PageRank's retry under ``SpMVConfig()`` gets.  On a card the packed
    plan is the one :func:`_second_opinion` keeps, cached under the device
    key, so its trial runs once per matrix and device."""
    if kernel_type in (KernelType.VECTOR_CSR, KernelType.MERGE_PATH) \
            and config.use_vmem_x:
        if A.num_cols <= PACKED_MAX_COLS:
            if config.pattern:
                resolved = _resolve_pattern(A, kernel_type, config, device)
                if resolved is not None:
                    return resolved
            resolved = cached(A, ("host", int(kernel_type),
                                  config.step_groups,
                                  bool(config.bf16_values), config.reorder),
                              device, lambda: _host_plan(
                                  A, _split(kernel_type), config),
                              lambda host, dev: _second_opinion(
                                  A, upload(host, dev), config, dev))
            if resolved is not None:
                return resolved
            # too adversarial for the packed layout: SCALAR_CSR
            kernel_type = KernelType.SCALAR_CSR
        else:
            resolved = _resolve_strips(A, kernel_type, config, device)
            if resolved is not None:
                return resolved
    if kernel_type == KernelType.SCALAR_CSR and config.use_vmem_x \
            and A.num_cols <= VMEM_X_MAX_COLS:
        resolved = _resolve_naive(A, config, device)
        if resolved is not None:
            return resolved
    # ELL_KERNEL on a CSR, use_vmem_x=False, or a structure every packed
    # layout rejected
    return A.to_device(device)


@profiling.call_span("spmv.call")
def spmv_csr(A: CSRMatrix | None, x, config: SpMVConfig | None = None,
             vec_size: int | None = None, measure: bool = False,
             measure_iters: int = 100, measure_samples: int = 5,
             device=None) -> SpMVResult:
    """``y = A @ x`` (reference ``spmv_csr``, ``spmv_kernels.cu:215-326``).

    ``x`` is a tensor or array of ``num_cols`` values, or of ``(num_cols,
    k)`` (``k`` ≥ 1 operands side by side, row-major): then ``y`` is
    ``(num_rows, k)``, the product of each column, served by K5, the
    merge-path CSR SpMM (:func:`resolve_spmm`), under whatever kernel type
    ``config`` names; its value stream is f32 alone, so ``bf16_values`` or
    ``pattern`` with a 2-D operand returns ``INVALID_ARGUMENT``.
    ``vec_size``, where given, is checked against ``x``'s first dimension;
    any other shape returns ``INVALID_DIMENSION``.  ``device`` is where
    the plan lives and the kernels run: the card (``"cuda"``) unless the
    caller names another, whatever device ``x`` is on.  With no CUDA device
    and none named, the call returns ``DEVICE_ALLOC`` (the code the
    reference's first device allocation gives without a card); it never
    runs on the CPU unasked.  On a named CPU device the kernels' plain
    versions serve.  Errors come back in ``error_code``.  ``measure=True``
    times the whole call on the card
    (:func:`~tpu_spmv_torch.timing.time_cuda`, which raises for any
    other device: ``MEASURE_WARMUP`` warm-up calls, then the median of
    ``measure_samples`` runs of ``measure_iters`` calls of the plan that
    served the call) and fills the time, GFLOP/s (2·nnz·k) and byte-model
    GB/s (for a 2-D operand the SpMM model, which reads the operand and
    writes ``y`` once, k wide)."""
    config = config or SpMVConfig()
    return _call(A, x, vec_size, device,
                 lambda dev: resolve_csr(A, KernelType(config.kernel_type),
                                         config, dev),
                 lambda ms, peak, k: compute_bandwidth_csr(
                     A.num_rows, A.num_cols, A.nnz, ms, peak, k),
                 measure, measure_iters, measure_samples,
                 lambda dev: resolve_spmm(A, config, dev))


def _begin(A, x, vec_size: int | None, device,
           two_d: bool = False) -> tuple:
    """The checks both entry points make before any device work
    (``spmv_kernels.cu:219-232``): ``(result, x as a tensor, device)``,
    the result carrying an error code, or the empty output of a matrix
    with no rows, where the call ends there.  ``x`` is 1-D, or 2-D of at
    least one column where the entry takes a 2-D operand (``two_d``).
    ``device`` is the card unless the caller names another; with no CUDA
    device and none named the code is ``DEVICE_ALLOC``."""
    result = SpMVResult()
    if A is None or x is None:
        result.error_code = int(SpMVError.INVALID_ARGUMENT)
        return result, x, device
    device = torch.device("cuda" if device is None else device)
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.ascontiguousarray(x, np.float32))
    shaped = x.ndim == 1 or (x.ndim == 2 and two_d and x.shape[1] >= 1)
    n = int(x.shape[0]) if shaped else -1
    if vec_size is None or vec_size < 0:
        vec_size = n
    if not shaped or not spmv_validate_dimensions(A.num_cols, vec_size) \
            or vec_size != n:
        result.error_code = int(SpMVError.INVALID_DIMENSION)
    elif device.type == "cuda" and not torch.cuda.is_available():
        result.error_code = int(SpMVError.DEVICE_ALLOC)
    elif A.num_rows == 0:
        result.y = torch.zeros((0,) + tuple(x.shape[1:]),
                               dtype=torch.float32, device=device)
    return result, x, device


def _call(A, x, vec_size: int | None, device, resolve, model, measure: bool,
          iters: int, samples: int, wide=None) -> SpMVResult:
    """The body of both entry points: :func:`_begin`'s checks; ``x`` on the
    device (a 2-D operand made contiguous); the plan ``resolve(device)``
    gives (``wide(device)`` for a 2-D operand; ``wide`` ``None`` where the
    entry takes none), recorded as the span
    ``spmv.resolve`` (its count :func:`_packed_groups`), and inside it the
    span ``spmv.plan`` (its count the host plans the call built or
    rejected, ``cached``'s misses: 1 on a miss, 0 on a hit), and timed into
    ``plan_seconds``; :func:`_execute` through the matrix's cache; an
    :class:`SpMVException`'s code into ``error_code``; and with
    ``measure``, :func:`_measure` under the byte model ``model``."""
    result, x, device = _begin(A, x, vec_size, device, wide is not None)
    if result.error_code or result.y is not None:
        return result
    if x.ndim == 2:
        resolve = wide
    try:
        x = guarded_upload(x, device).float()
        if x.ndim == 2:
            x = x.contiguous()
        if profiling.on:
            span = profiling.begin("spmv.resolve")
            plan_span = profiling.begin("spmv.plan")
            built = _host_builds
        t0 = time.perf_counter()
        plan = resolve(device)
        result.plan_seconds = time.perf_counter() - t0
        if profiling.on:
            profiling.end(plan_span, _host_builds - built)
            profiling.end(span, _packed_groups(plan))
        result.y = _execute(plan, x, A._plan_cache)
    except SpMVException as e:
        result.error_code = int(e.code)
        return result
    result.plan = plan
    if measure:
        _measure(result, x, device, iters, samples, A.nnz, model)
    return result


def _measure(result: SpMVResult, x: torch.Tensor, device: torch.device,
             iters: int, samples: int, nnz: int, model) -> None:
    """Fill ``result``'s time, GFLOP/s (2·``nnz`` a call, times k for a
    2-D operand of k columns) and byte-model GB/s (``model(ms, peak,
    k)``, k 1 for a 1-D operand) from CUDA-event timing of the plan
    that served it (:func:`~tpu_spmv_torch.timing.time_cuda`, which raises
    for any other device: ``MEASURE_WARMUP`` warm-up calls, then the median
    of ``samples`` runs of ``iters`` calls)."""
    from .bandwidth import get_gpu_peak_bandwidth
    from .timing import time_cuda

    plan = result.plan
    k = x.shape[1] if x.ndim == 2 else 1
    secs = time_cuda(lambda: run_plan(plan, x), iters=iters, samples=samples,
                     warmup=MEASURE_WARMUP, device=device)
    result.elapsed_ms = secs * 1e3
    result.gflops = 2.0 * nnz * k / secs / 1e9 if secs > 0 else 0.0
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    result.bandwidth = model(result.elapsed_ms,
                             get_gpu_peak_bandwidth(index), k)
    result.bandwidth_gb_s = result.bandwidth.achieved_gb_s


# ---- ELL ----

def ell_csr(A: ELLMatrix) -> CSRMatrix:
    """``A``'s CSR form, which the packed routes plan and the benchmark
    harness checks against (cached under ``"_csr"``, the JAX key)."""
    return _memo(A, "_csr", A.to_csr)


def resolve_ell(A: ELLMatrix, config: SpMVConfig | None,
                device: torch.device) -> Plan:
    """The plan that serves ``A`` (``tpu_spmv/spmv.py:557-591``), shared by
    :func:`spmv_ell` and the benchmark harness so that both run the same
    plan.  Cached on ``A`` under the JAX keys and the device: the host
    plan of the single-plan route under ``"plan"`` (``None`` for a
    rejected build), its device plan under ``("plan", device)``; the
    strips under ``("strips", step width)`` and the device (the host
    strips, or ``None``, under that key alone).  The pattern route's plan
    is cached on the CSR form (``"_csr"``), as the CSR dispatch caches
    it.  The route takes no bf16 value stream and ignores
    ``kernel_type``, as the JAX route does."""
    cfg = config or SpMVConfig()
    if A.num_cols <= VMEM_X_MAX_COLS:
        if cfg.pattern:
            resolved = _resolve_pattern(ell_csr(A), KernelType.VECTOR_CSR,
                                        cfg, device)
            if resolved is not None:
                return resolved

        def make():
            try:
                return build(ell_csr(A))
            except WindowEllOverflow:
                return None

        plan = cached(A, "plan", device, make, upload)
        if plan is not None:
            return plan
    elif A.num_cols <= PACKED_MAX_COLS:
        plan = cached(A, ("strips", cfg.step_groups), device,
                      lambda: _strips_host(ell_csr(A),
                                           KernelType.VECTOR_CSR, cfg),
                      upload)
        if plan is not None:
            return plan
    return A.to_device(device)


@profiling.call_span("spmv.call")
def spmv_ell(A: ELLMatrix | None, x, config: SpMVConfig | None = None,
             vec_size: int | None = None, measure: bool = False,
             measure_iters: int = 100, measure_samples: int = 5,
             device=None) -> SpMVResult:
    """``y = A @ x`` for ELL (reference ``spmv_ell``,
    ``spmv_kernels.cu:328-420``), with :func:`spmv_csr`'s validation,
    error codes, devices and ``measure``: on the card unless the caller
    names another device, ``DEVICE_ALLOC`` with no CUDA device and none
    named.  ``measure=True`` fills the time, the GFLOP/s of the stored
    nonzeros (the reference's host recount, ``spmv_kernels.cu:399-405``)
    and the ELL byte model's GB/s.  A route that runs out of device memory
    ends the call with ``EXECUTION``, as in :func:`spmv_csr`.  ``x`` is
    1-D: a 2-D operand returns ``INVALID_DIMENSION``."""
    return _call(A, x, vec_size, device,
                 lambda dev: resolve_ell(A, config, dev),
                 lambda ms, peak, k: compute_bandwidth_ell(
                     A.num_rows, A.num_cols, A.max_nnz_per_row, ms, peak),
                 measure, measure_iters, measure_samples)
