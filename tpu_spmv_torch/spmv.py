"""SpMV dispatch, configuration and result types (port of
``tpu_spmv/spmv.py``).

``spmv_csr`` (and ``spmv_ell``, below) validates its arguments before any
device work, resolves the plan the JAX dispatch would
(``tpu_spmv/spmv.py:137-206``, ``:285-455``), runs it on the card unless the
caller names another device, and reports errors through
``SpMVResult.error_code`` with the JAX package's codes (the reference's
no-throw contract). The routes, in the JAX order:

* VECTOR_CSR and MERGE_PATH: the pattern plan of the 0/1 structure where
  ``SpMVConfig.pattern`` is set and the values are column-scaled (a single
  plan or a row-banded stack); else, up to ``VMEM_X_MAX_COLS`` columns,
  the block-reordered plan where the reorder probe applies, else
  ``build_auto``'s single plan or row-banded stack (with an f32 or bf16
  value stream); past that width, or where ``build_auto`` overflows, the
  composite plan (f32 levels and a flat tail); past ``PACKED_MAX_COLS``,
  column strips;
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
plan, a banded stack, a pattern plan over either, a reordered plan over
either).  A matrix's first call on such a plan runs eagerly, the second
captures it, and every later call copies ``x`` in, replays the graph and
copies ``y`` out into a tensor of its own: the same kernels in the same
order, so the output is the eager call's bit for bit.  The graph is cached
on the matrix beside its plan (``free_device()`` drops both).  A call on
another stream than the capture's, or while another thread holds the
graph's buffers, runs eagerly; a plan whose capture fails runs eagerly
from then on, logged once.  ``measure=True``'s timed calls and PageRank's
SpMVs run the plan eagerly.

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
from .errors import (DeviceException, SpMVError, SpMVException,
                     guarded_upload)
from .kernels import add_launch_counts, launch_counts, launch_total, upload
from .kernels.plan import (WindowEllOverflow, _choose_sup, build,
                           build_auto, build_composite)
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

log = logging.getLogger("tpu_spmv_torch")


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
    them) of the 0/1 structure B of ``A = B·diag(scale)`` and the column
    scale, both on one device (the JAX dispatch's ``(spmv_pattern, (plan,
    scale))`` or ``(spmv_pattern_banded, ...)``)."""

    plan: WindowEllPlan | BandedPlan
    scale: torch.Tensor       # f32 (num_cols,)

    @property
    def stream_bytes(self) -> float:
        """The pattern plan's bytes, as the JAX bench counts them (the
        scale multiply, 12 B per column, left out)."""
        return self.plan.stream_bytes


# what serves an SpMV: a packed plan or stack of them, or the matrix itself
# on a flat path
Plan = (WindowEllPlan | BandedPlan | CompositePlan | StripPlan | ReorderedPlan
        | PatternPlan | DeviceCSR | DeviceELL)


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
    (``make()`` on a miss; ``None`` remembers a rejection and gives
    ``None``).  Every plan the dispatch serves is cached so, and PageRank's
    dangling mask; ``free_device()`` drops them all."""
    dkey = (key, str(device))
    if dkey not in A._plan_cache:
        host = _memo(A, key, make)
        A._plan_cache[dkey] = None if host is None else put(host, device)
    return A._plan_cache[dkey]


def _host_plan(A: CSRMatrix, split: int | None, config: SpMVConfig):
    """The host plan for ``A`` in the order of ``tpu_spmv/spmv.py:156-205``:
    up to ``VMEM_X_MAX_COLS`` columns the reorder probe (O(nnz), once a
    matrix; the port's probe, unlike the JAX one, does not ask the
    superblock choice), the reordered build where the probe applies and the
    permuted matrix packs, else ``build_auto``'s plan or banded stack at the
    superblock choice (a sampled O(nnz) model, once per ``split``); past
    that width, or where that overflows, the composite plan (its levels
    f32, as in the JAX package).  A reordered build comes as a
    :class:`HostReordered`.  Raises :class:`WindowEllOverflow` where no
    composite level packs the matrix."""
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
        choice = _memo(A, ("_sup", split),
                       lambda: _choose_sup(A, with_groups=True,
                                           split_rows=split))
        try:
            return build_auto(A, step_groups=config.step_groups,
                              split_rows=split, choice=choice,
                              values_dtype=vdt)
        except WindowEllOverflow:
            pass
    return build_composite(A, step_groups=config.step_groups,
                           split_rows=split)


def _resolve_pattern(A: CSRMatrix, kernel_type: KernelType,
                     config: SpMVConfig,
                     device: torch.device) -> PatternPlan | None:
    """The pattern fast path (``tpu_spmv/spmv.py:423-455``): a pattern plan
    (or banded stack) of the 0/1 structure plus the factored-out column
    scale.  Returns ``None`` (the f32 packed path serves) when the values
    are not column-scaled, the pattern plan overflows, or
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
        try:
            return build_auto(A, step_groups=config.step_groups,
                              split_rows=_split(kernel_type), pattern=True)
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


def run_plan(plan: Plan, x: torch.Tensor) -> torch.Tensor:
    """``y = A @ x`` through the resolved plan, by its type."""
    if isinstance(plan, ReorderedPlan):
        return spmv_reordered(plan, x)
    if isinstance(plan, PatternPlan):
        if isinstance(plan.plan, BandedPlan):
            return spmv_pattern_banded(plan.plan, plan.scale, x)
        return spmv_pattern(plan.plan, plan.scale, x)
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
    ``{"fold", "section_epilogue", "unpermute", "permute_chunks"}`` (K1's
    fold in whichever value stream the plan has): per window-ELL plan one
    table set-up (K3), one fold per section, a section epilogue after each
    but the last, and K2 where the plan is leveled, its last section split
    a superblock, or a reordered plan maps its tiles; summed over the
    bands, levels or strips of a stack, with two public chunk permutes
    around a reordered banded stack; none on a flat path (CSR or ELL)."""
    counts = dict.fromkeys(("fold", "section_epilogue", "unpermute",
                            "permute_chunks"), 0)

    def add(p, mapped=False):
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
    over the bands, levels or strips of a stack; ``None`` on a flat path
    (CSR or ELL).  The dispatch gives it to its ``spmv.resolve`` span as
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
    a pattern plan over either, a reordered plan over either).  The flat
    paths, column strips and composite plans run eagerly."""
    if isinstance(plan, PatternPlan):
        plan = plan.plan
    elif isinstance(plan, ReorderedPlan):
        plan = plan.inner
    return isinstance(plan, (WindowEllPlan, BandedPlan))


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


def resolve_csr(A: CSRMatrix, kernel_type: KernelType, config: SpMVConfig,
                device: torch.device) -> Plan:
    """The plan that serves ``A`` on ``device`` (``tpu_spmv/spmv.py:137-206``,
    ``:353-396``), cached on the matrix: the one resolution
    :func:`spmv_csr`, PageRank and the benchmark harness share.  The packed
    plan is cached under the JAX package's key (kernel type, step width,
    bf16 flag, reorder flag).  Where its composite plan finds no level that
    packs (:class:`WindowEllOverflow`), SCALAR_CSR's plan serves, as in the
    JAX dispatch; that plan reads only ``use_vmem_x`` and the step width of
    ``config``, so PageRank's ``SpMVConfig(pattern=True)`` gets the plan
    that the JAX PageRank's retry under ``SpMVConfig()`` gets."""
    if kernel_type in (KernelType.VECTOR_CSR, KernelType.MERGE_PATH) \
            and config.use_vmem_x:
        if A.num_cols <= PACKED_MAX_COLS:
            if config.pattern:
                resolved = _resolve_pattern(A, kernel_type, config, device)
                if resolved is not None:
                    return resolved
            try:
                return cached(A, ("host", int(kernel_type),
                                  config.step_groups,
                                  bool(config.bf16_values), config.reorder),
                              device, lambda: _host_plan(
                                  A, _split(kernel_type), config), upload)
            except WindowEllOverflow:
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

    ``x`` is a tensor or array of ``num_cols`` values.  ``device`` is where
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
    served the call) and fills the time, GFLOP/s and byte-model GB/s."""
    config = config or SpMVConfig()
    return _call(A, x, vec_size, device,
                 lambda dev: resolve_csr(A, KernelType(config.kernel_type),
                                         config, dev),
                 lambda ms, peak: compute_bandwidth_csr(
                     A.num_rows, A.num_cols, A.nnz, ms, peak),
                 measure, measure_iters, measure_samples)


def _begin(A, x, vec_size: int | None, device) -> tuple:
    """The checks both entry points make before any device work
    (``spmv_kernels.cu:219-232``): ``(result, x as a 1-D tensor, device)``,
    the result carrying an error code, or the empty output of a matrix
    with no rows, where the call ends there.  ``device`` is the card
    unless the caller names another; with no CUDA device and none named
    the code is ``DEVICE_ALLOC``."""
    result = SpMVResult()
    if A is None or x is None:
        result.error_code = int(SpMVError.INVALID_ARGUMENT)
        return result, x, device
    device = torch.device("cuda" if device is None else device)
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.ascontiguousarray(x, np.float32))
    n = int(x.shape[0]) if x.ndim == 1 else -1
    if vec_size is None or vec_size < 0:
        vec_size = n
    if x.ndim != 1 or not spmv_validate_dimensions(A.num_cols, vec_size) \
            or vec_size != n:
        result.error_code = int(SpMVError.INVALID_DIMENSION)
    elif device.type == "cuda" and not torch.cuda.is_available():
        result.error_code = int(SpMVError.DEVICE_ALLOC)
    elif A.num_rows == 0:
        result.y = torch.zeros(0, dtype=torch.float32, device=device)
    return result, x, device


def _call(A, x, vec_size: int | None, device, resolve, model, measure: bool,
          iters: int, samples: int) -> SpMVResult:
    """The body of both entry points: :func:`_begin`'s checks; ``x`` on the
    device; the plan ``resolve(device)`` gives, recorded as the span
    ``spmv.resolve`` (its count :func:`_packed_groups`) and timed into
    ``plan_seconds``; :func:`_execute` through the matrix's cache; an
    :class:`SpMVException`'s code into ``error_code``; and with
    ``measure``, :func:`_measure` under the byte model ``model``."""
    result, x, device = _begin(A, x, vec_size, device)
    if result.error_code or result.y is not None:
        return result
    try:
        x = guarded_upload(x, device).float()
        if profiling.on:
            span = profiling.begin("spmv.resolve")
        t0 = time.perf_counter()
        plan = resolve(device)
        result.plan_seconds = time.perf_counter() - t0
        if profiling.on:
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
    """Fill ``result``'s time, GFLOP/s (2·``nnz`` a call) and byte-model
    GB/s (``model(ms, peak)``) from CUDA-event timing of the plan that
    served it (:func:`~tpu_spmv_torch.timing.time_cuda`, which raises for
    any other device: ``MEASURE_WARMUP`` warm-up calls, then the median of
    ``samples`` runs of ``iters`` calls)."""
    from .bandwidth import get_gpu_peak_bandwidth
    from .timing import time_cuda

    plan = result.plan
    secs = time_cuda(lambda: run_plan(plan, x), iters=iters, samples=samples,
                     warmup=MEASURE_WARMUP, device=device)
    result.elapsed_ms = secs * 1e3
    result.gflops = 2.0 * nnz / secs / 1e9 if secs > 0 else 0.0
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    result.bandwidth = model(result.elapsed_ms,
                             get_gpu_peak_bandwidth(index))
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
    ends the call with ``EXECUTION``, as in :func:`spmv_csr`."""
    return _call(A, x, vec_size, device,
                 lambda dev: resolve_ell(A, config, dev),
                 lambda ms, peak: compute_bandwidth_ell(
                     A.num_rows, A.num_cols, A.max_nnz_per_row, ms, peak),
                 measure, measure_iters, measure_samples)
