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

import dataclasses
import enum
import logging
import os
import time

import numpy as np
import torch

from .bandwidth import (BandwidthMetrics, compute_bandwidth_csr,
                        compute_bandwidth_ell)
from .csr import CSRMatrix, DeviceCSR
from .ell import DeviceELL, ELLMatrix
from .errors import (DeviceException, SpMVError, SpMVException,
                     guarded_upload)
from .kernels.plan import (WindowEllOverflow, _choose_sup, build,
                           build_auto, build_composite)
from .kernels.ell_kernel import spmv_ell_device
from .kernels.reorder import (ReorderedPlan, build_reordered_host,
                              maybe_reorder, reordered_from_host,
                              spmv_reordered)
from .kernels.scalar import spmv_csr_scalar
from .kernels.strips import (STRIP_MAX_COLS, HostStrips, StripPlan,
                             build_strips_host, spmv_strips,
                             strips_from_host)
from .kernels.window_ell import (BandedPlan, CompositePlan, WindowEllPlan,
                                 spmv_banded, spmv_composite, spmv_pattern,
                                 spmv_pattern_banded, spmv_window_ell,
                                 upload)

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


def _upload(host, device: torch.device):
    """The device plan of a host plan of any type."""
    return strips_from_host(host, device) if isinstance(host, HostStrips) \
        else upload(host, device)


def _cached(A: CSRMatrix, key: tuple, device: torch.device, make):
    """The device plan cached on ``A`` under ``(key, device)``, made from
    the host plan cached under ``key`` (``make()`` on a miss; ``None``
    remembers a rejection and gives ``None``)."""
    dkey = (key, str(device))
    if dkey not in A._plan_cache:
        if key not in A._plan_cache:
            A._plan_cache[key] = make()
        host = A._plan_cache[key]
        A._plan_cache[dkey] = None if host is None else _upload(host, device)
    return A._plan_cache[dkey]


def _host_plan(A: CSRMatrix, split: int | None, config: SpMVConfig):
    """The host plan for ``A`` in the order of ``tpu_spmv/spmv.py:156-205``:
    up to ``VMEM_X_MAX_COLS`` columns the reorder probe (once per
    ``split``), the reordered build where the probe applies and the
    permuted matrix packs, else ``build_auto``'s plan or banded stack; past
    that width, or where that overflows, the composite plan (its levels f32,
    as in the JAX package).  Returns ``(plan, block order)``: the order is
    ``None`` for a plan of ``A``'s own rows."""
    vdt = "bfloat16" if config.bf16_values else "float32"
    if A.num_cols <= VMEM_X_MAX_COLS:
        skey = ("_sup", split)
        if skey not in A._plan_cache:   # O(nnz) sampled model — cache
            A._plan_cache[skey] = _choose_sup(A, with_groups=True,
                                              split_rows=split)
        if config.reorder is not False:
            # the verdict depends on the split-dependent superblock choice
            rkey = ("_reorder", bool(config.reorder), split)
            if rkey not in A._plan_cache:   # O(nnz) probe — cache
                A._plan_cache[rkey] = maybe_reorder(
                    A, choice=A._plan_cache[skey],
                    force=config.reorder is True, split_rows=split)
            order = A._plan_cache[rkey]
            if order is not None:
                try:
                    return build_reordered_host(A, order, split,
                                                config.step_groups,
                                                values_dtype=vdt)
                except WindowEllOverflow:
                    pass   # the permuted matrix packs in no layout
        try:
            return build_auto(A, step_groups=config.step_groups,
                              split_rows=split, choice=A._plan_cache[skey],
                              values_dtype=vdt), None
        except WindowEllOverflow:
            pass
    return build_composite(A, step_groups=config.step_groups,
                           split_rows=split), None


def _plan_for(A: CSRMatrix, kernel_type: KernelType, config: SpMVConfig,
              device: torch.device):
    """The packed plan for ``A`` on ``device`` (``tpu_spmv/spmv.py:137-206``),
    cached on the matrix under the JAX package's key (kernel type, step
    width, bf16 flag, reorder flag).  Raises :class:`WindowEllOverflow`
    where no composite level packs the matrix."""
    hkey = ("host", int(kernel_type), config.step_groups,
            bool(config.bf16_values), config.reorder)
    dkey = (hkey, str(device))
    if dkey in A._plan_cache:
        return A._plan_cache[dkey]
    if hkey not in A._plan_cache:
        A._plan_cache[hkey] = _host_plan(A, _split(kernel_type), config)
    host, order = A._plan_cache[hkey]
    plan = _upload(host, device) if order is None \
        else reordered_from_host(host, order, A.num_rows, A.num_cols, device)
    A._plan_cache[dkey] = plan
    return plan


def _resolve_pattern(A: CSRMatrix, kernel_type: KernelType,
                     config: SpMVConfig,
                     device: torch.device) -> PatternPlan | None:
    """The pattern fast path (``tpu_spmv/spmv.py:423-455``): a pattern plan
    (or banded stack) of the 0/1 structure plus the factored-out column
    scale.  Returns ``None`` (the f32 packed path serves) when the values
    are not column-scaled, the pattern plan overflows, or
    ``TPU_SPMV_NO_PATTERN`` is set.  The scale is cached under
    ``"_cscale"``, the host plan (or ``None`` for a rejection) under
    ``("pat", kernel type, step width)``, the device plan under that key and
    the device, and the :class:`PatternPlan` under ``"_pattern"``, that key
    and the device."""
    from .pagerank import column_scale_factor

    if os.environ.get("TPU_SPMV_NO_PATTERN"):
        return None
    if "_cscale" not in A._plan_cache:
        A._plan_cache["_cscale"] = column_scale_factor(A)
    scale = A._plan_cache["_cscale"]
    if scale is None or A.num_cols > VMEM_X_MAX_COLS:
        return None

    def make():
        try:
            return build_auto(A, step_groups=config.step_groups,
                              split_rows=_split(kernel_type), pattern=True)
        except WindowEllOverflow:
            return None

    key = ("pat", int(kernel_type), config.step_groups)
    pkey = ("_pattern", key, str(device))
    if pkey not in A._plan_cache:
        plan = _cached(A, key, device, make)
        A._plan_cache[pkey] = None if plan is None \
            else PatternPlan(plan, guarded_upload(scale, device))
    return A._plan_cache[pkey]


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
    return _cached(A, ("strips", int(kernel_type), config.step_groups, None),
                   device, lambda: _strips_host(A, kernel_type, config))


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

    return _cached(A, ("naive", config.step_groups), device, make)


def _run(plan: Plan, x: torch.Tensor) -> torch.Tensor:
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
    """The port's kernel launches one :func:`_run` of ``plan`` makes, as
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


def _execute(plan: Plan, x: torch.Tensor) -> torch.Tensor:
    """:func:`_run` for the dispatch: a route that runs out of device
    memory raises :class:`DeviceException` (``EXECUTION``), logged as a
    warning; no other route is tried."""
    try:
        return _run(plan, x)
    except torch.OutOfMemoryError as e:
        log.warning("spmv: %s ran out of device memory (%s)",
                    type(plan).__name__, e)
        raise DeviceException(e) from e


def _resolve_csr_kernel(A: CSRMatrix, kernel_type: KernelType,
                        config: SpMVConfig, device: torch.device) -> Plan:
    """The plan that serves ``A`` (``tpu_spmv/spmv.py:353-396``).  Raises
    :class:`WindowEllOverflow` where the packed route's composite plan
    finds no level that packs."""
    if kernel_type in (KernelType.VECTOR_CSR, KernelType.MERGE_PATH) \
            and config.use_vmem_x:
        if A.num_cols <= PACKED_MAX_COLS:
            if config.pattern:
                resolved = _resolve_pattern(A, kernel_type, config, device)
                if resolved is not None:
                    return resolved
            return _plan_for(A, kernel_type, config, device)
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
    result, x, device = _begin(A, x, vec_size, device)
    if result.error_code or result.y is not None:
        return result
    if config is None:
        config = SpMVConfig()
    kernel_type = KernelType(config.kernel_type)
    try:
        x = guarded_upload(x, device).float()
        t0 = time.perf_counter()
        try:
            plan = _resolve_csr_kernel(A, kernel_type, config, device)
        except WindowEllOverflow:
            # structure too adversarial for the packed layout: SCALAR_CSR
            plan = _resolve_csr_kernel(A, KernelType.SCALAR_CSR, config,
                                       device)
        result.plan_seconds = time.perf_counter() - t0
        result.y = _execute(plan, x)
    except SpMVException as e:
        result.error_code = int(e.code)
        return result
    result.plan = plan
    if measure:
        _measure(result, x, device, measure_iters, measure_samples, A.nnz,
                 lambda ms, peak: compute_bandwidth_csr(
                     A.num_rows, A.num_cols, A.nnz, ms, peak))
    return result


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
    secs = time_cuda(lambda: _run(plan, x), iters=iters, samples=samples,
                     warmup=MEASURE_WARMUP, device=device)
    result.elapsed_ms = secs * 1e3
    result.gflops = 2.0 * nnz / secs / 1e9 if secs > 0 else 0.0
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    result.bandwidth = model(result.elapsed_ms,
                             get_gpu_peak_bandwidth(index))
    result.bandwidth_gb_s = result.bandwidth.achieved_gb_s


# ---- ELL ----

def _ell_csr(A: ELLMatrix) -> CSRMatrix:
    """``A``'s CSR form, which the packed routes plan (cached under
    ``"_csr"``, the JAX key)."""
    if "_csr" not in A._plan_cache:
        A._plan_cache["_csr"] = A.to_csr()
    return A._plan_cache["_csr"]


def _resolve_ell_kernel(A: ELLMatrix, config: SpMVConfig | None,
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
            resolved = _resolve_pattern(_ell_csr(A), KernelType.VECTOR_CSR,
                                        cfg, device)
            if resolved is not None:
                return resolved

        def make():
            try:
                return build(_ell_csr(A))
            except WindowEllOverflow:
                return None

        plan = _cached(A, "plan", device, make)
        if plan is not None:
            return plan
    elif A.num_cols <= PACKED_MAX_COLS:
        plan = _cached(A, ("strips", cfg.step_groups), device,
                       lambda: _strips_host(_ell_csr(A),
                                            KernelType.VECTOR_CSR, cfg))
        if plan is not None:
            return plan
    return A.to_device(device)


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
    result, x, device = _begin(A, x, vec_size, device)
    if result.error_code or result.y is not None:
        return result
    try:
        x = guarded_upload(x, device).float()
        t0 = time.perf_counter()
        plan = _resolve_ell_kernel(A, config, device)
        result.plan_seconds = time.perf_counter() - t0
        result.y = _execute(plan, x)
    except SpMVException as e:
        result.error_code = int(e.code)
        return result
    result.plan = plan
    if measure:
        _measure(result, x, device, measure_iters, measure_samples, A.nnz,
                 lambda ms, peak: compute_bandwidth_ell(
                     A.num_rows, A.num_cols, A.max_nnz_per_row, ms, peak))
    return result
