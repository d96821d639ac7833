"""SpMV dispatch, configuration and result types (port of
``tpu_spmv/spmv.py``).

``spmv_csr`` validates its arguments before any device work, resolves the
packed window-ELL plan for VECTOR_CSR and MERGE_PATH (block-reordered where
the reorder probe applies, ``SpMVConfig.reorder``; a pattern plan of the
0/1 structure where ``SpMVConfig.pattern`` is set and the values are
column-scaled; a bf16 value stream where ``SpMVConfig.bf16_values`` is
set), runs it on the card unless the caller names another device, and
reports errors through ``SpMVResult.error_code`` with the JAX package's
codes (the reference's no-throw contract).

Only the packed single-plan route, its reordered form and its pattern and
bf16 forms are ported.  Every other route the JAX dispatch can take raises
``NotImplementedError`` naming its ROADMAP item, so no call is quietly
served by another route than the JAX package's: SCALAR_CSR's naive plan,
banded, strip and composite plans (M7); the flat and ELL fallbacks (M10).
"""

from __future__ import annotations

import dataclasses
import enum
import os
import time

import numpy as np
import torch

from .bandwidth import BandwidthMetrics, compute_bandwidth_csr
from .csr import CSRMatrix
from .errors import SpMVError, SpMVException, guarded_upload
from .kernels.plan import HostPlan, WindowEllOverflow, _choose_sup, build_auto
from .kernels.reorder import (ReorderedPlan, build_reordered_host,
                              maybe_reorder, reordered_from_host,
                              spmv_reordered)
from .kernels.window_ell import (WindowEllPlan, plan_from_host, spmv_pattern,
                                 spmv_window_ell)

# the JAX package's column caps (TPU VMEM limits), kept so both packages
# route the same matrices the same way; ROADMAP M13 revisits them
VMEM_X_MAX_COLS = 1 << 20
PACKED_MAX_COLS = 1 << 21

# merge-path row-splitting granularity: rows longer than this are
# stride-split into extra rows
MERGE_SPLIT_ROWS = 128

# measure=True: warm-up calls before the timed samples
MEASURE_WARMUP = 10


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
    """The pattern fast path's plan: a pattern plan of the 0/1 structure B
    of ``A = B·diag(scale)`` and the column scale, both on one device (the
    JAX dispatch's ``(spmv_pattern, (plan, scale))``)."""

    plan: WindowEllPlan
    scale: torch.Tensor       # f32 (num_cols,)

    @property
    def stream_bytes(self) -> float:
        """The pattern plan's bytes, as the JAX bench counts them (the
        scale multiply, 12 B per column, left out)."""
        return self.plan.stream_bytes


@dataclasses.dataclass
class SpMVResult:
    """Reference ``SpMVResult`` (``spmv.h:27-36``)."""

    y: torch.Tensor | None = None
    elapsed_ms: float = 0.0
    gflops: float = 0.0
    bandwidth_gb_s: float = 0.0
    error_code: int = 0
    bandwidth: BandwidthMetrics | None = None
    plan: WindowEllPlan | ReorderedPlan | PatternPlan | None = None  # the
    #                                                   plan that served it
    plan_seconds: float = 0.0   # plan resolution in this call (build +
    #                             upload; a cache hit takes microseconds)

    def y_host(self) -> np.ndarray | None:
        return self.y.cpu().numpy() if self.y is not None else None


def spmv_validate_dimensions(num_cols: int, vec_size: int) -> bool:
    """Reference inline validator (``spmv.h:52-54``)."""
    return num_cols == vec_size


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet (ROADMAP {item})")


def _host_plan(A: CSRMatrix, split: int | None,
               config: SpMVConfig) -> tuple[HostPlan, np.ndarray | None]:
    """The host plan for ``A`` in the order of ``tpu_spmv/spmv.py:159-198``:
    the reorder probe (once per ``split``), the reordered build where the
    probe applies and the permuted matrix packs, else the natural plan.
    Returns ``(plan, block order)``: the order is ``None`` for a natural
    plan, and the plan then is ``A``'s own."""
    skey = ("_sup", split)
    if skey not in A._plan_cache:   # O(nnz) sampled model — cache
        A._plan_cache[skey] = _choose_sup(A, with_groups=True,
                                          split_rows=split)
    vdt = "bfloat16" if config.bf16_values else "float32"
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
                pass   # the permuted matrix packs in no layout: natural plan
    try:
        return build_auto(A, step_groups=config.step_groups,
                          split_rows=split, choice=A._plan_cache[skey],
                          values_dtype=vdt), None
    except WindowEllOverflow as e:
        raise _not_ported("composite plans (single plan overflows)",
                          "M7") from e


def _plan_for(A: CSRMatrix, kernel_type: KernelType, config: SpMVConfig,
              device: torch.device) -> WindowEllPlan | ReorderedPlan:
    """The packed single plan for ``A`` on ``device`` (the single-plan part
    of ``tpu_spmv/spmv.py:_plan_for``), with an f32 or bf16 value stream,
    cached on the matrix under the JAX package's key (kernel type, step
    width, bf16 flag, reorder flag)."""
    if A.num_cols > VMEM_X_MAX_COLS:
        raise _not_ported("composite plans (x wider than one block)", "M7")
    split = MERGE_SPLIT_ROWS if kernel_type == KernelType.MERGE_PATH \
        else None
    hkey = ("host", int(kernel_type), config.step_groups,
            bool(config.bf16_values), config.reorder)
    dkey = (hkey, str(device))
    if dkey in A._plan_cache:
        return A._plan_cache[dkey]
    if hkey not in A._plan_cache:
        A._plan_cache[hkey] = _host_plan(A, split, config)
    host, order = A._plan_cache[hkey]
    plan = plan_from_host(host, device) if order is None \
        else reordered_from_host(host, order, A.num_rows, A.num_cols, device)
    A._plan_cache[dkey] = plan
    return plan


def _resolve_pattern(A: CSRMatrix, kernel_type: KernelType,
                     config: SpMVConfig,
                     device: torch.device) -> PatternPlan | None:
    """The pattern fast path (``tpu_spmv/spmv.py:423-455``): a pattern plan
    of the 0/1 structure plus the factored-out column scale.  Returns
    ``None`` (the f32 packed path serves) when the values are not
    column-scaled, the pattern plan overflows, or ``TPU_SPMV_NO_PATTERN`` is
    set.  The scale is cached under ``"_cscale"``, the host plan (or
    ``None`` for a rejection) under ``("pat", kernel type, step width)``,
    the device plan under that key and the device."""
    from .pagerank import column_scale_factor

    if os.environ.get("TPU_SPMV_NO_PATTERN"):
        return None
    if "_cscale" not in A._plan_cache:
        A._plan_cache["_cscale"] = column_scale_factor(A)
    scale = A._plan_cache["_cscale"]
    if scale is None or A.num_cols > VMEM_X_MAX_COLS:
        return None
    key = ("pat", int(kernel_type), config.step_groups)
    if key not in A._plan_cache:
        split = MERGE_SPLIT_ROWS if kernel_type == KernelType.MERGE_PATH \
            else None
        try:
            A._plan_cache[key] = build_auto(
                A, step_groups=config.step_groups, split_rows=split,
                pattern=True)
        except WindowEllOverflow:
            A._plan_cache[key] = None   # remember the rejection
    if A._plan_cache[key] is None:
        return None
    dkey = (key, str(device))
    if dkey not in A._plan_cache:
        A._plan_cache[dkey] = PatternPlan(
            plan_from_host(A._plan_cache[key], device),
            guarded_upload(scale, device))
    return A._plan_cache[dkey]


def _run(plan: WindowEllPlan | ReorderedPlan | PatternPlan,
         x: torch.Tensor) -> torch.Tensor:
    """``y = A @ x`` through the resolved plan."""
    if isinstance(plan, ReorderedPlan):
        return spmv_reordered(plan, x)
    if isinstance(plan, PatternPlan):
        return spmv_pattern(plan.plan, plan.scale, x)
    return spmv_window_ell(plan, x)


def _resolve_csr_kernel(A: CSRMatrix, kernel_type: KernelType,
                        config: SpMVConfig, device: torch.device
                        ) -> WindowEllPlan | ReorderedPlan | PatternPlan:
    """The plan that serves ``A`` (``tpu_spmv/spmv.py:353-396``)."""
    if kernel_type in (KernelType.VECTOR_CSR, KernelType.MERGE_PATH) \
            and config.use_vmem_x:
        if A.num_cols > PACKED_MAX_COLS:
            raise _not_ported("column-strip plans", "M7")
        if config.pattern:
            resolved = _resolve_pattern(A, kernel_type, config, device)
            if resolved is not None:
                return resolved
        return _plan_for(A, kernel_type, config, device)
    if kernel_type == KernelType.SCALAR_CSR and config.use_vmem_x \
            and A.num_cols <= VMEM_X_MAX_COLS:
        raise _not_ported("the naive SCALAR_CSR plan", "M7")
    raise _not_ported("the flat gather/segment-sum path", "M10")


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
    result = SpMVResult()
    if A is None or x is None:
        result.error_code = int(SpMVError.INVALID_ARGUMENT)
        return result
    device = torch.device("cuda" if device is None else device)
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.ascontiguousarray(x, np.float32))
    n = int(x.shape[0]) if x.ndim == 1 else -1
    if vec_size is None or vec_size < 0:
        vec_size = n
    if x.ndim != 1 or not spmv_validate_dimensions(A.num_cols, vec_size) \
            or vec_size != n:
        result.error_code = int(SpMVError.INVALID_DIMENSION)
        return result
    if config is None:
        config = SpMVConfig()
    kernel_type = KernelType(config.kernel_type)
    if device.type == "cuda" and not torch.cuda.is_available():
        result.error_code = int(SpMVError.DEVICE_ALLOC)
        return result
    if A.num_rows == 0:
        result.y = torch.zeros(0, dtype=torch.float32, device=device)
        return result

    try:
        x = guarded_upload(x, device).float()
        t0 = time.perf_counter()
        plan = _resolve_csr_kernel(A, kernel_type, config, device)
        result.plan_seconds = time.perf_counter() - t0
        result.y = _run(plan, x)
    except SpMVException as e:
        result.error_code = int(e.code)
        return result
    result.plan = plan

    if measure:
        from .bandwidth import get_gpu_peak_bandwidth
        from .timing import time_cuda

        secs = time_cuda(lambda: _run(plan, x),
                         iters=measure_iters, samples=measure_samples,
                         warmup=MEASURE_WARMUP, device=device)
        result.elapsed_ms = secs * 1e3
        result.gflops = 2.0 * A.nnz / secs / 1e9 if secs > 0 else 0.0
        index = device.index if device.index is not None \
            else torch.cuda.current_device()
        result.bandwidth = compute_bandwidth_csr(
            A.num_rows, A.num_cols, A.nnz, result.elapsed_ms,
            get_gpu_peak_bandwidth(index))
        result.bandwidth_gb_s = result.bandwidth.achieved_gb_s
    return result
