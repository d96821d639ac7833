"""SpMV dispatch, configuration and result types (port of
``tpu_spmv/spmv.py``).

``spmv_csr`` validates its arguments before any device work, resolves the
packed window-ELL plan for VECTOR_CSR and MERGE_PATH, runs it, and reports
errors through ``SpMVResult.error_code`` with the JAX package's codes (the
reference's no-throw contract).

Only the packed single-plan route is ported.  Every other route the JAX
dispatch can take raises ``NotImplementedError`` naming its ROADMAP item,
so no call is quietly served by another route than the JAX package's:
SCALAR_CSR's naive plan, pattern and bf16 plans, banded, strip and composite
plans (M7); block reordering (M8); the flat and ELL fallbacks (M10).
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
from .kernels.plan import (SUP_LEVELS, WindowEllOverflow, _choose_sup,
                           build_auto)
from .kernels.window_ell import WindowEllPlan, plan_from_host, spmv_window_ell

# the JAX package's column caps (TPU VMEM limits), kept so both packages
# route the same matrices the same way; ROADMAP M13 revisits them
VMEM_X_MAX_COLS = 1 << 20
PACKED_MAX_COLS = 1 << 21

# merge-path row-splitting granularity: rows longer than this are
# stride-split into extra rows
MERGE_SPLIT_ROWS = 128

# measure=True: warm-up calls before the timed samples
MEASURE_WARMUP = 10

# the structural gates of the JAX reorder probe (kernels/reorder.py)
_REORDER_MAX_COLS = 1 << 21
_REORDER_MIN_NNZ = 1 << 16


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


@dataclasses.dataclass
class SpMVResult:
    """Reference ``SpMVResult`` (``spmv.h:27-36``)."""

    y: torch.Tensor | None = None
    elapsed_ms: float = 0.0
    gflops: float = 0.0
    bandwidth_gb_s: float = 0.0
    error_code: int = 0
    bandwidth: BandwidthMetrics | None = None
    plan: WindowEllPlan | None = None   # the plan that served the call
    plan_seconds: float = 0.0   # plan resolution in this call (build +
    #                             upload; a cache hit takes microseconds)

    def y_host(self) -> np.ndarray | None:
        return self.y.cpu().numpy() if self.y is not None else None


def spmv_validate_dimensions(num_cols: int, vec_size: int) -> bool:
    """Reference inline validator (``spmv.h:52-54``)."""
    return num_cols == vec_size


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet (ROADMAP {item})")


def _reorder_may_apply(A: CSRMatrix, choice: tuple, force: bool) -> bool:
    """True where the JAX dispatch may serve ``A`` through a block-reordered
    plan: its reorder probe's structural gates pass, and the forced flag is
    set or the superblock choice is wide (the probe's gain test, which the
    port does not run, decides the rest)."""
    if os.environ.get("TPU_SPMV_REORDER", "1") in ("0", ""):
        return False
    if A.num_rows != A.num_cols or A.num_cols > _REORDER_MAX_COLS:
        return False
    if A.nnz < _REORDER_MIN_NNZ or A.num_rows < 4 * SUP_LEVELS[0]:
        return False
    return force or choice[0] > SUP_LEVELS[0]


def _plan_for(A: CSRMatrix, kernel_type: KernelType, config: SpMVConfig,
              device: torch.device) -> WindowEllPlan:
    """The packed single plan for ``A`` on ``device`` (the single-plan part
    of ``tpu_spmv/spmv.py:_plan_for``), cached on the matrix."""
    if config.bf16_values:
        raise _not_ported("bf16 value streams", "M7")
    if A.num_cols > VMEM_X_MAX_COLS:
        raise _not_ported("composite plans (x wider than one block)", "M7")
    split = MERGE_SPLIT_ROWS if kernel_type == KernelType.MERGE_PATH \
        else None
    hkey = ("host", int(kernel_type), config.step_groups)
    dkey = (hkey, str(device))
    if dkey in A._plan_cache:
        return A._plan_cache[dkey]
    if hkey not in A._plan_cache:
        skey = ("_sup", split)
        if skey not in A._plan_cache:   # O(nnz) sampled model — cache
            A._plan_cache[skey] = _choose_sup(A, with_groups=True,
                                              split_rows=split)
        if config.reorder is not False and _reorder_may_apply(
                A, A._plan_cache[skey], config.reorder is True):
            raise _not_ported("block reordering", "M8")
        try:
            A._plan_cache[hkey] = build_auto(
                A, step_groups=config.step_groups, split_rows=split,
                choice=A._plan_cache[skey])
        except WindowEllOverflow as e:
            raise _not_ported("composite plans (single plan overflows)",
                              "M7") from e
    A._plan_cache[dkey] = plan_from_host(A._plan_cache[hkey], device)
    return A._plan_cache[dkey]


def _resolve_csr_kernel(A: CSRMatrix, kernel_type: KernelType,
                        config: SpMVConfig,
                        device: torch.device) -> WindowEllPlan:
    """The plan that serves ``A`` (``tpu_spmv/spmv.py:353-396``)."""
    if kernel_type in (KernelType.VECTOR_CSR, KernelType.MERGE_PATH) \
            and config.use_vmem_x:
        if A.num_cols > PACKED_MAX_COLS:
            raise _not_ported("column-strip plans", "M7")
        if config.pattern:
            raise _not_ported("the pattern fast path", "M7")
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

    ``x`` is a tensor or array of ``num_cols`` values.  ``device`` (default:
    ``x``'s device, the CPU for arrays) is where the plan lives and the
    kernels run; on the CPU the kernels' plain versions serve.  Errors come
    back in ``error_code``.  ``measure=True`` times the whole call on the
    card (:func:`~tpu_spmv_torch.timing.time_cuda`: ``MEASURE_WARMUP`` warm-up
    calls, then the median of ``measure_samples`` runs of ``measure_iters``
    calls) and fills the time, GFLOP/s and byte-model GB/s."""
    result = SpMVResult()
    if A is None or x is None:
        result.error_code = int(SpMVError.INVALID_ARGUMENT)
        return result
    if device is None:
        device = x.device if isinstance(x, torch.Tensor) else "cpu"
    device = torch.device(device)
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
    if A.num_rows == 0:
        result.y = torch.zeros(0, dtype=torch.float32, device=device)
        return result

    try:
        x = guarded_upload(x, device).float()
        t0 = time.perf_counter()
        plan = _resolve_csr_kernel(A, kernel_type, config, device)
        result.plan_seconds = time.perf_counter() - t0
        result.y = spmv_window_ell(plan, x)
    except SpMVException as e:
        result.error_code = int(e.code)
        return result
    result.plan = plan

    if measure:
        from .bandwidth import get_gpu_peak_bandwidth
        from .timing import time_cuda

        if device.type != "cuda":
            raise RuntimeError(f"measure=True times the card; x is on "
                               f"{device}")
        secs = time_cuda(lambda: spmv_window_ell(plan, x),
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
