"""Column strips for matrices wider than one gather table (port of
``tpu_spmv/kernels/strips.py``).

A :class:`StripPlan` serves ``y = sum_k A[:, lo_k:hi_k] @ x[lo_k:hi_k]``:
each strip is a column range of at most :data:`STRIP_MAX_COLS`, packed by
the full :func:`~.plan.build_auto` machinery (a single plan or a row-banded
stack), and the strips' outputs are added in strip order.  Strips without a
nonzero are skipped.  It is a load-shaping transform of the same kernels,
not a kernel of its own.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..csr import CSRMatrix
from .plan import HostBanded, build_auto
from .window_ell import (BandedPlan, PlanFile, banded_from_host,
                         plan_from_host, spmv_banded, spmv_window_ell)

# widest strip: one gather table of the JAX package's VMEM-resident x
# (spmv.VMEM_X_MAX_COLS; a test holds the two equal)
STRIP_MAX_COLS = 1 << 20


@dataclasses.dataclass(frozen=True)
class HostStrips:
    """The host form of a :class:`StripPlan`: per strip a host plan or a
    host banded stack, and its column range."""

    plans: tuple              # HostPlan | HostBanded per strip
    num_rows: int
    num_cols: int
    bounds: tuple = ()        # (lo, hi) per strip


@dataclasses.dataclass(frozen=True)
class StripPlan(PlanFile):
    """A stack of packed plans over disjoint column ranges on one device
    (the JAX ``StripPlan``, ``tpu_spmv/kernels/strips.py:53-93``)."""

    plans: tuple              # WindowEllPlan | BandedPlan per strip
    num_rows: int
    num_cols: int
    bounds: tuple = ()        # (lo, hi) per strip

    @property
    def n_groups(self) -> int:
        return sum(p.n_groups for p in self.plans)

    @property
    def occupancy(self) -> float:
        tot = sum(p.n_groups for p in self.plans)
        return sum(p.occupancy * p.n_groups for p in self.plans) / tot \
            if tot else 0.0

    @property
    def stream_bytes(self) -> float:
        """The strips' bytes, and each add after the first strip (y read
        twice, written once)."""
        return sum(p.stream_bytes for p in self.plans) \
            + 12.0 * self.num_rows * max(len(self.plans) - 1, 0)


def _slice_cols(csr: CSRMatrix, lo: int, hi: int) -> CSRMatrix:
    """The column range ``[lo, hi)`` as an independent CSR (same rows,
    columns re-based to the strip)."""
    mask = (csr.col_indices >= lo) & (csr.col_indices < hi)
    rows_of = np.repeat(np.arange(csr.num_rows, dtype=np.int64),
                        np.diff(csr.row_ptrs).astype(np.int64))
    rr = rows_of[mask]
    ptr = np.zeros(csr.num_rows + 1, np.int32)
    np.cumsum(np.bincount(rr, minlength=csr.num_rows), out=ptr[1:])
    return CSRMatrix(csr.num_rows, hi - lo, csr.values[mask],
                     (csr.col_indices[mask] - lo).astype(np.int32), ptr)


def build_strips_host(csr: CSRMatrix, strip_cols: int = STRIP_MAX_COLS,
                      step_groups: int | None = None,
                      split_rows: int | None = None,
                      permute_rows: bool | None = None) -> HostStrips:
    """The host half of :func:`build_strips` (the JAX ``build_strips``,
    ``strips.py:109-137``).  Raises
    :class:`~.plan.WindowEllOverflow` when a non-empty strip rejects every
    packed layout."""
    if strip_cols <= 0:
        raise ValueError(f"strip_cols must be positive, got {strip_cols}")
    n_strips = max(1, -(-csr.num_cols // strip_cols))
    plans, bounds = [], []
    for k in range(n_strips):
        lo = k * strip_cols
        hi = min(csr.num_cols, lo + strip_cols)
        sub = _slice_cols(csr, lo, hi)
        if sub.nnz == 0:
            continue
        plans.append(build_auto(sub, split_rows=split_rows,
                                step_groups=step_groups,
                                permute_rows=permute_rows))
        bounds.append((lo, hi))
    return HostStrips(tuple(plans), csr.num_rows, csr.num_cols,
                      tuple(bounds))


def strips_from_host(hs: HostStrips, device="cuda") -> StripPlan:
    """The device plan of a :class:`HostStrips` (on the card unless the
    caller names another device)."""
    return StripPlan(tuple((banded_from_host if isinstance(p, HostBanded)
                            else plan_from_host)(p, device)
                           for p in hs.plans),
                     hs.num_rows, hs.num_cols, tuple(hs.bounds))


def build_strips(csr: CSRMatrix, strip_cols: int = STRIP_MAX_COLS,
                 step_groups: int | None = None,
                 split_rows: int | None = None, device="cuda",
                 permute_rows: bool | None = None) -> StripPlan:
    """A :class:`StripPlan` of ``csr`` on ``device`` (the card unless the
    caller names another): :func:`build_strips_host`, then the upload."""
    return strips_from_host(build_strips_host(
        csr, strip_cols, step_groups, split_rows, permute_rows), device)


def spmv_strips(sp: StripPlan, x: torch.Tensor) -> torch.Tensor:
    """``y = A @ x`` over a strip plan (``spmv_strips``,
    ``strips.py:140-152``): each strip's SpMV on its slice of x, added in
    strip order.  Returns ``(num_rows,)`` f32."""
    y = None
    for p, (lo, hi) in zip(sp.plans, sp.bounds):
        fn = spmv_banded if isinstance(p, BandedPlan) else spmv_window_ell
        yk = fn(p, x[lo:hi])
        y = yk if y is None else y + yk
    if y is None:
        return torch.zeros(sp.num_rows, dtype=torch.float32, device=x.device)
    return y

