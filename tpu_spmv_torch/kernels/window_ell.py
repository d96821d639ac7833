"""The window-ELL plan on a device, and the two kernels that run it.

Port of the device half of ``tpu_spmv/kernels/window_ell.py``:

* :class:`WindowEllPlan` holds a plan's arrays as tensors on one device, plus
  the port-only fold schedule (:class:`FoldSection`, derived on the host when
  the plan is made; not a plan-format field);
* :func:`plan_from_arrays` makes one from NumPy leaves, either those of a
  JAX ``WindowEllPlan`` (``np.asarray`` of each leaf) or those of a port
  :class:`~tpu_spmv_torch.kernels.plan.HostPlan`;
* :func:`window_ell_fold` (K1, ``csrc/window_ell.cu``) and :func:`unpermute`
  (K2, ``csrc/unpermute.cu``) are the kernel wrappers.  Beside each is its
  plain PyTorch version.  A wrapper takes the plain version only for a
  tensor on the CPU; for a CUDA tensor it launches its kernel or raises.
  Each wrapper counts its launches in an integer attribute, ``launches``;
* :func:`spmv_window_ell` runs a plan: pad x and append the extras region,
  fold, unpermute through ``lam``, trim to ``num_rows``.
"""

from __future__ import annotations

import dataclasses
import ctypes

import numpy as np
import torch

from ..errors import DeviceException, InvalidFormatError, guarded_upload
from .plan import AUX, CHUNKS, LANE, LEAVES, WINDOW, HostPlan

_TB_LEGAL = (2, 4, 8)
_NTB_LEGAL = (8, 32, 128)


@dataclasses.dataclass(frozen=True)
class FoldSection:
    """The fold schedule of one plan section (the blocks between two
    ``fin_step`` marks): its runs grouped by output superblock.  Output
    superblock ``c`` of the section owns the runs
    ``run_order[cta_ptr[c]:cta_ptr[c+1]]``, in plan order."""

    run_order: torch.Tensor   # i32 (n_runs,) run indices, stable by base
    cta_ptr: torch.Tensor     # i32 (n_cta + 1,)
    n_cta: int


@dataclasses.dataclass(frozen=True)
class WindowEllPlan:
    """A window-ELL plan as tensors on one device (the fields of the JAX
    ``WindowEllPlan``, ``tpu_spmv/kernels/window_ell.py:311-352``)."""

    vals: torch.Tensor | None  # f32 (G*8, 128); None for pattern plans
    lo: torch.Tensor           # i8  (G*8, 128)
    sb: torch.Tensor           # i8  (G*8, 128), or (G*4, 128) when sbn
    wg: torch.Tensor           # i32 (G,)
    base: torch.Tensor         # i32 (G/tb,)
    blk_step: torch.Tensor     # i32 (n_steps,)
    fin_step: torch.Tensor     # i32 (n_steps,)
    extra_to_row: torch.Tensor  # i32 (n_extra,)
    lam: torch.Tensor | None   # i32 (n_tiles_pad, 128) for leveled plans
    num_rows: int
    num_cols: int
    extras_base: int
    n_extra: int
    e8: int
    out8: int
    cols_pad: int
    step_groups: int
    split_rows: int | None
    sup: int
    sbn: bool
    pat: bool
    tb: int
    sections: tuple            # FoldSection per section, in run order
    occupancy: float = 0.0

    @property
    def device(self) -> torch.device:
        return self.lo.device

    @property
    def n_groups(self) -> int:
        return int(self.wg.shape[0])

    @property
    def stream_bytes(self) -> float:
        """Bytes one SpMV streams from device memory (packed slot arrays,
        gather and output tables, and the unpermute pass): the physics-guard
        denominator (``window_ell.py:378-390``)."""
        per_slot = (0.0 if self.pat else float(self.vals.element_size())) \
            + 1.0 + (0.5 if self.sbn else 1.0)
        b = self.n_groups * CHUNKS * LANE * per_slot \
            + (self.cols_pad + (self.e8 + self.out8) * LANE) * 4
        if self.lam is not None:
            b += int(self.lam.numel()) * 12  # read y+lam, write y
        return b


def _unpack_sb(sb: np.ndarray | torch.Tensor, sbn: bool):
    """Per-group sub-blocks, shape (G, 8, 128), from the (maybe
    nibble-packed) ``sb`` stream."""
    if not sbn:
        return sb.reshape(-1, CHUNKS, LANE)
    pk = sb.reshape(-1, 1, CHUNKS, LANE)
    lo_nib, hi_nib = pk & 15, (pk >> 4) & 15
    cat = np.concatenate if isinstance(sb, np.ndarray) else torch.cat
    return cat([lo_nib, hi_nib], 1).reshape(-1, CHUNKS, LANE)


def _fold_sections(aux: dict, vals: np.ndarray | None, base: np.ndarray,
                   blk_step: np.ndarray, fin_step: np.ndarray) -> list:
    """Split the plan's steps into sections at the ``fin_step`` marks and
    group each section's runs by output superblock (stable, so a
    superblock's runs keep plan order).  Runs whose values are all zero
    (the padding that rounds sections up to whole blocks, all of it on one
    superblock per section) are left out: they add nothing for finite x.
    Returns ``[(run_order, cta_ptr)]`` as int32 arrays, skipping empty
    sections."""
    S, tb = aux["step_groups"], aux["tb"]
    runs_per_block = S // tb
    live = None if vals is None \
        else np.any(vals.reshape(-1, tb * CHUNKS * LANE) != 0, axis=1)
    cuts = [0] + [i for i in np.flatnonzero(fin_step == 1) if i > 0] \
        + [len(blk_step)]
    out = []
    seen = set()
    for a, b in zip(cuts[:-1], cuts[1:]):
        blocks = blk_step[a:b].astype(np.int64)
        blocks = blocks[blocks >= 0]
        if not len(blocks):
            continue
        runs = (blocks[:, None] * runs_per_block
                + np.arange(runs_per_block)).reshape(-1)
        if live is not None:
            runs = runs[live[runs]]
        if not len(runs):
            continue
        rb = base[runs]
        order = np.argsort(rb, kind="stable")
        ubase, counts = np.unique(rb, return_counts=True)
        if seen.intersection(ubase.tolist()):
            raise InvalidFormatError(
                "window-ELL plan: two sections write one output superblock")
        seen.update(ubase.tolist())
        cta_ptr = np.zeros(len(ubase) + 1, np.int64)
        np.cumsum(counts, out=cta_ptr[1:])
        out.append((runs[order].astype(np.int32), cta_ptr.astype(np.int32)))
    return out


def _validate(leaves: dict, aux: dict) -> None:
    """Host-side bounds checks: the kernels index with these arrays
    without checking them."""
    n_tb = aux["sup"] // LANE
    S, tb = aux["step_groups"], aux["tb"]
    if tb not in _TB_LEGAL or S % tb:
        raise InvalidFormatError(f"window-ELL plan: tb={tb}, S={S}")
    G = len(leaves["wg"])
    if G % S or len(leaves["base"]) != G // tb \
            or leaves["lo"].shape != (G * CHUNKS, LANE) \
            or leaves["sb"].shape != (G * CHUNKS // (2 if aux["sbn"]
                                                     else 1), LANE):
        raise InvalidFormatError("window-ELL plan: inconsistent shapes")
    if leaves["vals"] is not None \
            and leaves["vals"].shape != (G * CHUNKS, LANE):
        raise InvalidFormatError("window-ELL plan: inconsistent vals shape")
    n_table = aux["cols_pad"] + aux["e8"] * LANE
    wg, base, lo = leaves["wg"], leaves["base"], leaves["lo"]
    if G and (wg.min() < 0 or (int(wg.max()) + 1) * WINDOW > n_table
              or lo.min() < 0 or base.min() < 0
              or int(base.max()) + n_tb > aux["out8"]
              or np.any(base % n_tb)):
        raise InvalidFormatError("window-ELL plan: index out of range")
    if G and not aux["pat"]:
        sbu = _unpack_sb(leaves["sb"], aux["sbn"])
        if sbu.min() < 0 or sbu.max() >= n_tb:
            raise InvalidFormatError("window-ELL plan: sub-block range")
    lam = leaves["lam"]
    if lam is not None and (lam.ndim != 2 or lam.shape[1] != LANE
                            or lam.min() < 0 or lam.max() >= LANE):
        raise InvalidFormatError("window-ELL plan: lam out of range")


def plan_from_arrays(leaves: dict, aux: dict, device="cpu",
                     occupancy: float = 0.0) -> WindowEllPlan:
    """Make a device plan from NumPy leaves and static fields.

    ``leaves`` maps the names in :data:`~.plan.LEAVES` to NumPy arrays
    (``vals`` and ``lam`` may be ``None``), ``aux`` the names in
    :data:`~.plan.AUX` to values: the JAX ``WindowEllPlan``'s own fields, or
    a ``HostPlan``'s.  Checks bounds, derives the fold schedule on the host,
    and uploads every array to ``device`` (:func:`guarded_upload`)."""
    leaves = {k: None if leaves[k] is None else np.ascontiguousarray(leaves[k])
              for k in LEAVES}
    aux = {k: aux[k] for k in AUX}
    _validate(leaves, aux)
    sections = _fold_sections(aux, leaves["vals"],
                              leaves["base"].astype(np.int64),
                              leaves["blk_step"], leaves["fin_step"])
    put = lambda a: None if a is None else guarded_upload(a, device)  # noqa: E731
    return WindowEllPlan(
        **{k: put(v) for k, v in leaves.items()}, **aux,
        sections=tuple(FoldSection(put(ro), put(cp), len(cp) - 1)
                       for ro, cp in sections),
        occupancy=float(occupancy))


def plan_from_host(hp: HostPlan, device="cpu") -> WindowEllPlan:
    """The device plan of a port-built :class:`HostPlan`."""
    return plan_from_arrays(hp.leaves(), hp.aux(), device, hp.occupancy)


# ---- K1: the window-ELL fold ----

def _check_fold(plan: WindowEllPlan, table: torch.Tensor) -> None:
    if plan.pat or plan.vals is None:
        raise NotImplementedError(
            "pattern plans (no value stream) are not ported yet "
            "(ROADMAP M7)")
    if plan.vals.dtype != torch.float32:
        raise NotImplementedError(
            f"{plan.vals.dtype} value streams are not ported yet "
            "(ROADMAP M7)")
    n_table = plan.cols_pad + plan.e8 * LANE
    if table.dtype != torch.float32 or table.shape != (n_table,):
        raise ValueError(f"table must be float32 of shape ({n_table},); "
                         f"got {table.dtype} {tuple(table.shape)}")
    if table.device != plan.device:
        raise ValueError(f"table on {table.device}, plan on {plan.device}")


def window_ell_fold_plain(plan: WindowEllPlan,
                          table: torch.Tensor) -> torch.Tensor:
    """K1's plain version: per section a vectorized gather-multiply and an
    ``index_add_`` into the output, with the extras totals published into
    the table's tail before each later section.  ``table`` (x zero-padded to
    ``cols_pad``, then ``e8*128`` slots) is not modified.  Returns the flat
    ``(out8*128,)`` output."""
    _check_fold(plan, table)
    dev = table.device
    table = table.clone()
    out = torch.zeros(plan.out8 * LANE, dtype=torch.float32, device=dev)
    vals = plan.vals.reshape(-1, CHUNKS, LANE)
    lo = plan.lo.reshape(-1, CHUNKS, LANE)
    sbu = _unpack_sb(plan.sb, plan.sbn)
    sub = torch.arange(CHUNKS, device=dev).view(1, CHUNKS, 1) * LANE
    lane = torch.arange(LANE, device=dev).view(1, 1, LANE)
    for k, sec in enumerate(plan.sections):
        if k:
            table[plan.cols_pad:] = out[plan.extras_base:]
        runs = sec.run_order.long()
        g = (runs[:, None] * plan.tb
             + torch.arange(plan.tb, device=dev)).reshape(-1)
        idx = plan.wg[g].long().view(-1, 1, 1) * WINDOW + sub + lo[g].long()
        prod = vals[g] * table[idx]
        row_base = plan.base[runs].long().repeat_interleave(plan.tb)
        rows = (row_base.view(-1, 1, 1) + sbu[g].long()) * LANE + lane
        out.index_add_(0, rows.reshape(-1), prod.reshape(-1))
    return out


def window_ell_fold(plan: WindowEllPlan, table: torch.Tensor) -> torch.Tensor:
    """K1: the packed fold over every plan section, with the publish copy
    between sections.  Launches ``csrc/window_ell.cu`` once per section on
    the current stream for a CUDA ``table``; takes the plain version for a
    CPU one.  ``table`` is not modified.  Returns ``(out8*128,)`` f32."""
    if table.device.type == "cpu":
        return window_ell_fold_plain(plan, table)
    _check_fold(plan, table)
    if table.device.type != "cuda":
        raise ValueError(f"no window-ELL kernel for {table.device}")
    n_tb = plan.sup // LANE
    if n_tb not in _NTB_LEGAL or plan.tb not in _TB_LEGAL \
            or (plan.sbn and n_tb != 8):
        raise NotImplementedError(
            f"window-ELL kernel: n_tb={n_tb}, tb={plan.tb}, sbn={plan.sbn}")
    from ._build import kernels

    lib = kernels()
    if len(plan.sections) > 1:
        table = table.clone()     # the publish copies write into it
    out = torch.zeros(plan.out8 * LANE, dtype=torch.float32,
                      device=table.device)
    stream = ctypes.c_void_p(torch.cuda.current_stream(table.device)
                             .cuda_stream)
    arrays = [plan.vals, plan.lo, plan.sb, plan.wg, plan.base]
    if not all(a.is_contiguous() for a in arrays):
        raise ValueError("window-ELL plan arrays must be contiguous")
    ptrs = [a.data_ptr() for a in arrays]
    for k, sec in enumerate(plan.sections):
        if k:
            table[plan.cols_pad:] = out[plan.extras_base:]
        err = lib.tsp_window_ell_fold(
            table.data_ptr(), *ptrs, sec.run_order.data_ptr(),
            sec.cta_ptr.data_ptr(), sec.n_cta, plan.tb, n_tb,
            int(plan.sbn), out.data_ptr(), stream)
        if err:
            raise DeviceException(f"window-ELL fold launch: cudaError {err}")
        window_ell_fold.launches += 1
    return out


window_ell_fold.launches = 0


# ---- K2: the row unpermute ----

def _pad_tiles(y: torch.Tensor, n_tiles_pad: int) -> torch.Tensor:
    """The first ``n_tiles_pad`` 128-row tiles of the flat output ``y``,
    zero-padded (``_unpermute_tiles``, ``window_ell.py:1495-1499``)."""
    y2 = y.reshape(-1, LANE)
    n_tiles = min(n_tiles_pad, y2.shape[0])
    padded = torch.zeros(n_tiles_pad, LANE, dtype=torch.float32,
                         device=y.device)
    padded[:n_tiles] = y2[:n_tiles]
    return padded


def unpermute_plain(y: torch.Tensor, lam: torch.Tensor,
                    num_rows: int) -> torch.Tensor:
    """K2's plain version: ``out[t, j] = y[t, lam[t, j]]`` over the padded
    tiles, flattened and trimmed to ``num_rows``."""
    yp = _pad_tiles(y, lam.shape[0])
    return torch.take_along_dim(yp, lam.long(), dim=1).reshape(-1)[:num_rows]


def unpermute(y: torch.Tensor, lam: torch.Tensor,
              num_rows: int) -> torch.Tensor:
    """K2: restore row order from a leveled output (flat, a whole number of
    128-row tiles).  Launches ``csrc/unpermute.cu`` for CUDA tensors, which
    reads past-the-end tiles as zeros instead of padding them; the plain
    version for CPU ones.  ``lam`` (int32, values in [0, 128), checked when
    the plan is made) gives each row's source lane."""
    if y.dtype != torch.float32 or lam.dtype != torch.int32 \
            or lam.ndim != 2 or lam.shape[1] != LANE:
        raise ValueError("unpermute takes float32 y and int32 (T, 128) lam")
    if y.numel() % LANE or not 0 <= num_rows <= lam.numel():
        raise ValueError(f"unpermute: {y.numel()} values, lam {lam.shape}, "
                         f"num_rows {num_rows}")
    if y.device != lam.device:
        raise ValueError(f"y on {y.device}, lam on {lam.device}")
    if y.device.type == "cpu":
        return unpermute_plain(y, lam, num_rows)
    if y.device.type != "cuda":
        raise ValueError(f"no unpermute kernel for {y.device}")
    from ._build import kernels

    y, lam = y.contiguous(), lam.contiguous()
    res = torch.empty(num_rows, dtype=torch.float32, device=y.device)
    err = kernels().tsp_unpermute(
        y.data_ptr(), y.numel(), lam.data_ptr(), res.data_ptr(), num_rows,
        ctypes.c_void_p(torch.cuda.current_stream(y.device).cuda_stream))
    if err:
        raise DeviceException(f"unpermute launch: cudaError {err}")
    unpermute.launches += 1
    return res


unpermute.launches = 0


# ---- the SpMV ----

def gather_table(plan: WindowEllPlan, x: torch.Tensor) -> torch.Tensor:
    """x zero-padded to ``cols_pad``, then the ``e8*128`` extras-total
    slots (zero until the fold publishes into them)."""
    table = torch.zeros(plan.cols_pad + plan.e8 * LANE, dtype=torch.float32,
                        device=plan.device)
    table[:x.shape[0]] = x
    return table


def spmv_window_ell(plan: WindowEllPlan, x: torch.Tensor) -> torch.Tensor:
    """``y = A @ x`` through a plan (``_spmv_window_ell``,
    ``window_ell.py:1504-1523``).  ``x`` is the unpadded ``(num_cols,)``
    operand on the plan's device; returns ``(num_rows,)`` f32."""
    out = window_ell_fold(plan, gather_table(plan, x))
    if plan.lam is not None:
        return unpermute(out, plan.lam, plan.num_rows)
    return out[:plan.num_rows]
