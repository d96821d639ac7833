"""The window-ELL plan on a device, and the two kernels that run it.

Port of the device half of ``tpu_spmv/kernels/window_ell.py``:

* :class:`WindowEllPlan` holds a plan's arrays as tensors on one device, plus
  the port-only fold schedule (:class:`FoldSection`: each superblock's runs
  cut into chunks of at most :data:`CHUNK_RUNS`, derived on the host when
  the plan is made; not a plan-format field);
* :func:`plan_from_arrays` makes one from NumPy leaves, either those of a
  JAX ``WindowEllPlan`` (``np.asarray`` of each leaf, a bf16 value stream
  included) or those of a port
  :class:`~tpu_spmv_torch.kernels.plan.HostPlan`;
* :func:`gather_table` (K3, ``csrc/permute.cu``, the SpMV's first kernel:
  the gather table written in one pass, x's 128-element chunks in the
  order a reordered plan gives, then zeros), :func:`fold_sections` (K1 as
  the SpMV runs it, ``csrc/window_ell.cu``: the chunked fold, and
  :func:`section_epilogue`, which ends each section but the last: the
  ordered sum of its split superblocks' partial tiles and the publish of
  the extras totals into the gather table; :func:`window_ell_fold` ends
  the last section too) and :func:`unpermute` (K2, ``csrc/unpermute.cu``,
  which ends the SpMV, sums the last section's split tiles and, for a
  reordered plan, puts its tiles back in the natural order) are the
  kernel wrappers, with :func:`permute_chunks`, K3 as the public chunk
  permute.  Beside each is its plain PyTorch version.  A wrapper takes the
  plain version only for a tensor on the CPU; for a CUDA tensor it
  launches its kernel or raises.  Each kernel counts its launches in an
  attribute of one wrapper, ``launches``: an integer (K3's on
  :func:`permute_chunks`, which :func:`gather_table` adds to), and for
  K1's fold a dict per value stream (f32, bf16, or none for a pattern
  plan), keyed as :data:`FOLD_VARIANTS`;
* :func:`spmv_window_ell` runs a plan: set up the gather table, fold
  section by section, unpermute through ``lam``, trim to ``num_rows``;
  :func:`spmv_on_table` is the part after the set-up, which a reordered
  plan shares; :func:`spmv_pattern` runs a pattern plan of a column-scaled
  matrix;
* :class:`BandedPlan` (row bands, each a complete plan, outputs trimmed and
  joined) and :class:`CompositePlan` (levels of plans and a flat tail,
  outputs added) stack plans; :func:`spmv_banded`,
  :func:`spmv_pattern_banded` and :func:`spmv_composite` run them through
  the same kernels, each band or level with its own gather table.

Pattern plans stream no values: every stored nonzero is 1.0, and pad slots
carry a sentinel sub-block that no output row matches (:func:`sentinel`).
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import struct

import numpy as np
import torch

from ..csr import DeviceCSR
from ..errors import DeviceException, InvalidFormatError, guarded_upload
from ._build import kernels
from .plan import (AUX, CHUNKS, LANE, LEAVES, WINDOW, HostBanded,
                   HostComposite, HostPlan)
from .scalar import spmv_csr_scalar

_TB_LEGAL = (2, 4, 8)
_NTB_LEGAL = (8, 32, 128)
_F32 = torch.float32
# a partial tile's width (one superblock, n_tb*128 floats) at each height
_WIDTHS = tuple(n * LANE for n in _NTB_LEGAL)
# The argument blocks of the epilogues' and the table set-up's entry points
# (csrc/epilogue.cuh): C structs of 8-byte fields, a pointer or an int64
# each, passed as one pointer through ctypes per launch.  An epilogue's
# block begins with the section's SplitTiles, packed once
# (FoldSection.launch_block), and goes on with the launch's own fields.
# The field names are the C structs', in their order;
# tests/test_torch_epilogue.py holds them to the sources.
ARG_BLOCKS = {
    "SplitTiles": ("split_ptr", "split_base", "split_of_tile", "n_split",
                   "n_tiles"),
    "SectionEpilogueArgs": ("split", "partial", "n_tb", "extras_tile", "out",
                            "table_tail", "stream"),
    "UnpermuteArgs": ("split", "partial", "n_tb", "y", "n_y", "lam",
                      "tile_src", "n_src", "out", "n", "stream"),
    "PermuteArgs": ("x", "n_x", "src", "out", "out_len", "n_out", "stream"),
}


def _launch_fields(block: str) -> struct.Struct:
    """The packing of a block's fields after its leading ``split``."""
    return struct.Struct(f"{len(ARG_BLOCKS[block]) - 1}q")


_SPLIT_TILES = struct.Struct(f"{len(ARG_BLOCKS['SplitTiles'])}q")
_NO_SPLIT = bytes(_SPLIT_TILES.size)
_EPILOGUE_ARGS = _launch_fields("SectionEpilogueArgs")
_UNPERMUTE_ARGS = _launch_fields("UnpermuteArgs")
_PERMUTE_ARGS = struct.Struct(f"{len(ARG_BLOCKS['PermuteArgs'])}q")
# K1's value-stream codes (tsp_window_ell_fold's `values` argument)
_VALUE_CODES = {"float32": 0, "bfloat16": 1, "pattern": 2}
# K1's variants: the kernel name of each value stream's launches
FOLD_VARIANTS = {"float32": "window_ell_fold",
                 "bfloat16": "window_ell_fold_bf16",
                 "pattern": "window_ell_fold_pattern"}


# R, the most runs one chunk (one CTA of K1) folds.  The card has 132 SMs
# and holds about two fold CTAs on each (kernel shared memory: 80-100 KB a
# CTA), so a section wants 264 or more chunks to fill it: PageRank's 3,133
# live runs make 419 at R = 8, the 2^20 mesh's 1,613 level-1 runs 224.  A
# superblock cut into several chunks pays for each a partial tile written
# and read back, n_tb*128 f32: at sup 4096 16 KB each way against the 128
# KB of slot streams eight pattern runs carry (25%), at sup 1024 4 KB
# against 384 KB of f32 streams (2%).  Fewer runs per chunk would spend
# more on tiles than they win in spread.
CHUNK_RUNS = 8


@dataclasses.dataclass(frozen=True)
class FoldSection:
    """The fold schedule of one plan section (the blocks between two
    ``fin_step`` marks).  Each output superblock's runs, in plan order, are
    cut into chunks of at most :data:`CHUNK_RUNS` runs, heaviest superblock
    first; K1 runs one CTA per chunk.  Chunk ``c`` folds the runs
    ``run_order[chunk_ptr[c]:chunk_ptr[c+1]]`` (all of one superblock) and
    writes the superblock's ``n_tb*128`` outputs when ``chunk_slot[c]`` is
    -1, else its partial tile into workspace row ``chunk_slot[c]``.  Split
    superblock ``j`` (one cut into several chunks) owns the workspace rows
    ``split_ptr[j]:split_ptr[j+1]``, in chunk order; an epilogue (the
    section epilogue, or K2 after the last section) sums them into the
    output tiles from ``split_base[j]`` on.  ``split_of_tile[t]``, over the
    plan's ``out8`` output tiles, is the split superblock of this section
    that owns tile ``t``, or -1.  The counts are plain ints, so a launch
    reads no tensor shape."""

    run_order: torch.Tensor   # i32 (n_runs,) run indices in chunk order
    chunk_ptr: torch.Tensor   # i32 (n_chunks + 1,)
    chunk_slot: torch.Tensor  # i32 (n_chunks,) workspace row, or -1
    split_ptr: torch.Tensor   # i32 (n_split + 1,) workspace row ranges
    split_base: torch.Tensor  # i32 (n_split,) output base (128-row tiles)
    split_of_tile: torch.Tensor  # i32 (out8,) split superblock, or -1
    n_sup: int                # output superblocks of the section
    n_chunks: int             # chunks (K1's CTAs)
    n_split: int              # split superblocks
    n_slots: int              # workspace rows (partial tiles) written
    max_runs: int             # most runs in one chunk
    max_split: int            # most chunks of one split superblock

    @functools.cached_property
    def launch_block(self) -> bytes:
        """The section's split superblocks as the epilogues' argument
        blocks begin (``SplitTiles``, ``csrc/epilogue.cuh``): the device
        addresses of ``split_ptr``, ``split_base`` and ``split_of_tile``,
        ``n_split`` and the tile count, packed on first use.  The
        addresses stay valid while the section lives: it holds those
        tensors and, frozen, never replaces them."""
        return _SPLIT_TILES.pack(
            self.split_ptr.data_ptr(), self.split_base.data_ptr(),
            self.split_of_tile.data_ptr(), self.n_split,
            self.split_of_tile.numel())


class PlanFile:
    """``save`` and ``load`` of a device plan in the JAX package's plan
    format (:mod:`tpu_spmv_torch.plan_io`; the JAX plans' methods,
    ``window_ell.py:404-415``): ``load`` gives the plan on ``device``, the
    card unless the caller names another, and raises
    :class:`~tpu_spmv_torch.errors.InvalidFormatError` where the file holds
    another kind of plan."""

    def save(self, path: str) -> None:
        from ..plan_io import save_plan

        save_plan(self, path)

    @classmethod
    def load(cls, path: str, device=None):
        from ..plan_io import load_as

        return load_as(cls, path, device)


@dataclasses.dataclass(frozen=True)
class WindowEllPlan(PlanFile):
    """A window-ELL plan as tensors on one device (the fields of the JAX
    ``WindowEllPlan``, ``tpu_spmv/kernels/window_ell.py:311-352``)."""

    vals: torch.Tensor | None  # f32 or bf16 (G*8, 128); None for pattern
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
    def values(self) -> str:
        """The value stream: ``"float32"``, ``"bfloat16"`` or, for a
        pattern plan, ``"pattern"``."""
        return "pattern" if self.pat \
            else str(self.vals.dtype).removeprefix("torch.")

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

    @staticmethod
    def autotune(csr, x=None, split_rows: int | None = 128,
                 widths: tuple = (128, 384), iters: int = 200,
                 permute_rows: bool = False, device="cuda",
                 report: dict | None = None) -> "WindowEllPlan":
        """Build a candidate plan at each step width of ``widths``, time
        each on ``device`` (the card unless the caller names another) and
        return the fastest (``WindowEllPlan.autotune``,
        ``tpu_spmv/kernels/window_ell.py:421-451``).  Each candidate is
        :func:`~.plan.build` at that width, uploaded; its time is the
        median of 3 runs of ``iters`` SpMVs
        (:func:`~tpu_spmv_torch.timing.time_runs`: CUDA events on the card,
        the host clock only on a CPU device the caller names).  ``x``
        defaults to zeros; ``report``, where given, receives the seconds
        per call of each width."""
        import statistics

        from .. import timing
        from ..errors import target_device
        from .plan import build

        device = target_device(device, "autotune")
        xd = torch.zeros(csr.num_cols, dtype=torch.float32) if x is None \
            else torch.as_tensor(np.asarray(x, np.float32))
        xd = guarded_upload(xd, device)
        best = None
        for S in widths:
            plan = plan_from_host(build(csr, split_rows=split_rows,
                                        step_groups=S,
                                        permute_rows=permute_rows), device)
            secs = statistics.median(timing.time_runs(
                lambda: spmv_window_ell(plan, xd), device, num_runs=3,
                iters_per_run=iters))
            if report is not None:
                report[S] = secs
            if best is None or secs < best[0]:
                best = (secs, plan)
        return best[1]


def _unpack_sb(sb: np.ndarray | torch.Tensor, sbn: bool):
    """Per-group sub-blocks, shape (G, 8, 128), from the (maybe
    nibble-packed) ``sb`` stream."""
    if not sbn:
        return sb.reshape(-1, CHUNKS, LANE)
    pk = sb.reshape(-1, 1, CHUNKS, LANE)
    lo_nib, hi_nib = pk & 15, (pk >> 4) & 15
    cat = np.concatenate if isinstance(sb, np.ndarray) else torch.cat
    return cat([lo_nib, hi_nib], 1).reshape(-1, CHUNKS, LANE)


def sentinel(sbn: bool) -> int:
    """The sub-block of a pattern plan's pad slots: nibble 15 on a
    nibble-packed stream, -1 on the int8 one (``window_ell.py:1026-1031``).
    No output row matches it."""
    return 15 if sbn else -1


def _live_runs(aux: dict, vals: torch.Tensor | None,
               sb: np.ndarray) -> np.ndarray:
    """Per run (``tb`` groups), whether it holds a slot that adds
    anything: a nonzero value, or on a pattern plan a sub-block other than
    the sentinel."""
    if aux["pat"]:
        live = _unpack_sb(sb, aux["sbn"]) != sentinel(aux["sbn"])
    else:
        live = (vals != 0).numpy()
    return np.any(live.reshape(-1, aux["tb"] * CHUNKS * LANE), axis=1)


def _chunk_section(runs: np.ndarray, rb: np.ndarray,
                   chunk_runs: int) -> dict:
    """One section's chunk schedule (the fields of :class:`FoldSection`, as
    NumPy arrays and ints) from its live runs in plan order and their
    output bases.  A superblock of ``n`` runs becomes ``ceil(n /
    chunk_runs)`` chunks of nearly equal length, each a contiguous stretch
    of its runs in plan order; superblocks go heaviest first (ties by
    base)."""
    order = np.argsort(rb, kind="stable")
    ubase, start, counts = np.unique(rb[order], return_index=True,
                                     return_counts=True)
    run_order, chunk_ptr, chunk_slot = [], [0], []
    split_ptr, split_base = [0], []
    for j in np.argsort(-counts, kind="stable"):
        n = int(counts[j])
        n_ch = -(-n // chunk_runs)
        run_order.append(runs[order[start[j]:start[j] + n]])
        chunk_ptr.extend(chunk_ptr[-1] + (np.arange(1, n_ch + 1) * n) // n_ch)
        if n_ch == 1:
            chunk_slot.append(-1)
            continue
        chunk_slot.extend(range(split_ptr[-1], split_ptr[-1] + n_ch))
        split_ptr.append(split_ptr[-1] + n_ch)
        split_base.append(int(ubase[j]))
    i32 = lambda a: np.asarray(a, np.int64).astype(np.int32)  # noqa: E731
    chunk_ptr = np.asarray(chunk_ptr, np.int64)
    return dict(run_order=i32(np.concatenate(run_order)),
                chunk_ptr=i32(chunk_ptr), chunk_slot=i32(chunk_slot),
                split_ptr=i32(split_ptr), split_base=i32(split_base),
                n_sup=len(ubase), n_chunks=len(chunk_slot),
                n_split=len(split_base), n_slots=split_ptr[-1],
                max_runs=int(np.diff(chunk_ptr).max()),
                max_split=int(np.diff(split_ptr).max(initial=0)))


def _split_of_tile(split_base: np.ndarray, n_tb: int,
                   out8: int) -> np.ndarray:
    """Per output tile, the split superblock (index into ``split_base``,
    ``n_tb`` tiles each) that owns it, or -1."""
    owner = np.full(out8, -1, np.int32)
    for j, b in enumerate(split_base):
        owner[b:b + n_tb] = j
    return owner


def _fold_sections(aux: dict, live: np.ndarray, base: np.ndarray,
                   blk_step: np.ndarray, fin_step: np.ndarray,
                   chunk_runs: int = CHUNK_RUNS) -> list:
    """Split the plan's steps into sections at the ``fin_step`` marks and
    cut each section's runs into chunks (:func:`_chunk_section`, at most
    ``chunk_runs`` runs each; the tests force smaller caps).  Runs that
    ``live`` marks dead (:func:`_live_runs`: the padding that rounds
    sections up to whole blocks, all of it on one superblock per section)
    are left out: they add nothing for finite x.  Returns one dict of
    :class:`FoldSection` fields per non-empty section, its tile map
    (:func:`_split_of_tile`) included."""
    if chunk_runs < 1:
        raise ValueError(f"chunk_runs={chunk_runs}")
    S, tb = aux["step_groups"], aux["tb"]
    runs_per_block = S // tb
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
        runs = runs[live[runs]]
        if not len(runs):
            continue
        ubase = np.unique(base[runs]).tolist()
        if seen.intersection(ubase):
            raise InvalidFormatError(
                "window-ELL plan: two sections write one output superblock")
        seen.update(ubase)
        sec = _chunk_section(runs, base[runs], chunk_runs)
        sec["split_of_tile"] = _split_of_tile(
            sec["split_base"], aux["sup"] // LANE, aux["out8"])
        out.append(sec)
    return out


def _upload_sections(sections: list, device) -> tuple:
    """:class:`FoldSection` per dict of :func:`_fold_sections`, its arrays
    on ``device``."""
    return tuple(FoldSection(**{k: guarded_upload(v, device)
                                if isinstance(v, np.ndarray) else v
                                for k, v in s.items()})
                 for s in sections)


def _fold_schedule(plan: "WindowEllPlan", chunk_runs: int) -> tuple:
    """``plan``'s fold sections recut at ``chunk_runs`` runs per chunk, on
    its device (for tests and ablations; plans carry the schedule at
    :data:`CHUNK_RUNS`).  ``dataclasses.replace(plan, sections=...)`` runs
    the plan through it."""
    cpu = lambda t: t.cpu().numpy()  # noqa: E731
    aux = {"step_groups": plan.step_groups, "tb": plan.tb,
           "pat": plan.pat, "sbn": plan.sbn, "sup": plan.sup,
           "out8": plan.out8}
    live = _live_runs(aux, None if plan.pat else plan.vals.cpu(),
                      cpu(plan.sb))
    return _upload_sections(
        _fold_sections(aux, live, cpu(plan.base).astype(np.int64),
                       cpu(plan.blk_step), cpu(plan.fin_step), chunk_runs),
        plan.device)


def _validate(leaves: dict, aux: dict) -> None:
    """Host-side bounds checks: the kernels index with these arrays
    without checking them.  The fold schedule derived from them
    (:class:`FoldSection`) is in range by construction once ``base`` is:
    its superblocks are ``base`` entries, its tile maps ``out8`` long.
    The epilogues publish the extras region, the output's tiles from
    ``extras_base`` on, into the table's tail as float4s: both must start
    on a tile."""
    n_tb = aux["sup"] // LANE
    S, tb = aux["step_groups"], aux["tb"]
    if tb not in _TB_LEGAL or S % tb:
        raise InvalidFormatError(f"window-ELL plan: tb={tb}, S={S}")
    if aux["extras_base"] != (aux["out8"] - aux["e8"]) * LANE \
            or aux["e8"] < 1 or aux["cols_pad"] % LANE:
        raise InvalidFormatError("window-ELL plan: extras region")
    G = len(leaves["wg"])
    if G % S or len(leaves["base"]) != G // tb \
            or leaves["lo"].shape != (G * CHUNKS, LANE) \
            or leaves["sb"].shape != (G * CHUNKS // (2 if aux["sbn"]
                                                     else 1), LANE):
        raise InvalidFormatError("window-ELL plan: inconsistent shapes")
    if aux["pat"] != (leaves["vals"] is None):
        raise InvalidFormatError("window-ELL plan: a pattern plan has no "
                                 "value stream, any other plan has one")
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
    if G:
        # pattern plans' pad slots carry the sentinel, which K1 skips
        sbu = _unpack_sb(leaves["sb"], aux["sbn"])
        ok = (sbu >= 0) & (sbu < n_tb)
        if aux["pat"]:
            ok |= sbu == sentinel(aux["sbn"])
        if not ok.all():
            raise InvalidFormatError("window-ELL plan: sub-block range")
    lam = leaves["lam"]
    if lam is not None and (lam.ndim != 2 or lam.shape[1] != LANE
                            or lam.min() < 0 or lam.max() >= LANE):
        raise InvalidFormatError("window-ELL plan: lam out of range")


def _values_tensor(vals: np.ndarray | None,
                   values_dtype: str) -> torch.Tensor | None:
    """The value stream as a CPU tensor of its device type.  A JAX plan's
    bf16 leaf (an ``ml_dtypes`` array, which this package does not import),
    or its bits as ``uint16`` (a plan file's form) where ``values_dtype``
    is bfloat16, is taken bit for bit through an int16 view; f32 values are
    cast to bfloat16 when ``values_dtype`` says so (round to nearest even,
    as JAX's ``astype``)."""
    if vals is None:
        return None
    if str(vals.dtype) == "bfloat16" or (vals.dtype == np.uint16
                                         and values_dtype == "bfloat16"):
        return torch.from_numpy(vals.view(np.int16).copy()).view(
            torch.bfloat16)
    if vals.dtype != np.float32:
        raise InvalidFormatError(f"window-ELL plan: {vals.dtype} values")
    t = torch.from_numpy(vals if vals.flags.writeable else vals.copy())
    return t.to(torch.bfloat16) if values_dtype == "bfloat16" else t


def plan_from_arrays(leaves: dict, aux: dict, device="cuda",
                     occupancy: float = 0.0,
                     values_dtype: str = "float32") -> WindowEllPlan:
    """Make a device plan from NumPy leaves and static fields.

    ``leaves`` maps the names in :data:`~.plan.LEAVES` to NumPy arrays
    (``vals`` and ``lam`` may be ``None``), ``aux`` the names in
    :data:`~.plan.AUX` to values: the JAX ``WindowEllPlan``'s own fields, or
    a ``HostPlan``'s.  ``values_dtype`` (``"float32"`` or ``"bfloat16"``)
    is the device type of f32 ``vals``; a bf16 leaf stays bf16.  Checks
    bounds, derives the fold schedule on the host, and uploads every array
    to ``device`` (:func:`guarded_upload`), the card unless the caller names
    another."""
    leaves = {k: None if leaves[k] is None else np.ascontiguousarray(leaves[k])
              for k in LEAVES}
    aux = {k: aux[k] for k in AUX}
    _validate(leaves, aux)
    leaves["vals"] = _values_tensor(leaves["vals"], values_dtype)
    sections = _fold_sections(aux, _live_runs(aux, leaves["vals"],
                                              leaves["sb"]),
                              leaves["base"].astype(np.int64),
                              leaves["blk_step"], leaves["fin_step"])
    put = lambda a: None if a is None else guarded_upload(a, device)  # noqa: E731
    return WindowEllPlan(
        **{k: put(v) for k, v in leaves.items()}, **aux,
        sections=_upload_sections(sections, device),
        occupancy=float(occupancy))


def plan_from_host(hp: HostPlan, device="cuda") -> WindowEllPlan:
    """The device plan of a port-built :class:`HostPlan` (on the card unless
    the caller names another device)."""
    return plan_from_arrays(hp.leaves(), hp.aux(), device, hp.occupancy,
                            hp.values_dtype)


# ---- K1: the window-ELL fold, and its section epilogue ----

def _current_stream(device_index: int) -> int:
    """The current CUDA stream of a device as a raw ``cudaStream_t``:
    ``torch.cuda.current_stream(device_index).cuda_stream`` without
    building a ``torch.cuda.Stream`` (PyTorch's own accessor, private; a
    test on the card holds the two equal)."""
    return torch._C._cuda_getCurrentRawStream(device_index)


def on_device(index: int):
    """CUDA device ``index`` made current around a launch: a kernel goes
    to the current device, its stream must be that device's, and K1's
    shared-memory grant is per device.  No context switch where it is
    current already."""
    if torch.cuda.current_device() == index:
        return contextlib.nullcontext()
    return torch.cuda.device(index)


def _check_fold(plan: WindowEllPlan, table: torch.Tensor) -> None:
    if plan.pat != (plan.vals is None):
        raise ValueError("a pattern plan has no value stream, any other "
                         "plan has one")
    if plan.values not in _VALUE_CODES:
        raise ValueError(f"{plan.vals.dtype} value stream: K1 takes float32 "
                         "and bfloat16")
    n_table = plan.cols_pad + plan.e8 * LANE
    if table.dtype != torch.float32 or table.shape != (n_table,):
        raise ValueError(f"table must be float32 of shape ({n_table},); "
                         f"got {table.dtype} {tuple(table.shape)}")
    if table.device != plan.device:
        raise ValueError(f"table on {table.device}, plan on {plan.device}")


def _check_kernel_plan(plan: WindowEllPlan, table: torch.Tensor) -> None:
    """What K1's kernel and its epilogues take, checked once per call."""
    _check_fold(plan, table)
    if not table.is_cuda:
        raise ValueError(f"no window-ELL kernel for {table.device}")
    n_tb = plan.sup // LANE
    if n_tb not in _NTB_LEGAL or plan.tb not in _TB_LEGAL \
            or (plan.sbn and n_tb != 8):
        raise NotImplementedError(
            f"window-ELL kernel: n_tb={n_tb}, tb={plan.tb}, sbn={plan.sbn}")
    arrays = [plan.vals, plan.lo, plan.sb, plan.wg, plan.base]
    if not all(a is None or a.is_contiguous() for a in arrays):
        raise ValueError("window-ELL plan arrays must be contiguous")
    # the slot streams arrive by 16-byte bulk copies
    if any(a is not None and a.data_ptr() % 16 for a in arrays[:3]):
        raise ValueError("window-ELL slot streams must be 16-byte aligned")


def chunk_reduce_plain(partial: torch.Tensor, sec: FoldSection,
                       out: torch.Tensor) -> torch.Tensor:
    """The ordered reduce's plain version: each split superblock's output
    tiles are the sum of its chunks' partial tiles (rows of ``partial``,
    ``(n_slots, n_tb*128)``), added from zero in chunk order, the kernels'
    order, so they agree bit for bit.  Writes into ``out`` (flat, f32) and
    returns it."""
    if sec.n_split == 0:
        return out
    width = partial.shape[1]
    ptr = sec.split_ptr.long()
    n_chunks = ptr[1:] - ptr[:-1]
    acc = torch.zeros(sec.n_split, width, dtype=torch.float32,
                      device=out.device)
    for q in range(sec.max_split):
        take = n_chunks > q
        acc[take] += partial[ptr[:-1][take] + q]
    rows = sec.split_base.long().view(-1, 1) * LANE \
        + torch.arange(width, device=out.device)
    out[rows.reshape(-1)] = acc.reshape(-1)
    return out


def section_epilogue_plain(partial: torch.Tensor, sec: FoldSection,
                           out: torch.Tensor, table: torch.Tensor,
                           extras_base: int) -> torch.Tensor:
    """The section epilogue's plain version: the ordered reduce
    (:func:`chunk_reduce_plain`), then the publish copy of the extras
    region ``out[extras_base:]`` into the table's tail.  Writes into
    ``out`` and ``table``; returns ``out``."""
    chunk_reduce_plain(partial, sec, out)
    n_extras = out.shape[0] - extras_base
    table[table.shape[0] - n_extras:] = out[extras_base:]
    return out


def _check_partial(name: str, partial: torch.Tensor, sec: FoldSection,
                   dev: int, n_out: int) -> int:
    """What an epilogue's kernel reads of the fold's workspace: ``partial``
    contiguous f32 on CUDA device ``dev``, a superblock's tiles a row and at
    least the section's rows, and the section's tile map on ``dev`` over
    ``n_out`` outputs.  Returns the superblock's height in tiles."""
    rows, width = partial.shape
    owner = sec.split_of_tile
    if partial.dtype != _F32 or partial.get_device() != dev \
            or owner.get_device() != dev or rows < sec.n_slots \
            or width not in _WIDTHS or owner.numel() * LANE != n_out \
            or not partial.is_contiguous():
        raise ValueError(
            f"{name}: partial {partial.dtype} {tuple(partial.shape)} on "
            f"{partial.device}, section of {owner.numel()} tiles on "
            f"{owner.device}, {n_out} outputs")
    return width // LANE


def section_epilogue(partial: torch.Tensor, sec: FoldSection,
                     out: torch.Tensor, table: torch.Tensor,
                     extras_base: int,
                     stream: int | None = None) -> torch.Tensor:
    """K1's section epilogue, after a section's fold: each split
    superblock's output tiles are the sum of its chunks' partial tiles in
    chunk order (``partial``, ``(>= n_slots, n_tb*128)`` f32), and the
    extras region ``out[extras_base:]`` is published into the ``table``'s
    tail, where the next section gathers it.  For CUDA tensors launches
    ``csrc/window_ell.cu``'s ``section_epilogue`` once on ``stream`` (a raw
    ``cudaStream_t``, the current stream when None) with programmatic
    dependent launch; takes the plain version for CPU ones.  The section's
    arrays were checked when the plan was made; this checks the tensors
    passed, an attribute read each.  Writes into ``out`` (flat f32, one
    value per entry of ``sec.split_of_tile`` times 128) and ``table``;
    returns ``out``."""
    if not out.is_cuda:
        if out.is_cpu:
            return section_epilogue_plain(partial, sec, out, table,
                                          extras_base)
        raise ValueError(f"no section epilogue kernel for {out.device}")
    dev = out.get_device()
    n_out = out.numel()
    if out.dtype != _F32 or not out.is_contiguous():
        raise ValueError(f"section_epilogue takes contiguous float32 out; "
                         f"got {out.dtype} {tuple(out.shape)}")
    n_tb = _check_partial("section_epilogue", partial, sec, dev, n_out)
    n_extras = n_out - extras_base
    n_table = table.numel()
    tail = table.data_ptr() + 4 * (n_table - n_extras)
    if table.dtype != _F32 or table.get_device() != dev \
            or not table.is_contiguous() or extras_base % LANE \
            or not 0 < n_extras <= n_table or tail % 16:
        raise ValueError(
            f"section_epilogue: table {table.dtype} {tuple(table.shape)} on "
            f"{table.device}, extras from {extras_base} of {n_out}")
    with on_device(dev):
        err = kernels().tsp_section_epilogue(
            sec.launch_block + _EPILOGUE_ARGS.pack(
                partial.data_ptr(), n_tb, extras_base // LANE,
                out.data_ptr(), tail,
                _current_stream(dev) if stream is None else stream))
    if err:
        raise DeviceException(f"section epilogue launch: cudaError {err}")
    section_epilogue.launches += 1
    return out


section_epilogue.launches = 0


def _fold_section_plain(plan: WindowEllPlan, sec: FoldSection,
                        table: torch.Tensor,
                        out: torch.Tensor) -> torch.Tensor:
    """One section of K1's plain version, through the kernel's chunk
    schedule: a vectorized gather-multiply over the section's runs, then an
    ``index_add_`` of each chunk's products into ``out`` (a superblock of
    one chunk) or into the chunk's row of a zeroed partial workspace, which
    it returns (``(n_slots, sup)`` f32).  bf16 values are converted to f32
    before the multiply.  On a pattern plan the product is the gathered
    value, and the pad slots (sentinel sub-block) are dropped before the
    ``index_add_``: their rows would fall in a neighbouring superblock."""
    dev = table.device
    n_out, width = out.shape[0], plan.sup
    runs = sec.run_order.long()
    g = (runs[:, None] * plan.tb
         + torch.arange(plan.tb, device=dev)).reshape(-1)
    sub = torch.arange(CHUNKS, device=dev).view(1, CHUNKS, 1) * LANE
    lane = torch.arange(LANE, device=dev).view(1, 1, LANE)
    lo = plan.lo.reshape(-1, CHUNKS, LANE)[g]
    idx = plan.wg[g].long().view(-1, 1, 1) * WINDOW + sub + lo.long()
    row_base = plan.base[runs].long().repeat_interleave(plan.tb)
    sbg = _unpack_sb(plan.sb, plan.sbn)[g].long()
    local = sbg * LANE + lane           # index inside the superblock
    # each run's chunk, and where that chunk writes
    chunk = torch.repeat_interleave(
        torch.arange(sec.n_chunks, device=dev),
        (sec.chunk_ptr[1:] - sec.chunk_ptr[:-1]).long(),
        output_size=runs.shape[0])
    slot = sec.chunk_slot.long()[chunk].repeat_interleave(plan.tb)
    dest = torch.where(slot.view(-1, 1, 1) < 0,
                       row_base.view(-1, 1, 1) * LANE + local,
                       n_out + slot.view(-1, 1, 1) * width + local)
    buf = torch.zeros(n_out + sec.n_slots * width, dtype=torch.float32,
                      device=dev)
    buf[:n_out] = out
    if plan.pat:
        keep = sbg != sentinel(plan.sbn)
        buf.index_add_(0, dest[keep], table[idx][keep])
    else:
        vals = plan.vals.reshape(-1, CHUNKS, LANE)[g].float()
        buf.index_add_(0, dest.reshape(-1), (vals * table[idx]).reshape(-1))
    out.copy_(buf[:n_out])
    return buf[n_out:].view(-1, width)


def fold_sections(plan: WindowEllPlan, table: torch.Tensor,
                  plain: bool = False, stream: int | None = None) -> tuple:
    """K1 as the SpMV runs it, over every section of ``plan`` into a zeroed
    output: each section's fold, then, before the next section, its
    section epilogue, which publishes the extras totals into ``table`` (so
    ``table`` is written).  ``plain`` takes the plain versions (on any
    device), else the kernels on ``stream`` (a raw ``cudaStream_t``, the
    current stream when None), the plan checked once.  Returns ``(out,
    partial)``: the last section's split superblocks are still partial
    tiles in ``partial`` (None for a plan without sections), for the
    caller's epilogue."""
    if plain:
        return _run_sections(plan, table, True, stream)
    _check_kernel_plan(plan, table)
    with on_device(table.get_device()):
        return _run_sections(plan, table, False, stream)


def _run_sections(plan: WindowEllPlan, table: torch.Tensor, plain: bool,
                  stream: int | None) -> tuple:
    """:func:`fold_sections` after the checks, the kernels' device
    current."""
    dev = table.device
    out = torch.zeros(plan.out8 * LANE, dtype=torch.float32, device=dev)
    partial = None
    if not plain:
        if stream is None:
            stream = _current_stream(table.get_device())
        lib = kernels()
        n_slots = max((s.n_slots for s in plan.sections), default=0)
        partial = torch.empty(max(n_slots, 1), plan.sup, dtype=torch.float32,
                              device=dev)
        ptrs = [None if a is None else a.data_ptr()
                for a in (plan.vals, plan.lo, plan.sb, plan.wg, plan.base)]
        values = plan.values
    last = len(plan.sections) - 1
    for k, sec in enumerate(plan.sections):
        if plain:
            partial = _fold_section_plain(plan, sec, table, out)
        else:
            err = lib.tsp_window_ell_fold(
                table.data_ptr(), *ptrs, sec.run_order.data_ptr(),
                sec.chunk_ptr.data_ptr(), sec.chunk_slot.data_ptr(),
                sec.n_chunks, sec.max_runs, plan.tb, plan.sup // LANE,
                int(plan.sbn), _VALUE_CODES[values], out.data_ptr(),
                partial.data_ptr(), stream)
            if err:
                raise DeviceException(
                    f"window-ELL fold launch: cudaError {err}")
            window_ell_fold.launches[values] += 1
        if k < last:
            if plain:
                section_epilogue_plain(partial, sec, out, table,
                                       plan.extras_base)
            else:
                section_epilogue(partial, sec, out, table, plan.extras_base,
                                 stream)
    return out, partial


def window_ell_fold_plain(plan: WindowEllPlan,
                          table: torch.Tensor) -> torch.Tensor:
    """K1's plain version, through the same chunk schedule and in the same
    order as the kernels: per section the plain fold
    (:func:`_fold_section_plain`) and the section epilogue's plain version
    (:func:`section_epilogue_plain`), into a copy of the table.  A run the
    schedule lost or counted twice, or a chunk that straddled two
    superblocks, changes the result.  ``table`` (x zero-padded to
    ``cols_pad``, then ``e8*128`` slots) is not modified.  Returns the flat
    ``(out8*128,)`` output."""
    _check_fold(plan, table)
    table = table.clone()
    out, partial = fold_sections(plan, table, plain=True)
    if plan.sections:
        section_epilogue_plain(partial, plan.sections[-1], out, table,
                               plan.extras_base)
    return out


def window_ell_fold(plan: WindowEllPlan, table: torch.Tensor) -> torch.Tensor:
    """K1 with its output whole: :func:`fold_sections` into a copy of
    ``table``, then the last section's :func:`section_epilogue` too (whose
    publish the copy takes), where the SpMV leaves that section's split
    superblocks to K2.  For a CUDA ``table``, launches
    ``csrc/window_ell.cu``'s chunked fold once per section on the current
    stream, in the variant of the plan's value stream (f32, bf16 or none),
    and a section epilogue after each; takes the plain version for a CPU
    one.  ``table`` is not modified.  Returns ``(out8*128,)`` f32."""
    if table.is_cpu:
        return window_ell_fold_plain(plan, table)
    table = table.clone()
    out, partial = fold_sections(plan, table)
    if plan.sections:
        section_epilogue(partial, plan.sections[-1], out, table,
                         plan.extras_base)
    return out


window_ell_fold.launches = dict.fromkeys(FOLD_VARIANTS, 0)


# ---- K2: the row unpermute, the SpMV's final epilogue ----

def _pad_tiles(y: torch.Tensor, n_tiles_pad: int) -> torch.Tensor:
    """The first ``n_tiles_pad`` 128-row tiles of the flat output ``y``,
    zero-padded (``_unpermute_tiles``, ``window_ell.py:1495-1499``)."""
    y2 = y.reshape(-1, LANE)
    n_tiles = min(n_tiles_pad, y2.shape[0])
    padded = torch.zeros(n_tiles_pad, LANE, dtype=torch.float32,
                         device=y.device)
    padded[:n_tiles] = y2[:n_tiles]
    return padded


def unpermute_plain(y: torch.Tensor, lam: torch.Tensor | None,
                    num_rows: int, *, partial: torch.Tensor | None = None,
                    sec: FoldSection | None = None,
                    tile_src: torch.Tensor | None = None) -> torch.Tensor:
    """K2's plain version: ``unpermute_plain(chunk_reduce_plain(partial,
    sec, y), lam, num_rows)`` (the reduce on a copy of ``y``, and only
    where ``sec`` split a superblock); the unpermute itself is ``out[t, j]
    = y[t, lam[t, j]]`` over the padded tiles, flattened and trimmed to
    ``num_rows``, or ``y[:num_rows]`` without ``lam``.  With ``tile_src``,
    the unpermuted rows of every tile (``lam``'s, or ``y``'s without it)
    go through :func:`permute_chunks_plain` by ``tile_src``, trimmed to
    ``num_rows``."""
    if sec is not None and sec.n_split:
        y = chunk_reduce_plain(partial, sec, y.clone())
    if tile_src is not None:
        n_src = y.numel() if lam is None else lam.numel()
        return permute_chunks_plain(unpermute_plain(y, lam, n_src), tile_src,
                                    num_rows)
    if lam is None:
        return y.reshape(-1)[:num_rows]
    yp = _pad_tiles(y, lam.shape[0])
    return torch.take_along_dim(yp, lam.long(), dim=1).reshape(-1)[:num_rows]


def unpermute(y: torch.Tensor, lam: torch.Tensor | None, num_rows: int, *,
              partial: torch.Tensor | None = None,
              sec: FoldSection | None = None,
              tile_src: torch.Tensor | None = None,
              stream: int | None = None) -> torch.Tensor:
    """K2, the SpMV's final epilogue: restore row order from a leveled
    output (flat, a whole number of 128-row tiles; ``lam``, int32 ``(T,
    128)`` with values in [0, 128) checked when the plan is made, gives
    each row's source lane; None for the identity), trimmed to
    ``num_rows``.  With the last section's ``sec`` and ``partial`` tiles,
    the rows of its split superblocks are their chunk-order sums (the
    section epilogue's) instead of ``y``'s.  With ``tile_src`` (int32, one
    entry per output tile: a reordered plan's ``row_src``), output tile
    ``b`` is the plan's tile ``tile_src[b]``, unpermuted; a tile past the
    plan's reads as zeros.  Launches ``csrc/unpermute.cu`` for CUDA
    tensors on ``stream`` (a raw ``cudaStream_t``, the current stream when
    None) with programmatic dependent launch, reading past-the-end tiles
    as zeros instead of padding them; the plain version for CPU ones.
    ``y`` is not modified.  Checks the tensors passed, an attribute read
    each."""
    if not y.is_cuda:
        if y.is_cpu:
            return unpermute_plain(y, lam, num_rows, partial=partial,
                                   sec=sec, tile_src=tile_src)
        raise ValueError(f"no unpermute kernel for {y.device}")
    dev = y.get_device()
    n_y = y.numel()
    if y.dtype != _F32 or n_y % LANE or not y.is_contiguous():
        raise ValueError(f"unpermute takes contiguous float32 y, a whole "
                         f"number of tiles; got {y.dtype} {tuple(y.shape)}")
    lam_ptr, n_src = 0, n_y
    if lam is not None:
        if lam.dtype != torch.int32 or lam.get_device() != dev \
                or lam.dim() != 2 or lam.shape[1] != LANE \
                or not lam.is_contiguous():
            raise ValueError(f"unpermute takes int32 (T, 128) lam on y's "
                             f"device; got {lam.dtype} {tuple(lam.shape)} "
                             f"on {lam.device}")
        lam_ptr, n_src = lam.data_ptr(), lam.numel()
    tile_ptr, n_max = 0, n_src
    if tile_src is not None:
        if tile_src.dtype != torch.int32 or tile_src.get_device() != dev \
                or tile_src.dim() != 1 or not tile_src.is_contiguous():
            raise ValueError(f"unpermute takes contiguous 1-D int32 "
                             f"tile_src on y's device; got {tile_src.dtype} "
                             f"{tuple(tile_src.shape)} on {tile_src.device}")
        tile_ptr, n_max = tile_src.data_ptr(), tile_src.numel() * LANE
    if not 0 <= num_rows <= n_max:
        raise ValueError(f"unpermute: {n_max} rows, num_rows {num_rows}")
    split, partial_ptr, n_tb = _NO_SPLIT, 0, 0
    if sec is not None and sec.n_split:
        n_tb = _check_partial("unpermute", partial, sec, dev, n_y)
        split, partial_ptr = sec.launch_block, partial.data_ptr()
    res = torch.empty(num_rows, dtype=_F32, device=y.device)
    with on_device(dev):
        err = kernels().tsp_unpermute(split + _UNPERMUTE_ARGS.pack(
            partial_ptr, n_tb, y.data_ptr(), n_y, lam_ptr, tile_ptr, n_src,
            res.data_ptr(), num_rows,
            _current_stream(dev) if stream is None else stream))
    if err:
        raise DeviceException(f"unpermute launch: cudaError {err}")
    unpermute.launches += 1
    return res


unpermute.launches = 0


# ---- K3: the chunk gather, the gather table's set-up ----

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


def _permute_into(x: torch.Tensor, src: torch.Tensor | None,
                  out: torch.Tensor, out_len: int) -> torch.Tensor:
    """Launch K3 (``csrc/permute.cu``) on the current stream of ``out``'s
    device: ``out[:out_len]`` gathered from x by ``src`` (None: in order),
    the rest of ``out`` (contiguous f32, checked by the caller) zeroed.
    Checks the other tensors' attributes only; counts the launch in
    ``permute_chunks.launches``.  Returns ``out``."""
    dev = out.get_device()
    if x.dtype != _F32 or x.dim() != 1 or x.get_device() != dev:
        raise ValueError(f"K3 takes 1-D float32 x on {out.device}; got "
                         f"{x.dtype} {tuple(x.shape)} on {x.device}")
    if src is not None:
        if src.dtype != torch.int32 or src.dim() != 1 \
                or src.get_device() != dev or out_len > src.numel() * LANE:
            raise ValueError(f"K3 takes 1-D int32 src on {out.device}, a "
                             f"chunk per 128 of {out_len} outputs; got "
                             f"{src.dtype} {tuple(src.shape)} on "
                             f"{src.device}")
        src = src.contiguous()      # held until the launch is queued
    if not out.numel():
        return out
    x = x.contiguous()
    with on_device(dev):
        err = kernels().tsp_permute_chunks(_PERMUTE_ARGS.pack(
            x.data_ptr(), x.numel(), 0 if src is None else src.data_ptr(),
            out.data_ptr(), out_len, out.numel(), _current_stream(dev)))
    if err:
        raise DeviceException(f"permute_chunks launch: cudaError {err}")
    permute_chunks.launches += 1
    return out


def permute_chunks(x: torch.Tensor, src: torch.Tensor,
                   out_len: int) -> torch.Tensor:
    """K3 as the public chunk permute: ``out[j*128 + e] = x[src[j]*128 +
    e]`` for the first ``out_len`` elements, a chunk or element past the
    end of x reading as 0 (``permute_chunks``,
    ``tpu_spmv/kernels/reorder.py:260-271``).  Launches ``csrc/permute.cu``
    for CUDA tensors; the plain version for CPU ones."""
    if not x.is_cuda:
        return permute_chunks_plain(x, src, out_len)
    if out_len < 0:
        raise ValueError(f"permute_chunks: out_len {out_len}")
    return _permute_into(x, src, torch.empty(out_len, dtype=_F32,
                                             device=x.device), out_len)


permute_chunks.launches = 0


def setup_bytes(n_x: int, n_src: int) -> int:
    """Bytes the gather table's set-up reads: x once (``n_x`` floats) and
    ``n_src`` int32 chunk indices (0 in order).  Its write of the table is
    the plan's own (:attr:`WindowEllPlan.stream_bytes` counts the table
    once)."""
    return 4 * (n_x + n_src)


def _table_len(plan: WindowEllPlan, x: torch.Tensor,
               src: torch.Tensor | None) -> int:
    """The positions of the table that come from x: ``len(x)`` in order,
    the plan's columns through ``src``."""
    if src is not None:
        return plan.num_cols
    if x.numel() > plan.cols_pad:
        raise ValueError(f"x of {x.numel()} for a plan of {plan.cols_pad} "
                         f"padded columns")
    return x.numel()


def gather_table_plain(plan: WindowEllPlan, x: torch.Tensor,
                       src: torch.Tensor | None = None) -> torch.Tensor:
    """The table's set-up, plain: x (or, with ``src``,
    :func:`permute_chunks_plain` of x over the plan's ``num_cols``)
    zero-padded to ``cols_pad``, then the ``e8*128`` extras-total slots,
    zero."""
    if x.dtype != _F32 or x.dim() != 1 or x.device != plan.device:
        raise ValueError(f"the gather table takes 1-D float32 x on "
                         f"{plan.device}; got {x.dtype} {tuple(x.shape)} on "
                         f"{x.device}")
    n = _table_len(plan, x, src)
    table = torch.zeros(plan.cols_pad + plan.e8 * LANE, dtype=_F32,
                        device=plan.device)
    table[:n] = x if src is None else permute_chunks_plain(x, src, n)
    return table


def gather_table(plan: WindowEllPlan, x: torch.Tensor,
                 src: torch.Tensor | None = None) -> torch.Tensor:
    """The SpMV's gather table, which K1 reads and the section epilogues
    publish into: x zero-padded to ``cols_pad``, then the ``e8*128``
    extras-total slots, zero.  With ``src`` (int32, one entry per 128
    columns: a reordered plan's ``col_src``), the plan's column chunk ``j``
    is x's chunk ``src[j]`` (a chunk or element past the end of x reads
    as 0).  For a CUDA ``x`` launches K3 (``csrc/permute.cu``) once, which
    writes every element of the table; the plain version for a CPU one."""
    if not x.is_cuda:
        return gather_table_plain(plan, x, src)
    n_table = plan.cols_pad + plan.e8 * LANE
    out_len = _table_len(plan, x, src)
    return _permute_into(x, src, torch.empty(n_table, dtype=_F32,
                                             device=plan.device), out_len)


# ---- the SpMV ----

def spmv_on_table(plan: WindowEllPlan, table: torch.Tensor,
                  tile_src: torch.Tensor | None = None,
                  num_rows: int | None = None) -> torch.Tensor:
    """The SpMV after the table's set-up: K1 folds each section into the
    call's own gather table ``table``, each section but the last ended by
    :func:`section_epilogue`; :func:`unpermute` (K2) ends the call wherever
    the plan is leveled, its last section split a superblock, or
    ``tile_src`` maps its tiles (a reordered plan's ``row_src``), and sums
    that section's split tiles.  Returns ``num_rows`` (default the plan's)
    f32 rows.  On the card every launch goes to the stream current at the
    call; on the CPU the plain versions run in the same order."""
    plain = table.is_cpu
    stream = None if plain else _current_stream(table.get_device())
    out, partial = fold_sections(plan, table, plain, stream)
    last = plan.sections[-1] if plan.sections else None
    num_rows = plan.num_rows if num_rows is None else num_rows
    if tile_src is None and plan.lam is None \
            and (last is None or not last.n_split):
        return out[:num_rows]
    return unpermute(out, plan.lam, num_rows, partial=partial, sec=last,
                     tile_src=tile_src, stream=stream)


def spmv_window_ell(plan: WindowEllPlan, x: torch.Tensor) -> torch.Tensor:
    """``y = A @ x`` through a plan (``_spmv_window_ell``,
    ``window_ell.py:1504-1523``).  ``x`` is the unpadded ``(num_cols,)``
    operand on the plan's device; returns ``(num_rows,)`` f32: the gather
    table's set-up (:func:`gather_table`), then :func:`spmv_on_table`."""
    return spmv_on_table(plan, gather_table(plan, x))


def spmv_pattern(plan: WindowEllPlan, scale: torch.Tensor,
                 x: torch.Tensor) -> torch.Tensor:
    """``y = (B·diag(scale)) @ x`` over a pattern plan of the 0/1 structure
    B (``window_ell.py:1534-1540``): the column scale folds into x with one
    plain multiply, and K1 streams no values.  The per-slot products are
    the valued plan's."""
    if not plan.pat:
        raise ValueError("spmv_pattern takes a pattern plan")
    return spmv_window_ell(plan, scale * x)


# ---- banded plans: row bands as independent plans ----

@dataclasses.dataclass(frozen=True)
class BandedPlan(PlanFile):
    """A row-banded stack of window-ELL plans on one device (the JAX
    ``BandedPlan``, ``tpu_spmv/kernels/window_ell.py:1724-1795``). Each
    band is a complete plan over a slice of rows (its splits, spills and
    extras confined to it), padded with empty rows to a common height;
    ``band_rows`` are its real rows. The bands come from the v5e guards the
    planner keeps (``MAX_GROUPS``, ``VMEM_BUDGET``), so the plans equal the
    reference's. ``y`` is the bands' outputs, each trimmed to its real
    rows, joined in band order; ``x`` is shared, each band reading it into
    a gather table of its own."""

    plans: tuple             # WindowEllPlan per band, in row order
    num_rows: int
    num_cols: int
    band_rows: tuple = ()

    @property
    def n_groups(self) -> int:
        return sum(p.n_groups for p in self.plans)

    @property
    def sup(self) -> int:
        return max(p.sup for p in self.plans)

    @property
    def occupancy(self) -> float:
        tot = sum(p.n_groups for p in self.plans)
        return sum(p.occupancy * p.n_groups for p in self.plans) / tot \
            if tot else 0.0

    @property
    def sbn(self) -> bool:
        return all(p.sbn for p in self.plans)

    @property
    def stream_bytes(self) -> float:
        """The bands' bytes, each band counting its own gather table (x is
        read once per band), and the join of two bands or more (their rows
        read, ``y`` written)."""
        join = 8.0 * self.num_rows if len(self.plans) > 1 else 0.0
        return sum(p.stream_bytes for p in self.plans) + join


def banded_from_host(hb: HostBanded, device="cuda") -> BandedPlan:
    """The device plan of a port-built :class:`~.plan.HostBanded` (on the
    card unless the caller names another device)."""
    return BandedPlan(tuple(plan_from_host(p, device) for p in hb.plans),
                      hb.num_rows, hb.num_cols, tuple(hb.band_rows))


def spmv_banded(bp: BandedPlan, x: torch.Tensor) -> torch.Tensor:
    """``y = A @ x`` over a banded plan (``spmv_banded``,
    ``window_ell.py:1911-1925``): each band's SpMV on its own gather table,
    its rows trimmed to the band's real height where the SpMV ends (K2
    writes only those), then one join.  Raises
    :class:`~tpu_spmv_torch.errors.InvalidFormatError` where ``band_rows``
    do not partition ``num_rows`` over the bands (a stack whose pad rows
    would land in ``y``)."""
    rows = bp.band_rows or tuple(p.num_rows for p in bp.plans)
    if len(rows) != len(bp.plans) or sum(rows) != bp.num_rows:
        raise InvalidFormatError(
            f"BandedPlan band_rows {tuple(rows)} do not partition "
            f"num_rows={bp.num_rows} across {len(bp.plans)} bands")
    ys = [spmv_on_table(p, gather_table(p, x), num_rows=r)
          for p, r in zip(bp.plans, rows)]
    return ys[0] if len(ys) == 1 else torch.cat(ys)


def spmv_pattern_banded(bp: BandedPlan, scale: torch.Tensor,
                        x: torch.Tensor) -> torch.Tensor:
    """Banded form of :func:`spmv_pattern` (``window_ell.py:1543-1546``):
    the column scale folded into x once, for every band."""
    if not all(p.pat for p in bp.plans):
        raise ValueError("spmv_pattern_banded takes pattern plans")
    return spmv_banded(bp, scale * x)


# ---- composite plans: levels of plans plus a flat tail ----

@dataclasses.dataclass(frozen=True)
class CompositePlan(PlanFile):
    """A stack of window-ELL plans plus a flat remainder on one device (the JAX
    ``CompositePlan``, ``window_ell.py:1551-1598``): ``y = level_0(x) +
    level_1(x) + ... + flat(tail, x)``, added in that order. Every level
    covers all rows and columns."""

    plans: tuple             # WindowEllPlan per level
    tail: DeviceCSR | None   # the flat path's remainder, or None
    num_rows: int
    num_cols: int

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
        """The levels' bytes, the tail's (:attr:`DeviceCSR.stream_bytes`),
        and each add after the first level (y read twice, written once)."""
        tail = 0.0 if self.tail is None else self.tail.stream_bytes
        adds = len(self.plans) - 1 + (self.tail is not None)
        return sum(p.stream_bytes for p in self.plans) + tail \
            + 12.0 * self.num_rows * adds


def composite_from_host(hc: HostComposite, device="cuda") -> CompositePlan:
    """The device plan of a port-built :class:`~.plan.HostComposite`."""
    return CompositePlan(
        tuple(plan_from_host(p, device) for p in hc.plans),
        None if hc.tail is None else DeviceCSR.from_host(hc.tail, device),
        hc.num_rows, hc.num_cols)


def spmv_composite(cp: CompositePlan, x: torch.Tensor) -> torch.Tensor:
    """``y = A @ x`` over a composite plan (``spmv_composite``,
    ``window_ell.py:1705-1719``): the levels' SpMVs added in level order,
    then the tail's flat SpMV."""
    y = spmv_window_ell(cp.plans[0], x)
    for p in cp.plans[1:]:
        y = y + spmv_window_ell(p, x)
    if cp.tail is not None:
        y = y + spmv_csr_scalar(cp.tail, x)
    return y
