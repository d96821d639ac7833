"""The window-ELL host planner, in NumPy, with no JAX and no torch.

A copy of the planner in ``tpu_spmv/kernels/window_ell.py`` (the layout
constants, ``_level_rows``, ``WindowEllPlan._build`` and ``build``, the
superblock choice ``_choose_sup`` with its sampled model and probe,
``build_banded``, ``build_auto`` and ``build_composite``), so that a plan
can be built where JAX is not installed.  The bodies are kept as in the JAX package so the two
planners give equal plans leaf for leaf; the tests hold them to that.

Differences from the JAX planner:

* ``_build`` returns a :class:`HostPlan` of NumPy arrays; the torch plan
  (:mod:`.window_ell`) is made from it.
* ``step_groups=None`` resolves to the device default (256, or 128 for wide
  superblocks).  The JAX package resolves 8 under Pallas interpret mode; the
  port has no interpret mode, so 8 comes only from a caller.
* :func:`_absorb_run_padding` is defined here.  The JAX module calls it but
  no longer defines it; its body is the excess-descending run-padding
  absorption that module had inline before.
* A bf16 value stream (``values_dtype="bfloat16"``) is kept as f32 values
  plus ``HostPlan.values_dtype``: NumPy has no bfloat16, so the cast to
  bfloat16 (round to nearest even, as JAX's ``astype``) happens when the
  plan is uploaded (:func:`~.window_ell.plan_from_arrays`).
* :func:`build_auto` returns a :class:`HostPlan` or a :class:`HostBanded`
  (the band plans and their real rows).  :func:`build_banded` does not
  halve a band over the inflation guard (fault F7 of the JAX planner, which
  halves it until its halves slip under the guard's 4M-slot floor, at many
  times 64 slots a nonzero).
  :func:`build_composite` returns a :class:`HostComposite`, whose flat
  tail is a host CSR.  The device plans are made from them
  (:mod:`.window_ell`).

The layout constants are still the TPU v5e ones (``LANE``, ``CHUNKS``,
``WINDOW``, ``SUP_LEVELS``, ``T_SUB``, ``T_BASE``, ``VMEM_BUDGET``,
``MAX_GROUPS``, ``_STREAM_PS``, ``_SCATTER_PS``): keeping them keeps the
plans equal to the reference's.  Re-deriving them for Hopper is ROADMAP M13.
"""

from __future__ import annotations

import dataclasses
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from ..csr import CSRMatrix, _bucket
from ..errors import InvalidFormatError

LANE = 128
CHUNKS = 8            # table rows (col chunks) per window
WINDOW = 1024         # columns per window (CHUNKS * LANE)
# Candidate superblock heights.  Wider superblocks trade masked-sum
# scatter targets (sup/128 of them) for packing density — on matrices
# whose (1024-row x 1024-col) tiles hold only a handful of nonzeros
# (wide sparse web graphs), a 16384-row superblock keeps cells populated
# while the measured scatter cost (~0.3 ps/slot per target on v5e) stays
# proportional, so cost-per-nnz is roughly target-count-invariant.
SUP_LEVELS = (1024, 4096, 16384)
T_SUB = 16            # groups per compute sub-tile
# Groups sharing one scatter base (the plan's scatter-RUN length).
# Every run pads to T_BASE groups with zero slots, so the per-superblock
# padding expectation is (T_BASE-1)/2 groups — measured 1638 empty
# groups (10.7% of streamed bytes) on the 10M-nnz leveled headline at
# T_BASE=8 (round 4, /tmp/pad_probe).  Shorter runs buy padding back at
# the cost of more (n_tb,128) output RMWs per sub-tile (2 at 8, 4 at 4,
# 8 at 2 — the ind8u probe priced 16 arbitrary RMWs/tile at +0.55
# ps/slot, docs/PERF.md).  The plan carries its run length (``tb``) so
# kernels and layouts stay paired; planners resolve ``t_base=None``
# here (env ``TPU_SPMV_T_BASE`` for A/Bs).  Legal values: 2, 4, 8
# (the nibble-packed sb reassembly indexes group parity by t%2, which
# requires an even run length; 8 is the measured default — the round-5
# device A/B of shorter runs LOST despite streaming 5-8% fewer groups:
# the doubled/quadrupled per-run output read-modify-writes cost ~8%
# on the 10M-nnz headline, docs/AB_TBASE_r05.txt).
T_BASE = 8
SPILL_RUN = 64        # max spilled nnz absorbed per extra row

# VMEM budget for (x ++ extras gather block + output block +
# double-buffered packed blocks); ~16 MB/core on v5e minus headroom.
VMEM_BUDGET = 13 * (1 << 20)
# SMEM budget for the per-group scalar-prefetch tables.
MAX_GROUPS = 180_000

# cost-model constants for superblock selection (measured, v5e):
# HBM stream ~8.3 ps/slot; masked-sum scatter per slot by target count.
_STREAM_PS = 8.3
_SCATTER_PS = {1024: 2.3, 4096: 14.8, 16384: 69.0}   # per sup level
# K1 against K4 (the merge-path CSR kernel, csrc/merge_csr.cu), by value
# stream, in ps of device time: K1 a slot of _choose_sup's estimate, K4 a
# nonzero and a row.  They are the first opinion: the dispatch
# (spmv.merge_route) prices K1 at the estimated groups x 1,024 slots and K4
# at the matrix's nonzeros and rows, and serves K4 untimed where it is the
# cheaper.  Measured on an H100 80GB HBM3 at 700 W, each route's whole call
# replayed from a CUDA graph: graph500s20's K1 route 985.8 us f32 and 635.9
# us pattern over 371,139 estimated groups (3.05 and 1.97 ps a slot of the
# 315,392 built), K4 300.7 and 267.6 us over 31,402,094 nonzeros and
# 1,048,576 rows.  These are Graph500's rates, where every gather of x
# misses L1; on matrices whose x stays in L1 K4 runs 3.4-3.9 ps a nonzero
# and K1 5.4-6.9 ps a slot (powerlaw262k: K4 44.9 us against K1's 85.1;
# mesh1m unreordered: K4 42.5 against the reordered plan's 177.5), so the
# model keeps window-ELL there.  Where it keeps an f32 window-ELL plan,
# the card's timing of both calls is the second opinion
# (spmv._second_opinion), once per matrix and device.
K1_SLOT_PS = {"float32": 2.59, "pattern": 1.67}
K4_NNZ_PS = {"float32": 9.0, "pattern": 8.0}
K4_ROW_PS = {"float32": 17.0, "pattern": 15.0}
# the planner defaults build_auto passes and _choose_sup's cost model
# mirrors (the model is only calibrated while it matches the planner) —
# retune them HERE only.  Narrow superblocks re-tuned with the round-3
# atom-aware slot balancer (TPU_SPMV_BALANCE_LAYER=2, window 2):
# beta=2.2/slack=0 measures 17152 groups on the 10M-nnz headline vs
# 17664 at 2.6/1 (benchmarks/extras_headroom.py sweep); the wide
# defaults stay at 2.6/1 pending the on-device wide A/B.
AUTO_SPILL_BETA = 2.6
AUTO_CAP_SLACK = 1
AUTO_SPILL_BETA_NARROW = 2.2
AUTO_CAP_SLACK_NARROW = 0
# dispatch default for within-superblock row→lane leveling (build_auto
# permute_rows=None resolves here; env override for A/Bs).  Flipped ON
# by the round-4 on-device A/B (ab_device, 2026-08-19, real v5e, paired
# in-session with lever-engagement asserts): leveled 15360-group plan
# 127.7 µs vs best natural 17664-group plan 142.9 µs at S=384 (−10.6%,
# consistent with the −13% group count net of the ~12 B/row unpermute
# stream); at S=128 leveled 148.1 vs natural 153.8-158.9.  The inverse
# lane-gather pass compiles and verifies on hardware.
PERMUTE_ROWS_DEFAULT = True


def _t_base(t_base: int | None) -> int:
    """Resolve a planner's scatter-run length (see ``T_BASE``)."""
    if t_base is None:
        env = os.environ.get("TPU_SPMV_T_BASE")
        try:
            t_base = T_BASE if env is None else int(env)
        except ValueError:
            raise InvalidFormatError(
                f"TPU_SPMV_T_BASE must be an integer (2, 4 or 8); "
                f"got {env!r}") from None
    if t_base not in (2, 4, 8):
        raise InvalidFormatError(
            f"t_base must be 2, 4 or 8 (got {t_base})")
    return t_base


def _permute_default() -> bool:
    env = os.environ.get("TPU_SPMV_PERMUTE_ROWS")
    if env is not None:
        return env not in ("0", "")
    return PERMUTE_ROWS_DEFAULT


# rows with K <= bypass_k extras skip the level-2 combine and gather
# their level-1 totals directly (K=1 is the round-3 singles bypass).
# K=2 MEASURED NET-ZERO on the 10M-nnz leveled headline (15104 both
# ways: the L2 section shrinks one 128-group quantum but the 8202
# direct gather cells open/raise rows-region (sup, table-window)
# buckets by the same amount) and −128 WORSE on the 262K web graph;
# K>=3 is worse still (15488/16384 headline).  The combine split is at
# a measured local optimum at K=1.  Env override: TPU_SPMV_BYPASS_K.
BYPASS_K_DEFAULT = 1


def _bypass_k() -> int:
    env = os.environ.get("TPU_SPMV_BYPASS_K")
    return int(env) if env else BYPASS_K_DEFAULT


def _auto_caps(sup: int) -> tuple:
    """(spill_beta, cap_slack) defaults per superblock height — shared
    by ``build``/``build_auto`` and ``_choose_sup`` so the cost model
    stays calibrated against the planner it mirrors."""
    if sup == SUP_LEVELS[0]:
        return AUTO_SPILL_BETA_NARROW, AUTO_CAP_SLACK_NARROW
    return AUTO_SPILL_BETA, AUTO_CAP_SLACK


class WindowEllOverflow(InvalidFormatError):
    """The packed layout would not fit (VMEM/SMEM/inflation guards) —
    the structure is too adversarial for this kernel; callers fall back to
    the streaming path (mirrors the selector's role, C6)."""


def _pad_pow2(n: int, minimum: int = 1) -> int:
    n = max(n, minimum)
    return 1 << (n - 1).bit_length()


def _pad_geo(n: int, minimum: int = 8) -> int:
    """Round up to a x1.5 geometric bucket (bounds compiled-variant count
    like pow2 buckets but wastes <=33% instead of <=50%)."""
    v = max(minimum, 1)
    while v < n:
        v = -(-v * 3 // 2)
    return v


def _cumcount(keys: np.ndarray) -> np.ndarray:
    """Occurrence index of each element within its key group (native hash
    pass when the C++ library is built; NumPy sort fallback otherwise)."""
    from ..native import cumcount

    return cumcount(keys)


def _beta_caps(cb: np.ndarray, dcount: np.ndarray, n_buckets: int,
               spill_beta: float, cap_slack: int) -> np.ndarray:
    """Order-statistic spill caps: per-bucket layer cap = depth of the
    k-th deepest cell, k the smallest cell count that justifies keeping
    a layer at ~``spill_beta`` extras slots per spilled nonzero, plus
    ``cap_slack``.  ``cb``/``dcount`` are the bucket id and depth of
    each occupied cell.  Shared by the planner (``_build``) and the
    cost model (``_choose_sup``) so the two cannot drift."""
    k = int(CHUNKS * LANE / spill_beta) + 1
    order = np.lexsort((-dcount, cb))
    kth = _cumcount(cb[order]) == (k - 1)
    cap = np.zeros(n_buckets, np.int64)
    cap[cb[order][kth]] = dcount[order][kth]
    return cap + cap_slack


def _unique_ic(keys: np.ndarray):
    """unique + inverse + counts (one native hash pass when available)."""
    from ..native import unique_inverse_counts

    return unique_inverse_counts(keys)


def _level_rows(csr: CSRMatrix, sup_rows: int, split_rows):
    """Within-superblock row→lane leveling (``permute_rows=True``).

    Rows of each 128-row tile are reassigned to distinct lanes by the
    native greedy (:func:`tpu_spmv.native.balance_row_tiles`) so
    per-(window, chunk, lane) cell depths level within every superblock
    — the same atom-aware layer cost as the extras slot balancer, now
    applied to the ROW region (measured on the 10M-nnz power-law
    headline: 17152 → 15488 groups; 262K web graph at sup=4096:
    39552 → ~32.5K).  Because the permutation is per-tile, the inverse
    is ONE lane gather on the (tiles, 128) output block
    (:func:`_unpermute_tiles`) — the public y-order contract holds.

    Returns ``(lam, permuted_csr)`` where ``lam[t, j]`` is the permuted
    lane holding original row ``t*128 + j`` (int32, identity in the
    padded tail), or ``(None, csr)`` when the native library is absent
    or ``TPU_SPMV_NO_BALANCE`` is set (callers keep natural order).
    """
    from ..native import balance_row_tiles

    rows, nnz = csr.num_rows, csr.nnz
    row_len = np.diff(csr.row_ptrs).astype(np.int64)
    parts = np.maximum(-(-row_len // split_rows), 1) if split_rows \
        else None
    # wc = global chunk id (window * CHUNKS + chunk) = col // LANE
    wc = csr.col_indices.astype(np.int64) // LANE
    n_wc = _bucket(max(csr.num_cols, 1)) // LANE
    lanes = balance_row_tiles(csr.row_ptrs, wc, n_wc, sup_rows, parts)
    if lanes is None:
        return None, csr
    new_of_old = (np.arange(rows, dtype=np.int64) // LANE) * LANE + lanes
    old_of_new = np.empty(rows, np.int64)
    old_of_new[new_of_old] = np.arange(rows, dtype=np.int64)
    new_len = row_len[old_of_new]
    new_ptr64 = np.zeros(rows + 1, np.int64)
    np.cumsum(new_len, out=new_ptr64[1:])
    # per-nnz gather: new row i's slice comes from old row old_of_new[i]
    gat = np.repeat(csr.row_ptrs[old_of_new].astype(np.int64)
                    - new_ptr64[:-1], new_len) \
        + np.arange(nnz, dtype=np.int64)
    perm_csr = CSRMatrix(rows, csr.num_cols, csr.values[gat],
                         csr.col_indices[gat],
                         new_ptr64.astype(csr.row_ptrs.dtype))
    n_tiles = -(-rows // LANE)
    # pad tiles so the unpermute kernel's block height divides evenly
    t_u = min(512, _pad_pow2(n_tiles, minimum=8))
    n_tiles_pad = -(-n_tiles // t_u) * t_u
    lam = np.tile(np.arange(LANE, dtype=np.int32), (n_tiles_pad, 1))
    lam.reshape(-1)[:rows] = lanes.astype(np.int32)
    return lam, perm_csr


def _build(csr: CSRMatrix, split_rows, step_groups, cap_slack,
           cap_margin, spill_rounds, max_inflation, sup, spill_beta,
           permute_rows: bool = False,
           pattern: bool = False,
           t_base: int | None = None,
           values_dtype: str = "float32") -> HostPlan:
    sup_rows = sup           # scalar superblock height; ``sup`` below
    del sup                  # is reused for per-nnz superblock ids
    tb = _t_base(t_base)
    if spill_beta is None:
        # Measured default (benchmarks/sweep_caps.py +
        # extras_headroom.py, 10M-nnz power-law headline): order-
        # statistic caps cut total groups vs the flat-margin caps at
        # sup=1024 (18688 -> 17664 at beta=2.6/slack=1 with the slot
        # balancer; 17152 at beta=2.2/slack=0 with the atom-aware
        # scorer).  Wide superblocks are shallow (cap ~1) and
        # unmeasured under beta via this entry — keep the legacy
        # margin caps there (build_auto passes beta explicitly).
        # Pass spill_beta=0 to force the legacy caps at any height.
        spill_beta = AUTO_SPILL_BETA_NARROW \
            if sup_rows == SUP_LEVELS[0] else 0.0
    n_tb = sup_rows // LANE
    rows, nnz = csr.num_rows, csr.nnz
    cols_pad = _bucket(max(csr.num_cols, 1))
    n_windows = cols_pad // WINDOW
    if step_groups is None:
        # 256 is the robust single default on v5e (round 3): the
        # chip's per-session throughput state flips the optimum —
        # S=128 wins fast sessions (152 us on the headline) but
        # degrades to ~181 us in the slow state, while S=256 holds
        # 160-164 us in BOTH states.  Peak-chasing callers use
        # WindowEllPlan.autotune (or bench.py's dual-plan measure).
        # The JAX package resolves 8 under Pallas interpret mode; the
        # port has no interpret mode, so 8 comes only from the caller.
        # Wide superblocks are fori-path and scatter-bound — keep their
        # smaller blocks for VMEM headroom
        step_groups = 128 if sup_rows >= 4096 else 256
    # Normalize to a kernel-legal step width: the sub-tile loop runs
    # S // T_SUB full tiles and each tile folds T_SUB // T_BASE base
    # runs, so any S that is neither 8 nor a multiple of T_SUB would
    # leave trailing groups unprocessed (silently wrong results for
    # e.g. SpMVConfig(block_size=24) -> step_groups=12).  Rounding up
    # is always safe: blocks are padded to S groups with zero slots.
    step_groups = T_BASE if step_groups <= T_BASE \
        else -(-step_groups // T_SUB) * T_SUB
    S = step_groups
    lam_arr = None
    if permute_rows and nnz and rows > 1:
        # within-superblock row→lane leveling: build on the permuted
        # matrix; the plan carries the per-tile inverse (lam) and the
        # dispatch restores row order with one lane gather
        lam_arr, csr = _level_rows(csr, sup_rows, split_rows)
    row_len = np.diff(csr.row_ptrs).astype(np.int64)
    if nnz:
        row_of_nnz = np.repeat(np.arange(rows, dtype=np.int64), row_len)
        cols64 = csr.col_indices.astype(np.int64)
        w = cols64 // WINDOW
        c = (cols64 // LANE) % CHUNKS
    else:
        row_of_nnz = cols64 = w = c = np.zeros(0, np.int64)

    # ---- strided row splitting (merge-path equal-work) ----
    if split_rows:
        parts = np.maximum(-(-row_len // split_rows), 1)
    else:
        parts = np.ones(rows, np.int64)
    extras_per_row = parts - 1
    n_extra_split = int(extras_per_row.sum())
    extra_base_of_row = np.zeros(rows, np.int64)
    if rows:
        np.cumsum(extras_per_row[:-1], out=extra_base_of_row[1:])
    extra_to_row = np.repeat(np.arange(rows, dtype=np.int64),
                             extras_per_row)
    # extra rows live after the real rows, SUP-aligned, in a
    # geometrically-bucketed position space (bounds kernel variants)
    extras_base = _pad_geo(-(-max(rows, 1) // sup_rows), minimum=1) \
        * sup_rows

    if nnz:
        from ..native import plan_positions

        # fused native walk (one pass) — the NumPy formulation costs
        # three variable-count repeats (~6 s at 10M nnz on one core)
        pos, _ = plan_positions(csr.row_ptrs, parts, extra_base_of_row,
                                extras_base)
    else:
        pos = np.zeros(0, np.int64)

    # the gather table is x (cols_pad columns) followed by the extras
    # scratch region; combine nonzeros live beyond cols_pad, so windows
    # span ceil((cols_pad + extras)/WINDOW)
    def derive(pos, w, c):
        """Per-nnz lane / superblock / stacking layer within its cell
        (cell = (superblock, window, chunk, lane)) — fused native pass
        when the C++ library is built."""
        from ..native import plan_derive

        return plan_derive(pos, w, c, n_tab_windows, sup_rows)

    n_tab_windows = n_windows  # widened after extras are known
    lane, sup, layer = derive(pos, w, c)

    # ---- layer cap + spill to extra rows ----
    n_extra = n_extra_split
    if nnz:
        for _round in range(max(spill_rounds, 1)):
            bw = sup * n_windows + w
            ubw, inv, cnt = _unique_ic(bw)
            if spill_beta:
                # Economically optimal cap per bucket.  Keeping layer
                # L costs CHUNKS*LANE slots and saves spilling the
                # n_ge[L] cells at depth >= L one nonzero each, worth
                # ~spill_beta slots apiece in the extras region
                # (packing + combine overhead, measured ~2 slots/nnz
                # at extras occupancy ~0.5).  Since n_ge[L] is
                # non-increasing, the optimum has the closed form
                # "depth of the k-th deepest cell", k = the smallest
                # cell count that justifies a layer.  cap=0 (spill
                # the whole bucket) is allowed: a near-empty bucket's
                # content packs better as extras content than under
                # its own 1024-slot layer.
                cell = inv * (CHUNKS * LANE) + c * LANE + lane
                ucell, dcount = np.unique(cell, return_counts=True)
                cap = _beta_caps(ucell // (CHUNKS * LANE), dcount,
                                 len(ubw), spill_beta, cap_slack)
            else:
                # layer cap per bucket: ideal layers plus a relative
                # margin
                cap = np.maximum(
                    -(-(cnt + (cnt * cap_margin).astype(np.int64))
                      // (CHUNKS * LANE)),
                    -(-cnt // (CHUNKS * LANE))) + cap_slack
            # absorb run padding as layer capacity (round 3): the
            # group order pads each superblock's group count to a
            # multiple of T_BASE with zero-slot groups; raising
            # bucket caps by that deficit converts pure padding
            # into spill capacity (fewer extras at the same
            # streamed bytes).  Approximate — the later extras/
            # combine buckets shift the counts a little — but most
            # of the padding converts.  Round 5: the deficit is
            # distributed over the superblock's buckets in
            # excess-descending order (the round-3 pass raised only
            # the single deepest bucket, leaving deficit unabsorbed
            # when its excess ran out).  The residual empty pads
            # (978 groups on the 10M-nnz leveled headline,
            # benchmarks/pad_decompose.py) come from POST-spill
            # drift — combine/extras-gather cells shifting rows-
            # region layer counts off tb-multiples — which this
            # pass cannot see; feedback passes that re-target the
            # shifted totals were measured drift-defeated (extras
            # −256 groups, rows +512), and shorter runs lose on
            # scatter RMWs (docs/AB_TBASE_r05.txt).
            lmax_b = np.zeros(len(ubw), np.int64)
            np.maximum.at(lmax_b, inv, layer + 1)
            used = np.minimum(lmax_b, cap)
            sup_b = ubw // n_windows
            usup, sup_binv = np.unique(sup_b, return_inverse=True)
            cnt_sup = np.zeros(len(usup), np.int64)
            np.add.at(cnt_sup, sup_binv, used)
            deficit = (-cnt_sup) % tb
            if deficit.any():
                cap = _absorb_run_padding(cap, lmax_b - cap,
                                          sup_binv, len(usup),
                                          deficit)
            spilled = layer >= cap[inv]
            if not spilled.any():
                break
            # one extra row per (original row, ≤64-spill run).  Spills
            # are dealt ROUND-ROBIN across the row's extra rows so each
            # extra row's nonzeros stay spread over windows/chunks
            # (consecutive spills are consecutive columns; stacking 64
            # of them on one extra row would rebuild an 8-deep cell).
            rkey = row_of_nnz[spilled]
            occ_idx = _cumcount(rkey)
            u_r, inv_r, cnt_r = np.unique(rkey, return_inverse=True,
                                          return_counts=True)
            n_runs = -(-cnt_r // SPILL_RUN)
            run = occ_idx % n_runs[inv_r]
            big = int(run.max()) + 1
            skey = rkey * big + run
            su, sinv = np.unique(skey, return_inverse=True)
            pos = pos.copy()
            pos[spilled] = extras_base + n_extra + sinv
            extra_to_row = np.concatenate([extra_to_row, su // big])
            n_extra += len(su)
            lane, sup, layer = derive(pos, w, c)
    # pattern plans: every stored nonzero acts as 1.0 (values are a
    # stream the kernel never reads); the combine/extras machinery
    # already uses unit values
    vals_src = np.ones(nnz, np.float32) if pattern else csr.values
    extras_sup0 = extras_base // sup_rows
    lvl2_sup0 = extras_sup0
    if n_extra:
        # interleave extras by (occurrence-within-row, row): a row's
        # extras land at widely-spaced table slots, so their level-2
        # gathers spread over windows/chunks instead of stacking one
        # cell deep.  (A round-3 "dense-by-construction" band layout
        # optimizing the gather-slot cells was measured WORSE —
        # occ 0.455 -> 0.408 on the headline — because it clusters a
        # row's hot spill content into a few superblocks; spreading
        # the content dominates gather-slot density.)
        k_within = _cumcount(extra_to_row)
        is_extra = pos >= extras_base
        # (Content-(window,chunk) extras ordering was re-measured in
        # round 3 for the WIDE class with the slot balancer + singles
        # bypass active: extras region improves (occ 0.036 -> 0.042)
        # but the ROWS region blows up (18944 -> 24264 groups on the
        # 262K web graph) because singles' combine gather columns are
        # their extras indices — content-clustered indices stack
        # combine cells.  The interleave spreads them near-uniformly.
        # A band-primary/content-secondary hybrid loses the same way.)
        perm = np.lexsort((extra_to_row, k_within))
        inv_perm = np.empty(n_extra, np.int64)
        inv_perm[perm] = np.arange(n_extra, dtype=np.int64)
        extra_to_row = extra_to_row[perm]
        if is_extra.any():
            from ..native import (balance_extra_lanes,
                                  balance_extra_slots)

            # round-3: content-aware SLOT assignment — greedy on
            # projected cell depths (native pass; no-op without the
            # library).  The interleave spreads a row's extras
            # across superblocks; the balancer additionally chooses
            # each extra's (superblock, lane) inside a sliding
            # window of superblocks so hot content chunks stop
            # stacking layers (the older within-block lane-only
            # greedy is the fallback).
            safe_idx = np.clip(pos - extras_base, 0, n_extra - 1)
            ie = inv_perm[safe_idx][is_extra]
            cnt_i = np.bincount(ie, minlength=n_extra)
            ptr_i = np.zeros(n_extra + 1, np.int64)
            np.cumsum(cnt_i, out=ptr_i[1:])
            wc_arr = np.empty(len(ie), np.int64)
            wc_arr[ptr_i[ie] + _cumcount(ie)] = \
                w[is_extra] * CHUNKS + c[is_extra]
            # default window 2 (round-3 atom-aware measurement:
            # win=2 nets 17536->17280 on the headline; win>=3 loses
            # it back to combine-window spread — single-extra rows'
            # gather columns move with the index, and wider shuffles
            # scatter them over more (row_sup, window) buckets)
            win = int(os.environ.get("TPU_SPMV_BALANCE_WINDOW", "2"))
            if win >= 1:
                # direct-combine rows' (K <= bypass_k) nonzeros
                # gather at cols_pad + (the index this pass
                # assigns) — couple those cells into the score
                # (native.cc rationale)
                cnt_row = np.bincount(extra_to_row, minlength=rows)
                crow = np.where(cnt_row[extra_to_row] <= _bypass_k(),
                                extra_to_row, -1)
                i2 = balance_extra_slots(
                    ptr_i, wc_arr, n_windows * CHUNKS, sup_rows,
                    window_sups=win, ext_crow=crow)
            else:
                i2 = None
            if i2 is None:
                lanes = balance_extra_lanes(
                    ptr_i, wc_arr, n_windows * CHUNKS, sup_rows)
                if lanes is not None:
                    i2 = (np.arange(n_extra, dtype=np.int64) // LANE) \
                        * LANE + lanes
            if i2 is not None:
                inv_perm = i2[inv_perm]
                e2r_new = np.empty(n_extra, extra_to_row.dtype)
                e2r_new[i2] = extra_to_row
                extra_to_row = e2r_new
            pos = np.where(is_extra, extras_base + inv_perm[safe_idx],
                           pos)
        # fold the combine into the kernel, in up to TWO levels.  A
        # heavy row's K extras all target one output lane (row %
        # 128), so a flat combine would need K distinct table chunks
        # per lane — measured on the 10M-nnz headline it scattered
        # 88K combine nonzeros over 1.9K near-empty buckets
        # (occupancy 0.026).  Rows with MANY extras get ONE level-2
        # extra row of unit-valued gathers of their level-1 totals;
        # rows with K <= bypass_k extras skip level 2 entirely
        # (round-3; K=1 singles first, generalized to K<=2 late):
        # their combine nonzeros gather the level-1 totals directly
        # — the interleave keeps those gather columns spread, so
        # the direct cells ride existing rows-region buckets, while
        # every bypassed row shrinks the sparse L2 region (measured
        # on the 10M-nnz leveled headline: K<=2 removes 4101 of
        # 6580 L2 rows and 8202 of 22310 L2 gathers; L2 section 512
        # -> 384 groups with the rows region unchanged.  L2
        # occupancy was 0.012 — 3.4% of the plan for 0.2% of nnz).
        rows_w, lvl2_of_extra, k_count = np.unique(
            extra_to_row, return_inverse=True, return_counts=True)
        R2 = len(rows_w)
        bypass_k = _bypass_k()
        lvl2_row = k_count > bypass_k
        n_lvl2 = int(lvl2_row.sum())
        rho2_of_row = np.cumsum(lvl2_row) - 1     # rank among L2 rows
        is_lvl2 = lvl2_row[lvl2_of_extra]         # per L1 extra
        lvl2_base = -(-n_extra // sup_rows) * sup_rows
        lvl2_sup0 = extras_sup0 + lvl2_base // sup_rows
        me = np.nonzero(is_lvl2)[0]
        e2r_l2 = rows_w[lvl2_row]
        # balance the LEVEL-2 region (round-3 late; opt-in).  rho2
        # rank in row order scatters each L2 superblock's gathers
        # over all ~n_extra/1024 table windows.  The same slot
        # balancer as L1 — content = the row's L1 extras'
        # table-slot windows, crow-coupled to the FINAL combine
        # gather (which reads cols_pad + lvl2_base + the rank this
        # pass assigns) — clusters shared windows per superblock.
        # MEASURED NET-ZERO on the 10M-nnz leveled headline (L2
        # section 512 -> 384 groups, but clustering the final
        # gather columns raises the rows region by the same 128 —
        # rank order is already near-optimal spreading for the
        # rows region) and a no-op on the 262K web graph, so the
        # knob defaults OFF; kept for A/Bs on shapes whose L2
        # region dominates (TPU_SPMV_L2_BALANCE=1).
        if n_lvl2 and os.environ.get("TPU_SPMV_L2_BALANCE"):
            from ..native import balance_extra_slots

            old_rank = rho2_of_row[lvl2_of_extra[me]]
            cnt2 = np.bincount(old_rank, minlength=n_lvl2)
            ptr2 = np.zeros(n_lvl2 + 1, np.int64)
            np.cumsum(cnt2, out=ptr2[1:])
            o2 = np.argsort(old_rank, kind="stable")
            wc2 = (me[o2] // LANE).astype(np.int64)
            win2 = int(os.environ.get(
                "TPU_SPMV_L2_WINDOW",
                str(max(-(-n_lvl2 // sup_rows), 1))))
            n_wc2 = -(-(int(wc2.max()) + 1) // CHUNKS) * CHUNKS
            rho_bal = balance_extra_slots(
                ptr2, wc2, n_wc2, sup_rows,
                window_sups=win2, ext_crow=e2r_l2)
            if rho_bal is not None:
                rho2_of_row[lvl2_row] = rho_bal
                e2r_new2 = np.empty(n_lvl2, e2r_l2.dtype)
                e2r_new2[rho_bal] = e2r_l2
                e2r_l2 = e2r_new2
        pos_l2 = extras_base + lvl2_base \
            + rho2_of_row[lvl2_of_extra[me]]
        cols_l2 = cols_pad + me                   # L1 table slots
        # combine: direct-combine rows gather each L1 total at its
        # table slot; L2 rows gather their L2 total
        be = np.nonzero(~is_lvl2)[0]              # direct-read extras
        pos_fin = np.concatenate([extra_to_row[be],
                                  rows_w[lvl2_row]])
        cols_fin = np.concatenate(
            [cols_pad + be,
             cols_pad + lvl2_base + rho2_of_row[lvl2_row]])
        pos = np.concatenate([pos, pos_l2, pos_fin])
        cols64 = np.concatenate([cols64, cols_l2, cols_fin])
        vals_src = np.concatenate(
            [vals_src,
             np.ones(len(me) + len(pos_fin), np.float32)])
        extra_to_row = np.concatenate([extra_to_row, e2r_l2])
        n_extra_pos = lvl2_base + n_lvl2
    else:
        n_extra_pos = 0
    # gather-table sublanes for extras totals (pow2-bucketed to bound
    # the compiled-variant count)
    e8 = _pad_geo(max(-(-n_extra_pos // sup_rows), 1), minimum=1) \
        * n_tb
    n_tab_windows = n_windows + e8 // CHUNKS
    n_all = len(pos)
    if n_all:
        w = cols64 // WINDOW
        c = (cols64 // LANE) % CHUNKS
        lane, sup, layer = derive(pos, w, c)
        bw = sup * n_tab_windows + w
        ubw, inv, _ = _unique_ic(bw)
    else:
        ubw = np.zeros(0, np.int64)
        inv = np.zeros(0, np.int64)

    # ---- groups per (superblock, window) bucket ----
    # bucket order: extras superblocks FIRST (their totals must be in
    # the gather table before row groups' combine slots read them),
    # then row superblocks
    lmax = np.zeros(len(ubw), np.int64)
    if n_all:
        np.maximum.at(lmax, inv, layer + 1)
    is_row_bucket = (ubw // n_tab_windows) < extras_sup0
    border = np.lexsort((ubw, is_row_bucket.astype(np.int64)))
    rank = np.empty(len(ubw), np.int64)
    rank[border] = np.arange(len(ubw), dtype=np.int64)
    ubw = ubw[border]
    lmax = lmax[border]
    inv = rank[inv]
    n_groups_real = int(lmax.sum())
    g_sup = np.repeat(ubw // n_tab_windows, lmax)
    g_w = np.repeat(ubw % n_tab_windows, lmax)

    # groups are ordered by (region, sup, w, layer); nnz → group index
    group_start = np.zeros(len(ubw), np.int64)
    if len(ubw):
        np.cumsum(lmax[:-1], out=group_start[1:])

    # ---- pad group runs so every T_BASE-aligned run shares one
    # superblock (the scatter base), and each extras section (level-1,
    # level-2) ends at a block boundary — the extras→table copies
    # happen between grid steps ----
    fin_blocks: list[int] = []
    if n_groups_real:
        change = np.nonzero(np.diff(g_sup))[0] + 1
        run_starts = np.concatenate(
            [np.zeros(1, np.int64), change]).astype(np.int64)
        run_ends = np.concatenate(
            [change, np.asarray([n_groups_real], np.int64)])
        run_counts = run_ends - run_starts
        run_sup = g_sup[run_starts]
        pad_counts = -(-run_counts // tb) * tb
        # processing order: level-1 extras, level-2 extras, rows
        run_lvl1 = (run_sup >= extras_sup0) & (run_sup < lvl2_sup0)
        run_lvl2 = run_sup >= lvl2_sup0
        running = 0
        for sec in (run_lvl1, run_lvl2):
            if not sec.any():
                continue
            last = int(np.nonzero(sec)[0][-1])
            sec_total = running + int(pad_counts[sec].sum())
            deficit = (-sec_total) % S
            pad_counts[last] += deficit
            running = sec_total + deficit
            fin_blocks.append(running // S)
        total = int(pad_counts.sum())
        n_blocks = max(-(-total // S), 1)
        pad_counts[-1] += n_blocks * S - total
        new_starts = np.zeros(len(run_counts), np.int64)
        np.cumsum(pad_counts[:-1], out=new_starts[1:])
        old_to_new = np.repeat(new_starts - run_starts, run_counts) \
            + np.arange(n_groups_real, dtype=np.int64)
        g_sup_pad = np.repeat(run_sup, pad_counts)
        # interleave scatter bases: cycle consecutive T_BASE runs
        # through different superblocks within each section, so the
        # (8,128) output read-modify-writes hit different addresses —
        # same-address RMW chains serialize the VPU (measured ~1.5x
        # on the headline).  Section order (lvl1, lvl2, rows) and the
        # section block boundaries are preserved.
        rs_pad = g_sup_pad[::tb]
        r_reg = np.where(rs_pad < extras_sup0, 2,
                         np.where(rs_pad < lvl2_sup0, 0, 1))
        rk = _cumcount(rs_pad)
        run_perm = np.lexsort((rs_pad, rk, r_reg))
        new_of_old_run = np.empty(len(run_perm), np.int64)
        new_of_old_run[run_perm] = np.arange(len(run_perm),
                                             dtype=np.int64)
        old_to_new = new_of_old_run[old_to_new // tb] * tb \
            + old_to_new % tb
        g_sup_pad = rs_pad[run_perm].repeat(tb)
    else:
        n_blocks = 1
        old_to_new = np.zeros(0, np.int64)
        g_sup_pad = np.zeros(S, np.int64)
    n_groups_pad = n_blocks * S

    # memory-blowup guard: fires when the packed layout would be both
    # large in absolute terms (> 4M slots = 24 MB) and heavily inflated
    # relative to nnz
    slots = n_groups_pad * CHUNKS * LANE
    if nnz and slots > max_inflation * nnz and slots > (1 << 22):
        raise WindowEllOverflow(
            f"window-ELL padding {slots} slots for {nnz} nnz "
            f"(inflation {slots / nnz:.1f}x > {max_inflation}x)")
    # per-group window/base indices are scalar-prefetched into SMEM
    # (~1 MB); refuse plans whose prefetch would not fit
    if n_groups_pad > MAX_GROUPS:
        err = WindowEllOverflow(
            f"window-ELL plan needs {n_groups_pad} groups; the "
            f"per-group window table would exceed SMEM")
        # sizing hint for build_banded: bands needed to fit SMEM
        err.needed_groups = n_groups_pad
        raise err
    out8 = extras_base // LANE + e8
    cols8 = cols_pad // LANE
    # double-buffered packed blocks: 6 B/slot (f32 vals + lo + sb),
    # 2 B/slot for pattern plans (no vals stream)
    vmem_bytes = (cols8 + e8 + out8) * LANE * 4 \
        + 2 * S * CHUNKS * LANE * (2 if pattern else 6)
    if vmem_bytes > VMEM_BUDGET:
        err = WindowEllOverflow(
            f"window-ELL working set {vmem_bytes} B exceeds the VMEM "
            f"budget {VMEM_BUDGET} B")
        # sizing hints for build_banded: the x-block + double-buffer
        # bytes do not shrink with row banding; the output/extras
        # tables do
        err.vmem_fixed = cols8 * LANE * 4 + 2 * S * CHUNKS * LANE * 6
        err.vmem_var = (e8 + out8) * LANE * 4
        raise err

    n_steps = _pad_geo(n_blocks)
    blk = np.full(n_steps, -1, np.int32)
    blk[:n_blocks] = np.arange(n_blocks, dtype=np.int32)
    fin = np.zeros(n_steps, np.int32)
    for b in fin_blocks:
        fin[b] = 1

    vals = np.zeros((n_groups_pad * CHUNKS, LANE), np.float32)
    lo = np.zeros((n_groups_pad * CHUNKS, LANE), np.int8)
    sb = np.zeros((n_groups_pad * CHUNKS, LANE), np.int8)
    wg_arr = np.zeros(n_groups_pad, np.int64)
    if n_groups_real:
        wg_arr[old_to_new] = g_w
    base = (g_sup_pad[::tb] * n_tb).astype(np.int32)
    if n_all:
        from ..native import fill_slots

        group_of_nnz = old_to_new[group_start[inv] + layer]
        flat = group_of_nnz * (CHUNKS * LANE) + c * LANE + lane
        fill_slots(flat, vals_src, cols64 % LANE, (pos // LANE) % n_tb,
                   vals, lo, sb)
    # nibble-pack the sb stream across group pairs when targets fit
    # 4 bits (narrow superblocks): groups 2t/2t+1 share one int8 vreg
    # (-0.5 B/slot; n_groups_pad is always even — S is a multiple
    # of 8).  The kernel unpacks with `& 15` on both nibbles, which
    # is sign-extension-safe for sb values 8..15.  Pattern plans
    # reserve nibble 15 for the pad sentinel, so they need
    # n_tb <= 15 (true at every standard SUP level that packs).
    sbn = n_tb <= 16 and (not pattern or n_tb <= 15)
    if pattern:
        # pad slots have no zero value to mask their gathered
        # garbage — give them a sub-block no masked-sum target
        # matches (15 packs into either nibble; -1 on the int8
        # stream).  All-real-1.0 values make vals==0 ⇔ pad.
        sb[vals == 0] = 15 if sbn else -1
    if sbn:
        pairs = sb.reshape(n_groups_pad // 2, 2, CHUNKS, LANE)
        sb = (pairs[:, 0] | (pairs[:, 1] << 4)).reshape(-1, LANE)

    return HostPlan(
        vals=None if pattern else vals,
        lo=lo,
        sb=sb,
        wg=wg_arr.astype(np.int32),
        base=base,
        blk_step=blk,
        fin_step=fin,
        extra_to_row=extra_to_row.astype(np.int32),
        num_rows=rows,
        num_cols=csr.num_cols,
        extras_base=int(extras_base),
        n_extra=int(len(extra_to_row)),
        e8=int(e8),
        out8=int(out8),
        cols_pad=cols_pad,
        step_groups=S,
        split_rows=split_rows,
        sup=sup_rows,
        occupancy=float(nnz / slots) if slots else 0.0,
        sbn=sbn,
        pat=pattern,
        tb=tb,
        lam=lam_arr,
        # the bf16 cast comes last, after the pad-sentinel logic above has
        # seen exact zeros (window_ell.py:1042-1048); pattern plans have no
        # value stream to cast
        values_dtype="float32" if pattern else values_dtype,
    )

# measure-and-pick: when a superblock candidate's analytic cost lands
# within its contention ratio of the model's best, stop trusting the
# model — it cannot see row splitting, row→lane leveling or the
# atom-aware balancers (all of which specifically shrink narrow
# plans), which is how the round-4 skew-585 mischoice FAILED a recorded
# artifact.  Candidates in contention are re-scored with SAMPLED REAL
# BUILDS (every m-th superblock band through the full packer).  The
# ratios are ASYMMETRIC because the model's bias is one-directional:
# it over-prices NARROW plans by up to ~4x (the invisible transforms
# only ever shrink them — skew-585: est 4x over; round-5 grid: actual
# narrow cost 1.2x wide while the model said > 2x), while wide
# estimates track actuals within ~1.4x (docs/PERF.md est/actual
# history).  docs/MODEL_GRID_r05.json validates the resulting picks.
PROBE_AMBIG_NARROW = 5.0       # narrow candidate contends within 5x
PROBE_AMBIG_WIDE = 2.0         # wide candidates contend within 2x
PROBE_MIN_NNZ = 200_000        # below this, builds are cheap either way
PROBE_TARGET_NNZ = 1_500_000   # sampled-build size (~1 s of packer)


def _sample_bands(csr: CSRMatrix, sup: int, m: int) -> CSRMatrix:
    """Every ``m``-th ``sup``-row band of ``csr`` stacked into one
    matrix (same columns) — the planner-faithful sampling unit the
    analytic model uses, applied to a REAL build."""
    n_sups = -(-csr.num_rows // sup)
    bands = [(i * sup, min((i + 1) * sup, csr.num_rows))
             for i in range(0, n_sups, m)]
    ptr64 = csr.row_ptrs.astype(np.int64)
    vals, cols, ptr_parts, base = [], [], [np.zeros(1, np.int64)], 0
    for a, b in bands:
        lo, hi = int(ptr64[a]), int(ptr64[b])
        vals.append(csr.values[lo:hi])
        cols.append(csr.col_indices[lo:hi])
        ptr_parts.append(ptr64[a + 1:b + 1] - lo + base)
        base += hi - lo
    return CSRMatrix(sum(b - a for a, b in bands), csr.num_cols,
                     np.concatenate(vals), np.concatenate(cols),
                     np.concatenate(ptr_parts))


def _probe_groups(csr: CSRMatrix, sup: int, split_rows) -> float | None:
    """Actual (scaled) group count of a sampled real build at ``sup`` —
    sees everything the analytic model cannot.  ``None`` = the sampled
    build overflowed (treated as model-cost-only by the caller)."""
    n_sups = -(-csr.num_rows // sup)
    m = max(1, min(csr.nnz // PROBE_TARGET_NNZ, n_sups))
    sub = csr if m <= 1 else _sample_bands(csr, sup, m)
    narrow = sup == SUP_LEVELS[0]
    beta, slack = _auto_caps(sup)
    try:
        p = build(
            sub, sup=sup, split_rows=split_rows if narrow else None,
            spill_beta=beta, cap_slack=slack,
            permute_rows=_permute_default())
    except WindowEllOverflow:
        return None
    sampled_sups = -(-n_sups // m)
    return p.n_groups * (n_sups / sampled_sups)


def _choose_sup(csr: CSRMatrix, with_groups: bool = False,
                split_rows: int | None = None):
    """Pick the superblock height by the measured cost model.

    For each candidate, estimate streamed slots (bucket-capped groups plus
    an extras-region term for the spilled mass) and score them at the
    measured per-slot rates (HBM stream + per-target masked-sum scatter).
    Candidates whose group count would blow the SMEM prefetch budget are
    skipped unless row banding can subdivide them (see
    :func:`build_auto`).  ``with_groups=True`` also returns the winner's
    estimated group count (0 = unknown), letting ``build_auto`` pre-size
    bands instead of paying a doomed full-matrix build.

    When the model's top two candidates score within
    ``PROBE_AMBIG_RATIO``, the choice is settled by sampled REAL builds
    instead (``_probe_groups``) — the analytic model is blind to row
    splitting (``split_rows``, threaded from the dispatch) and to
    row→lane leveling, both of which shrink narrow plans on skewed
    structure (the round-4 skew-585 incident; validated on the
    round-5 structure grid, docs/MODEL_GRID_r05.json).  Env
    ``TPU_SPMV_NO_SUP_PROBE=1`` disables the probe for A/Bs.
    """
    nnz = csr.nnz
    if nnz == 0:
        return (SUP_LEVELS[0], 0) if with_groups else SUP_LEVELS[0]
    # the probe only pays in the depth regime where the model's
    # narrow-side blindness (splitting/leveling) has mass to act on:
    # mean narrow bucket depth in [0.5, 2.0) (>= 2 short-circuits to
    # narrow above; far below, narrow groups are empty-bucket-floor
    # bound, which the model prices accurately — grid evidence: all
    # depth < 0.1 picks were already correct pre-probe while the
    # depth-1.8-1.9 picks were all wrong, docs/MODEL_GRID_r05.json).
    depth = nnz / ((-(-max(csr.num_rows, 1) // SUP_LEVELS[0]))
                   * (_bucket(max(csr.num_cols, 1)) // WINDOW)
                   * (CHUNKS * LANE))
    if depth >= 2.0:
        # dense-narrow short-circuit (same gate _rank_sups applies) —
        # taken HERE, before the O(nnz) coordinate arrays are
        # materialized: the headline class answers from nnz + dims alone
        return (SUP_LEVELS[0], 0) if with_groups else SUP_LEVELS[0]
    rows_of = np.repeat(np.arange(csr.num_rows, dtype=np.int64),
                        np.diff(csr.row_ptrs).astype(np.int64))
    ranked = _rank_sups(rows_of, csr.col_indices.astype(np.int64),
                        csr.num_rows, csr.num_cols)
    best, best_cost, best_groups = ranked[0]
    contenders = [
        (s, mc, mg) for s, mc, mg in ranked
        if mc <= best_cost * (PROBE_AMBIG_NARROW if s == SUP_LEVELS[0]
                              else PROBE_AMBIG_WIDE)]
    if (len(contenders) >= 2 and nnz >= PROBE_MIN_NNZ and depth >= 0.5
            and not os.environ.get("TPU_SPMV_NO_SUP_PROBE")):
        scored = []
        for s, model_cost, model_groups in contenders:
            g = _probe_groups(csr, s, split_rows)
            if g is None:
                scored.append((model_cost, s, model_groups))
            else:
                scored.append((g * (_STREAM_PS + _SCATTER_PS[s]), s,
                               int(g)))
        scored.sort()
        best, best_groups = scored[0][1], scored[0][2]
    return (best, best_groups) if with_groups else best


def _rank_sups(rows_of: np.ndarray, cols64: np.ndarray,
               num_rows: int, num_cols: int) -> list:
    """Analytic superblock ranking on raw coordinates (NO probe):
    ``[(sup, model_cost, est_groups), ...]`` best-first.  The probe-free
    core shared by :func:`_choose_sup` and :func:`build_composite`
    (which re-ranks per level on the shrinking remainder and must not
    pay sampled builds per level)."""
    nnz = len(rows_of)
    if nnz == 0:
        return [(SUP_LEVELS[0], 0.0, 0)]
    cols_pad = _bucket(max(num_cols, 1))
    n_windows = cols_pad // WINDOW
    n_sups0 = -(-max(num_rows, 1) // SUP_LEVELS[0])
    # short-circuit: when narrow (1024-row) buckets are already deep, the
    # narrow mode always wins (wider superblocks only add scatter
    # targets).  Threshold 2.0 (round 4, was 8.0): at mean bucket depth
    # >= 2 the narrow realized occupancy is >= ~0.25, so narrow costs
    # <= ~36 ps/nnz while sup=4096's fori scatter floor is ~50 even at
    # occupancy 0.5 — and the sampled model below does NOT see row
    # splitting or row→lane leveling, both of which specifically shrink
    # narrow plans on skewed structure (measured: the 131K/skew-585
    # perf-property matrix at depth 7.15 built 6.5K narrow groups
    # ≈ 59 µs vs the model's wide pick at 138 µs — the model
    # over-priced narrow ~4x and flipped the choice).  Re-validated on
    # the round-5 structure grid (depth 2-16 rows all narrow-best,
    # docs/MODEL_GRID_r05.json); ambiguity below the threshold is now
    # settled by the sampled-build probe rather than the raw model.
    if nnz / (n_sups0 * n_windows * (CHUNKS * LANE)) >= 2.0:
        return [(SUP_LEVELS[0], 0.0, 0)]
    costs = _sampled_sup_costs(rows_of, cols64, num_rows, num_cols)
    if not costs:
        return [(SUP_LEVELS[-1], float("inf"), 0)]
    return sorted(((s, c, g) for s, (c, g) in costs.items()),
                  key=lambda t: t[1])


def _sampled_sup_costs(rows_of: np.ndarray, cols64: np.ndarray,
                       num_rows: int, num_cols: int) -> dict:
    """The sampled packing-cost model behind :func:`_choose_sup`, on raw
    (row, col) coordinate arrays: ``{sup: (cost, est_groups)}`` for every
    non-disqualified level.  Exposed on coordinates (rather than a CSR)
    so the structure-adaptive reordering probe (``kernels/reorder.py``)
    can score a candidate relabeling without materializing the permuted
    matrix.

    Samples WHOLE SUPERBLOCKS (all nonzeros of every m-th sup row band)
    rather than striding nonzeros: the model mirrors the planner's
    order-statistic layer caps (spill_beta ~2.6, cap_slack 1), and
    order statistics of per-cell depths are destroyed by nnz striding
    (shallow cells have depth 1-5; scaling a strided count back up
    mis-ranks them, which flipped the selection with the stride).
    Within a sampled bucket depths are EXACT; group counts scale by
    the sampling factor afterwards.  The round-2 model's nnz striding
    additionally over-counted shallow-bucket floors stride-fold (1M
    web graph: est 424K groups at sup=16384 vs 165K actual).
    Validated against built plans: est/actual 0.96-0.97 on the 262K
    web graph (sup=4096) and the 10M headline; ~1.4 at sup=16384
    (its high measured per-slot scatter cost dominates selection
    anyway).
    """
    nnz = len(rows_of)
    cols_pad = _bucket(max(num_cols, 1))
    n_windows = cols_pad // WINDOW
    out = {}
    for s in SUP_LEVELS:
        sup_id = rows_of // s
        n_sups = -(-num_rows // s)
        # target ~1M sampled nnz in whole-superblock units
        m = max(1, min(nnz // 1_000_000, n_sups))
        if m > 1:
            sel = sup_id % m == 0
            rws, cls, sid = rows_of[sel], cols64[sel], sup_id[sel]
        else:
            rws, cls, sid = rows_of, cols64, sup_id
        w = cls // WINDOW
        lane = rws % LANE
        c = (cls // LANE) % CHUNKS
        bucket = sid * n_windows + w
        ub, binv, bcnt = _unique_ic(bucket)
        cell = binv * (CHUNKS * LANE) + c * LANE + lane
        ucell, _, dcount = _unique_ic(cell)
        cb = ucell // (CHUNKS * LANE)
        cap = _beta_caps(cb, dcount, len(ub), *_auto_caps(s))
        lmax = np.zeros(len(ub), np.int64)
        np.maximum.at(lmax, cb, dcount)
        kept = int(np.minimum(lmax, cap).sum())
        spilled = int((dcount - cap[cb]).clip(0).sum())
        # Extras-region occupancy scales with the superblock height
        # (more rows per bucket -> denser extras cells): measured
        # 0.012-0.021 / 0.03-0.056 / 0.08-0.13 on the 65K/262K/1M
        # web graphs for sup 1024/4096/16384.  The dense-narrow class
        # (high extras occupancy) short-circuits above and never
        # reaches this estimate.
        occ_e = {1024: 0.018, 4096: 0.04, 16384: 0.09}[s]
        sampled_sups = -(-n_sups // m)
        groups = int((kept + spilled / (CHUNKS * LANE * occ_e))
                     * (n_sups / sampled_sups))
        slots = groups * CHUNKS * LANE
        # mirror the build-time guards: inflation always disqualifies;
        # the SMEM prefetch cap only when row banding cannot subdivide
        # (build_auto rescues over-MAX_GROUPS candidates as a BandedPlan)
        if slots > 64.0 * nnz and slots > (1 << 22):
            continue
        if groups > MAX_GROUPS and num_rows <= s:
            continue
        out[s] = (groups * (_STREAM_PS + _SCATTER_PS[s]), groups)
    return out


# ---- the plan as the host planner returns it ----

# array leaves, in the JAX ``WindowEllPlan.tree_flatten`` order
LEAVES = ("vals", "lo", "sb", "wg", "base", "blk_step", "fin_step",
          "extra_to_row", "lam")
# static fields, in the JAX ``tree_flatten`` aux order (occupancy is left
# out there; it is diagnostic)
AUX = ("num_rows", "num_cols", "extras_base", "n_extra", "e8", "out8",
       "cols_pad", "step_groups", "split_rows", "sup", "sbn", "pat", "tb")


@dataclasses.dataclass(frozen=True)
class HostPlan:
    """A window-ELL plan as NumPy arrays: the fields of the JAX
    ``WindowEllPlan`` (``tpu_spmv/kernels/window_ell.py:311-352``)."""

    vals: np.ndarray | None  # f32 (n_groups_pad*8, 128); None for pattern
    lo: np.ndarray           # i8  (n_groups_pad*8, 128)  col % 128 per slot
    sb: np.ndarray           # i8  (n_groups_pad*8, 128) row sub-block, or
    #                          (n_groups_pad*4, 128) nibble-packed when sbn
    wg: np.ndarray           # i32 (n_groups_pad,)  x window per group
    base: np.ndarray         # i32 (n_groups_pad/tb,) output sublane per run
    blk_step: np.ndarray     # i32 (n_steps,) block per step, -1 = pad
    fin_step: np.ndarray     # i32 (n_steps,) 1 = publish extras totals first
    extra_to_row: np.ndarray  # i32 (n_extra,) extra slot → original row
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
    occupancy: float
    sbn: bool = False
    pat: bool = False
    tb: int = T_BASE
    lam: np.ndarray | None = None  # i32 (n_tiles_pad, 128) leveled lanes
    # the value stream's type on the device: "float32", or "bfloat16" (the
    # f32 ``vals`` above are cast when the plan is uploaded)
    values_dtype: str = "float32"

    @property
    def n_groups(self) -> int:
        return int(self.wg.shape[0])

    def leaves(self) -> dict:
        return {k: getattr(self, k) for k in LEAVES}

    def aux(self) -> dict:
        return {k: getattr(self, k) for k in AUX}


def _absorb_run_padding(cap: np.ndarray, excess: np.ndarray,
                        sup_binv: np.ndarray, n_sups: int,
                        deficit: np.ndarray) -> np.ndarray:
    """Raise bucket layer caps by each superblock's run-padding deficit.

    The group order pads every superblock's group count to a multiple of
    the run length ``tb``; raising bucket caps by that deficit turns pure
    padding into spill capacity.  The deficit of a superblock is spread
    over its buckets in excess-descending order (``excess`` = deepest layer
    minus cap, per bucket), each bucket taking at most its own excess.
    ``sup_binv`` maps each bucket to its superblock, ``deficit`` is per
    superblock.  Returns the new caps."""
    order = np.lexsort((-excess, sup_binv))
    se = np.maximum(excess[order], 0)
    sup_o = sup_binv[order]
    cs = np.cumsum(se) - se
    first_of_sup = np.searchsorted(
        sup_o, np.arange(n_sups, dtype=np.int64))
    before = cs - cs[first_of_sup[sup_o]]
    add_o = np.clip(deficit[sup_o] - before, 0, se)
    cap2 = cap.copy()
    cap2[order] += add_o
    return cap2


def values_dtype_name(values_dtype) -> str:
    """``"float32"`` or ``"bfloat16"`` for a value-stream type given as a
    NumPy dtype, a name, a torch dtype or JAX's ``jnp.bfloat16``; raises
    ``ValueError`` for any other type."""
    try:
        name = np.dtype(values_dtype).name
    except TypeError:
        name = getattr(values_dtype, "__name__", str(values_dtype))
    name = name.removeprefix("torch.")
    if name not in ("float32", "bfloat16"):
        raise ValueError(f"values_dtype {values_dtype!r}: the value stream "
                         f"is float32 or bfloat16")
    return name


def build(csr: CSRMatrix, split_rows: int | None = None,
          step_groups: int | None = None, cap_slack: int | None = None,
          cap_margin: float = 0.3, spill_rounds: int = 1,
          max_inflation: float = 64.0, sup: int | None = None,
          spill_beta: float | None = None,
          permute_rows: bool = False,
          pattern: bool = False,
          values_dtype=np.float32,
          t_base: int | None = None) -> HostPlan:
    """Pack a host CSR matrix into the window-ELL layout (port of
    ``WindowEllPlan.build``).

    ``sup=None`` picks the superblock height by the cost model
    (:func:`_choose_sup`) and escalates to wider superblocks when the
    chosen one trips a guard; raises :class:`WindowEllOverflow` when no
    layout fits.  ``spill_beta=None`` / ``cap_slack=None`` resolve to the
    per-height defaults (:func:`_auto_caps`).  ``values_dtype`` is float32
    or bfloat16 (:func:`values_dtype_name`); ``pattern=True`` builds a plan
    with no value stream, every stored nonzero acting as 1.0."""
    vdt = values_dtype_name(values_dtype)
    if sup is not None:
        slack = cap_slack if cap_slack is not None \
            else _auto_caps(sup)[1]
        return _build(
            csr, split_rows, step_groups, slack, cap_margin,
            spill_rounds, max_inflation, sup, spill_beta,
            permute_rows, pattern, t_base, vdt)
    start = _choose_sup(csr, split_rows=split_rows)
    err = None
    for s in SUP_LEVELS[SUP_LEVELS.index(start):]:
        # wide superblocks are shallow (cap ~1); without extra slack
        # the spill mass becomes per-row extras that blow the VMEM
        # extras table, so trade a little occupancy for bounded spills
        base = cap_slack if cap_slack is not None \
            else _auto_caps(s)[1]
        slack = max(base, 2) if s >= 4096 else base
        try:
            return _build(
                csr, split_rows, step_groups, slack, cap_margin,
                spill_rounds, max_inflation, s, spill_beta,
                permute_rows, pattern, t_base, vdt)
        except WindowEllOverflow as e:
            err = e
    raise err


def _bands_from_overflow(e: WindowEllOverflow) -> int:
    """Band count suggested by an overflow's sizing hints (0/1 = banding
    cannot help: inflation guard, or the x block alone blows VMEM)."""
    n_bands = 1
    if getattr(e, "needed_groups", 0):
        n_bands = max(n_bands, -(-int(e.needed_groups * 1.1)
                                 // int(MAX_GROUPS * 0.9)))
    if getattr(e, "vmem_var", 0):
        head = VMEM_BUDGET - getattr(e, "vmem_fixed", 0)
        if head <= 0:
            return 0
        n_bands = max(n_bands, -(-int(e.vmem_var * 1.15) // head))
    return n_bands


# ---- row-banded plans (guard-bounded scale) ----

# threads that build one round of bands at once (the port's own; the JAX
# planner builds them one by one, to the same plans)
BAND_WORKERS = min(os.cpu_count() or 1, 8)

@dataclasses.dataclass(frozen=True)
class HostBanded:
    """A row-banded stack of host plans (the JAX ``BandedPlan``,
    ``tpu_spmv/kernels/window_ell.py:1724-1795``): each band a complete
    plan over a slice of rows, padded with empty rows to a common height,
    and ``band_rows`` its real rows, so the outputs trimmed and joined in
    band order are ``y``."""

    plans: tuple             # HostPlan per band, in row order
    num_rows: int
    num_cols: int
    band_rows: tuple = ()

    @property
    def n_groups(self) -> int:
        return sum(p.n_groups for p in self.plans)

    @property
    def sup(self) -> int:
        return max(p.sup for p in self.plans)


def _slice_rows(csr: CSRMatrix, a: int, b: int,
                pad_to: int | None = None) -> CSRMatrix:
    """The row band ``[a, b)`` as an independent CSR (same cols),
    optionally padded with trailing EMPTY rows to ``pad_to`` rows."""
    lo, hi = int(csr.row_ptrs[a]), int(csr.row_ptrs[b])
    h = b - a
    n = max(pad_to or h, h)
    ptr = np.empty(n + 1, np.int32)
    ptr[:h + 1] = (csr.row_ptrs[a:b + 1].astype(np.int64)
                   - lo).astype(np.int32)
    ptr[h + 1:] = ptr[h]
    return CSRMatrix(n, csr.num_cols, csr.values[lo:hi],
                     csr.col_indices[lo:hi], ptr)


def build_banded(csr: CSRMatrix, sup: int, n_bands: int | None = None,
                 split_rows: int | None = None,
                 step_groups: int | None = None,
                 cap_slack: int | None = None,
                 spill_beta: float | None = None,
                 permute_rows: bool = False,
                 pattern: bool = False,
                 values_dtype=np.float32) -> HostBanded:
    """A :class:`HostBanded` at superblock height ``sup`` (port of the JAX
    ``build_banded``, ``window_ell.py:1828-1908``).

    ``n_bands=None`` sizes the bands adaptively: a first full-matrix
    attempt either fits (one band) or raises with sizing hints that give
    the split (:func:`_bands_from_overflow`).  Bands are cut at multiples
    of ``sup``, padded with empty rows to the tallest band's height (a
    band that the padding tips over a guard keeps its real height), and a
    band that still overflows a guard that banding relieves (``MAX_GROUPS``,
    the output and extras part of ``VMEM_BUDGET``) is halved, recursively.
    Raises :class:`WindowEllOverflow` when a one-superblock band does not
    fit, or a band trips the inflation guard (the JAX planner halves that
    one too, fault F7: its halves slip under the guard's absolute floor)."""
    kw = dict(split_rows=split_rows, step_groups=step_groups,
              cap_slack=cap_slack, spill_beta=spill_beta,
              permute_rows=permute_rows, pattern=pattern,
              values_dtype=values_dtype)

    def whole():
        return HostBanded((build(csr, sup=sup, **kw),), csr.num_rows,
                          csr.num_cols, (csr.num_rows,))

    if n_bands is None:
        try:
            return whole()
        except WindowEllOverflow as e:
            n_bands = _bands_from_overflow(e)
            if n_bands < 2:
                raise
    n_sups = -(-csr.num_rows // sup)
    n_bands = max(1, min(n_bands, n_sups))
    cuts = [min(csr.num_rows, sup * (n_sups * i // n_bands))
            for i in range(n_bands + 1)]
    todo = [(cuts[i], cuts[i + 1]) for i in range(n_bands)
            if cuts[i] < cuts[i + 1]]
    if not todo:
        return whole()        # zero rows: one empty band
    # the common band height (on the TPU, one compiled kernel variant)
    bh = max(b - a for a, b in todo)

    def attempt(ab):
        """The band's plan at the common height (at its real height where
        the padding tips it over a guard), or the overflow."""
        a, b = ab
        try:
            try:
                return build(_slice_rows(csr, a, b, pad_to=bh), sup=sup, **kw)
            except WindowEllOverflow:
                if b - a >= bh:
                    raise
                return build(_slice_rows(csr, a, b), sup=sup, **kw)
        except WindowEllOverflow as e:
            return e

    # each band's build depends on its rows alone, so the bands of a round
    # build at once (the planner's NumPy and native passes release the
    # GIL for most of their time); the plans are those built one by one
    built = {}
    with ThreadPoolExecutor(BAND_WORKERS) as pool:
        while todo:
            halves = []
            for (a, b), p in zip(todo, pool.map(attempt, todo)):
                if not isinstance(p, WindowEllOverflow):
                    built[a] = (p, b - a)
                    continue
                # halve only where banding can help (fault F7 of the JAX
                # planner, not carried over: it halves on any overflow, so
                # a band over the inflation guard is halved until its slots
                # slip under the guard's 4M-slot floor, hundreds of bands
                # at 64x the nonzeros or more)
                if b - a <= sup or _bands_from_overflow(p) < 2:
                    raise p
                mid = a + sup * (-(-(b - a) // sup) // 2)
                halves += [(a, mid), (mid, b)]
            todo = halves
    plans, band_rows = zip(*(built[a] for a in sorted(built)))
    assert sum(band_rows) == csr.num_rows
    return HostBanded(plans, csr.num_rows, csr.num_cols, band_rows)


def build_auto(csr: CSRMatrix, split_rows: int | None = None,
               step_groups: int | None = None,
               choice: tuple | None = None,
               permute_rows: bool | None = None,
               pattern: bool = False,
               values_dtype=np.float32) -> HostPlan | HostBanded:
    """The best packed layout for ``csr`` (port of the JAX ``build_auto``,
    ``window_ell.py:1928-2004``): a single plan where it fits, else a
    :class:`HostBanded` at the cost-model superblock, before escalating to
    wider superblocks.  Bands are pre-sized where the sampled model already
    puts the single plan over ``MAX_GROUPS``, and sized from the overflow's
    hints otherwise; a one-band result is its single plan.  Raises
    :class:`WindowEllOverflow` where no height fits.  Where a band trips
    the inflation guard, :func:`build_banded` does not halve it (fault F7
    of the JAX planner, which does), so the next height is tried."""
    if permute_rows is None:
        permute_rows = _permute_default()
    start, groups_est = choice if choice is not None \
        else _choose_sup(csr, with_groups=True, split_rows=split_rows)
    err = None
    for s in SUP_LEVELS[SUP_LEVELS.index(start):]:
        narrow = s == SUP_LEVELS[0]
        beta, slack = _auto_caps(s)
        kw = dict(split_rows=split_rows if narrow else None,
                  step_groups=step_groups, cap_slack=slack, spill_beta=beta,
                  permute_rows=permute_rows, pattern=pattern,
                  values_dtype=values_dtype)
        nb0 = 0
        if s == start and groups_est > MAX_GROUPS and csr.num_rows > s:
            # 1.25 margin: over-banding costs one more x read per band, an
            # under-banded attempt a rebuilt band
            nb0 = -(-int(groups_est * 1.25) // int(MAX_GROUPS * 0.9))
        try:
            if nb0 >= 2:
                bp = build_banded(csr, sup=s, n_bands=nb0, **kw)
                return bp if len(bp.plans) > 1 else bp.plans[0]
            return build(csr, sup=s, **kw)
        except WindowEllOverflow as e:
            err = e
            if nb0 >= 2:
                # the pre-sized bands bottomed out at one superblock: any
                # other band count fails the same way
                continue
            nb = _bands_from_overflow(e)
            if csr.num_rows <= s or nb < 2:
                continue  # banding cannot help at this height
            try:
                return build_banded(csr, sup=s, n_bands=nb, **kw)
            except WindowEllOverflow as e2:
                err = e2
    raise err


# ---- composite plans: cap-and-respill across levels (wide matrices) ----

@dataclasses.dataclass(frozen=True)
class HostComposite:
    """A stack of host plans plus a flat remainder (the JAX
    ``CompositePlan``, ``window_ell.py:1551-1598``): ``y = sum of the
    levels' outputs + the tail's flat SpMV``, in that order."""

    plans: tuple             # HostPlan per level
    tail: CSRMatrix | None   # the remainder, on the flat path
    num_rows: int
    num_cols: int


def _subset_csr(csr: CSRMatrix, rows_of: np.ndarray,
                mask: np.ndarray) -> CSRMatrix:
    """A same-shape CSR holding only the masked nonzeros."""
    rr = rows_of[mask]
    ptr = np.zeros(csr.num_rows + 1, np.int32)
    np.cumsum(np.bincount(rr, minlength=csr.num_rows), out=ptr[1:])
    return CSRMatrix(csr.num_rows, csr.num_cols, csr.values[mask],
                     csr.col_indices[mask], ptr)


def build_composite(csr: CSRMatrix, step_groups: int | None = None,
                    max_levels: int = 3, split_rows: int | None = None,
                    permute_rows: bool | None = None) -> HostComposite:
    """The multi-level composite layout (port of the JAX
    ``build_composite``, ``window_ell.py:1611-1702``).  Each level's
    superblock comes from the probe-free ranking on what is left; a narrow
    level keeps each cell's layers up to its bucket's margin cap, a wide one
    the first layer of every cell, and the rest goes on to the next level.
    The final level (the last allowed, a narrow level after the first, or
    under 65,536 nonzeros) takes the rest with the full split and spill
    machinery; what no level takes is the flat tail.  The levels keep f32
    values."""
    if permute_rows is None:
        permute_rows = _permute_default()
    plans = []
    nr, nc = csr.num_rows, csr.num_cols
    n_windows = _bucket(max(nc, 1)) // WINDOW

    def coords_csr(r, c32, v):
        ptr = np.zeros(nr + 1, np.int64)
        np.cumsum(np.bincount(r, minlength=nr), out=ptr[1:])
        return CSRMatrix(nr, nc, v, c32, ptr)

    r = np.repeat(np.arange(nr, dtype=np.int64),
                  np.diff(csr.row_ptrs).astype(np.int64))
    c64 = csr.col_indices.astype(np.int64)
    c32, v = csr.col_indices, csr.values
    done = False
    for lvl in range(max_levels):
        s = _rank_sups(r, c64, nr, nc)[0][0]
        narrow = s == SUP_LEVELS[0]
        if lvl == max_levels - 1 or (narrow and lvl > 0) \
                or len(r) < (1 << 16):
            try:
                plans.append(build(coords_csr(r, c32, v),
                                   split_rows=split_rows,
                                   step_groups=step_groups,
                                   permute_rows=permute_rows))
                done = True
            except WindowEllOverflow:
                pass                  # the remainder goes to the flat tail
            break
        cell = (((r // s) * n_windows + c64 // WINDOW) * (CHUNKS * LANE)
                + ((c64 // LANE) % CHUNKS) * LANE + r % LANE)
        layer = _cumcount(cell)
        if narrow:
            _, binv, bcnt = _unique_ic(cell // (CHUNKS * LANE))
            cap = np.maximum(
                -(-(bcnt + (bcnt * 0.3).astype(np.int64))
                  // (CHUNKS * LANE)),
                -(-bcnt // (CHUNKS * LANE)))
            keep = layer < cap[binv]
        else:
            keep = layer < 1
        try:
            plans.append(build(coords_csr(r[keep], c32[keep], v[keep]),
                               split_rows=None, step_groups=step_groups,
                               sup=s, cap_slack=8 if narrow else 2,
                               permute_rows=permute_rows))
        except WindowEllOverflow:
            break                     # the whole remainder to the flat tail
        spill = ~keep
        if not spill.any():
            done = True
            break
        r, c64, c32, v = r[spill], c64[spill], c32[spill], v[spill]
    if not plans:
        raise WindowEllOverflow("no composite level packs this structure")
    tail = None if done or not len(r) else coords_csr(r, c32, v)
    return HostComposite(tuple(plans), tail, nr, nc)
