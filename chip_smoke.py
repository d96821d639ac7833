"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each raises on failure; nothing is caught and passed over):

1. Device: the card's name and power limit (``nvidia-smi``).
2. Build: the host planner library and the CUDA kernels, from the sources
   in this checkout.
3. Kernels against their plain PyTorch versions on the card: the
   window-ELL fold (K1: the chunked fold, and after each section the
   section epilogue, which sums a superblock cut into several chunks and
   publishes the extras totals) over plans of the bench's
   smoke matrix at every superblock height and run length, natural and
   leveled, in each of its three variants: f32 values, bf16 values, and
   none (pattern plans: the nibble-15 sentinel at superblock height 1024,
   -1 at 4096 and 16384), the bf16 and pattern plans merge-path with
   extras sections that publish; the unpermute (K2) on a random ``lam``.
4. The public chunk permute (K3's kernel, which every SpMV runs as its
   gather table's set-up) against its plain version, exactly: x not a
   whole number of chunks nor of float4s, ``src`` with repeats and chunks
   past the end of x, an output ending mid-chunk, a pointer that is not
   16-byte aligned, and a round trip (order, then its inverse) that gives x
   back bit for bit.
5. The benchmark probes' ports (``tpu_spmv_torch/probes``: P4 the stage
   split of K1, P2 and P3 the scatter candidates, P5 the block re-read, P1
   the round-2 inner-loop candidates, its table-in-output modes defined on
   head rows seeded with x2d):
   every mode of each probe's kernel against its plain version at a reduced
   size (fp32 sums in another order, and in P1 and P2 atomic adds in no
   fixed order: ``|Δ| <= 1e-5 * (|ref| + max|ref|)``; P3's modes and P2's
   ``w128``, run-ordered, bit for bit against their plain versions and
   their CPU twins, and twice bit-identical), S = 24 refused by P1, P2 and
   P3 (``ValueError``); then the probes' entry point, each probe's
   ``time_modes`` at its JAX main's default size (P4 at S = 128 only),
   printing the JAX scripts' lines under the physics guard, with the launch
   counts from 0; then each mode against its plain version (and CPU twin)
   at that size, timed beside it, with its share of the bound.
6. The main path at the headline size: merge-path ``spmv_csr`` on
   ``power_law_csr(262144, 4096, avg 40, alpha 1.6)`` (about 10.3M nnz)
   with the auto-selected configuration, checked against the CPU oracle,
   timed with CUDA events, and held to the physics guard (streamed bytes /
   time must not exceed 1.02 × measured STREAM).  Each kernel is then
   compared with, and timed beside, its plain version at the plan's shapes
   (the gather table's set-up, K3 in order, exactly; K1 held whole under
   the row bound and bit for bit across two calls, and timed as the SpMV
   runs it, ``fold_sections``; its section epilogue on random partial
   tiles of the non-last section with the most, the table's tail
   included, and K2, with random partial tiles of the last section where
   it splits, exactly).  Each path prints its fold schedule before and
   after chunking and checks one table set-up per call, one fold launch
   per section, one section epilogue per section but the last and one K2
   per call (wherever the plan is leveled or its last section splits).
   Vector CSR (no row split) runs once against the oracle too.
   Then the headline through the JAX bench's two levers (``bench.py:332-375``):
   a bf16 value stream (``bf16_values=True``, held to the oracle at 8e-3,
   the value rounding), and the pattern fast path on a column-scaled matrix
   of the headline's structure (``pattern=True``, at 1e-5); each measured,
   counted, held to the guard, and its fold held to its plain version.
7. The block-reordered path at full width: ``spmv_csr`` with the auto
   configuration (``reorder=None``: the probe decides) on
   ``scrambled_banded_csr(2^20, bandwidth 4096, avg 12)`` (about 13.5M nnz,
   a 2^20-node mesh), which must be served by a ``ReorderedPlan``, checked
   against the oracle and, bit for bit, against the old composition
   (``permute_chunks`` of x, the inner SpMV, ``permute_chunks`` of its
   rows), timed, held to the physics guard with the set-up's and the tile
   map's bytes, and counted: one K3 (the table's set-up, which gathers x's
   chunks in the plan's order), one K1 per inner section, one section
   epilogue per inner section but the last and one K2 (which writes the
   rows back in natural order through the tile map) per call.  Each kernel
   of the path is then compared with, and timed beside, its plain version
   on the inputs the path gives it; the public ``permute_chunks`` of x is
   timed beside ``index_select``.
8. Natural against reordered at 131,072 rows, on the planted banded and
   clustered matrices: both plans timed (natural, reordered, reordered,
   natural) and checked against the oracle, and each plan's kernels against
   their plain versions.  A comparison, not a claim.
9. PageRank at full width: the JAX bench's 262,144-node web graph
   (``bench.py:279-306``), column-normalised, through ``pagerank`` for 30
   iterations at tolerance 0 after one warm-up run.  It must run on a
   pattern plan at superblock height 4096 with one K1 (pattern variant)
   launch per section, one section epilogue per section but the last and
   one K2 launch per iteration (it sums the last section's split
   superblocks), and match a float64 power iteration on the host (``rtol
   1e-4, atol 1e-7``, ``|Σr - 1| < 1e-4``, and at ``atol 1e-9``, which a
   bf16-rounded table fails); K1 and K2 are held to their plain versions
   on its inputs, x the ranks times n so that every row's bound is set by
   its own values and not by the bound's floor.  The time per iteration
   is printed over the call.  Then a run at the default tolerance reports
   its iterations.

10. Row-banded plans at full width: the 2^20 mesh of phase 7 with
    ``reorder=False`` (its natural arm) and the 1M-node web graph
    (``bench.py:265-272``) through the auto configuration, each served by a
    ``BandedPlan`` of two bands or more (the v5e guards the planner keeps,
    ``MAX_GROUPS``, band them), checked against the oracle, measured,
    counted (per band one table set-up, its folds and epilogues; the join)
    and held to the physics guard; each band's kernels against their plain
    versions; the natural mesh timed in turns with the reordered one.
11. PageRank at 1M nodes: that web graph column-normalised, 30 iterations
    at tolerance 0 after a warm-up run on the pattern-banded route, held to
    a float64 power iteration by phase 9's rule, the ms per iteration over
    CUDA events and wall clock, the launches per iteration, and its SpMV
    alone over CUDA events; each band's kernels against their plain
    versions.
12. Past one gather table: a 1M x 4M web graph on column strips (four, one
    of them banded), the headline's rows and row-length law with 1.5M
    columns on a composite plan (its levels, and a flat tail where one is
    left), each through the auto configuration, checked, measured, counted,
    and each plan's kernels against their plain versions; and a 1.5M-node
    web graph, which no composite level packs under the v5e guards the
    planner keeps, on the flat path, as the JAX dispatch routes it.
13. The floors on the headline: SCALAR_CSR (its naive plan, no extras, or
    the flat path where that overflows) and ELL_KERNEL on a CSR (the flat
    path: gather, multiply, ``segment_reduce``), each against the oracle,
    bit-identical across two calls, timed; the flat path beside cuSPARSE.

14. The ELL path, plan files, autotune, the harness and the demo: the
    JAX bench's 5-point stencil (``bench.py:226-245``) through ``spmv_ell``
    at grid sides 512 and 1024 (one window-ELL plan each), 1448 (column
    strips) and 2048 (the slot-major flat ELL path), the JAX rule's four
    routes, and the 1024 stencil column-scaled (``RandomGenerator(7)``,
    uniform in [0.5, 2)) on the pattern route; each measured, counted,
    held to ``spmv_cpu_ell`` at the row bound and to the physics guard,
    bit-identical across two calls, timed in turns with cuSPARSE on the
    same CSR, and each window-ELL plan's kernels held to their plain
    versions.  Then the headline's plan and the mesh's reordered plan saved
    with ``save_plan`` and loaded onto the card with ``load_plan``, output
    bit-identical, the save and load seconds beside the build's; autotune
    on the headline at step widths 128 and 384; ``benchmark_csr`` and
    ``compare_gpu_cpu_csr`` on the headline and ``benchmark_ell`` on the
    1024 stencil, each ``correct``, their reference JSON printed; and
    ``python -m tpu_spmv_torch.cli --json`` as a subprocess, which must
    exit 0 with every ``correct`` true.

15. The multi-device layer (``tpu_spmv_torch.parallel``) on 4 shards, all
    on the one card (``make_row_mesh(4, devices=["cuda:0"] * 4)``), at its
    own benchmark's size (``benchmarks/scaling.py:27-29``: 262,144 rows,
    4,096 columns, power-law rows averaging 16 nonzeros): the flat sharded
    path, replicated-packed shards in f32, bf16, on the pattern path (the
    matrix's column-scaled twin, ``scaling.py:148-152``) and leveled
    (``permute_rows=True``), and the ring on ``--structure local``'s banded
    row locality, its ``ring_traffic_report`` printed.  Each is held to the
    CPU oracle on the unpartitioned matrix, bit-identical across two
    calls, its launches counted from 0 (each shard plan's
    ``launches_per_call``), and timed over CUDA events (flat and f32 in
    turns with the single plan the dispatch serves for the matrix), with
    its plan seconds (``chip_profile.py --cells sharded`` traces the
    device time and idle share of the same cells); shard 0's kernels against their plain versions (f32 and
    pattern).  The packed SpMV through a process group of world size 1 on
    NCCL must equal the local one-shard mesh's bit for bit.
    ``pagerank_sharded`` over packed and pattern shards of phase 9's web
    graph runs 30 iterations at tolerance 0, held to phase 9's float64
    check, and ``pagerank_step_sharded`` on the flat form to a float64
    step.  Four shards on one card measure the cost of sharding, not the
    exchange between cards nor scaling.

16. The differential soak (``python -m tpu_spmv_torch.soak``) on the card:
    ``SOAK_TRIALS`` randomized matrices of seven structure classes at a
    fixed seed through every dispatch path and, every 5th trial, the flat
    and packed sharded paths on a 4-shard mesh of the one card, each held
    to the CPU oracle; no path may fail, and each of K1's variants, its
    section epilogue, K2 and K3 must launch (counts from 0 around the
    soak).  Then one plan per lever group of the JAX fuzz slice
    (``tests/test_fuzz.py``: run length, step widths 128 and 40, spill
    beta with the balancer's windows, bypass and L2 balance, leveling,
    pattern, bf16, bands; ``soak.LEVER_CASES``) through the card's SpMV
    against the oracle, and its kernels against their plain versions.

17. The port's headline benchmark as a user runs it: ``python3 -m
    tpu_spmv_torch.bench`` in a subprocess at full size (``bench.py``'s
    flow: the candidates, the oracle, STREAM, the guarded sweep, the flat
    path, the 512^2 stencil, the 1M-node web graph, PageRank at 262,144
    nodes, bf16 and pattern, the late re-measure).  It must exit 0; its
    line, printed, must have ``bench.py``'s keys and ``device`` and
    ``plan_build_s``, ``correct`` true, a fingerprinted winner, every
    secondary positive, and the winner's streamed GB/s within 1.02 x its
    STREAM.
18. The device benchmarks' mains in this process, on the card:
    ``scaling`` (its defaults: one row on one card, which prices no
    scaling), ``perf_properties`` (its defaults) and ``tune --quick``;
    each JSON names the card and every ``correct`` in it is true.

The phases run in the order 1-6, 13, 14, 7, 14's mesh plan file, 10, 9,
11, 12, 8, 15, 16, 17, 18, each new matrix made once and dropped when its
phases end; each phase's seconds are printed after it.

Where one PyTorch call computes what a kernel computes, it is timed beside
it and printed on a ``library:`` line (cuSPARSE through a sparse CSR tensor
for K1 and K2 together, ``index_add_`` of the partial tiles for the section
epilogue, ``take_along_dim`` for K2, ``torch.take`` over the composed row
index for K2 with a tile map, ``torch.nn.functional.pad`` for the table's
set-up in order, ``index_select`` for it through a chunk map and for the
public permute); the port never calls them.  Each kernel's bound is the
least time the card could take for its work: its bytes (each input read
once, each output written once; for the epilogues the bytes this run's
split tiles need, as ``epilogue_work`` and ``k2_work`` count them; for the
table's set-up x and the chunk map read, as ``setup_bytes`` counts them
for the plan's byte model, and the table written) over the STREAM rate
measured in this run, or its fp32 operations over the 67 TFLOP/s fp32
peak, whichever is larger.  Every time is taken with
``tpu_spmv_torch.timing`` (CUDA events).

Everything before the last line is diagnostics.  The line before the
``nvidia-smi`` line is one JSON object with a record per kernel (K1's f32
variant, K1's section epilogue, K2, K3 as the mesh's table set-up, the
probes P4, P2, P3, P5, K1's
bf16 and pattern variants, P1); the last line is ``{"ok": true, "device":
{...}}``.  Exits non-zero, and prints no result, where no CUDA device is
available.  Imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
import warnings

# the main path's matrix (bench.py:74-75) and its oracle tolerance
HEADLINE = (262144, 4096, 40.0, 1.6)
SMOKE = (8192, 2048, 12.0, 1.6)
# the reordered path's matrix: a scrambled 2^20-node mesh (the size of
# DIMACS10 delaunay_n20), the widest square matrix the single-plan dispatch
# takes (VMEM_X_MAX_COLS)
MESH = (1 << 20, 4096, 12.0)
# natural against reordered at 131,072 rows, a size that keeps the whole
# script within its time: (generator, args)
AB = (("scrambled_banded_csr", (131072, 4096, 12.0)),
      ("clustered_csr", (131072, 32, 14.0)))
# the stacked routes' matrices, none of them cut: the 1M-node web graph
# (bench.py:265's secondary metric, and PageRank at 1M nodes); a 1M x 4M
# web graph (past PACKED_MAX_COLS: column strips); the headline's rows and
# row-length law with 1.5M columns (x past one gather table: the
# composite); a 1.5M-node web graph, which no composite level packs under
# the v5e guards the planner keeps (MAX_GROUPS at sup 1024, inflation at
# 4096), so both packages serve it on the flat path
WEB = (1_000_000, 1_000_000, 15.0)
WIDE = (1 << 20, 1 << 22, 15.0)
COMPOSITE = (262144, 1_500_000, 40.0, 1.6)
WEB_1_5M = (1_500_000, 1_500_000, 15.0)
REL_TOL = 1e-5
# phase 14: the 5-point stencil's grid sides (bench.py:226-245), one per ELL
# route of the JAX rule: one window-ELL plan (512, the JAX bench's own cell,
# and 1024, at VMEM_X_MAX_COLS rows and columns), column strips (1448: past
# one gather table, within PACKED_MAX_COLS), the flat ELL path (2048: past
# PACKED_MAX_COLS); the pattern stencil at 1024
STENCILS = (512, 1024, 1448, 2048)
PATTERN_STENCIL = 1024
# the plans' build seconds (host planner and upload) as the main path
# resolved them, beside phase 14's save and load seconds
BUILD_SECONDS = {}
BF16_TOL = 8e-3     # bf16 value rounding (bench.py:337)
# PageRank: the JAX bench's web graph (bench.py:291) and its iterations
PAGERANK = (262144, 15.0)
PR_ITERS = 30
PR_RTOL, PR_ATOL = 1e-4, 1e-7
# the same check at an absolute tolerance a bf16-rounded table fails (the
# ranks are about 1/n = 3.8e-6)
PR_ATOL_TIGHT = 1e-9
# phase 15: the multi-device layer at its own benchmark's size
# (benchmarks/scaling.py:27-29, 84: power-law rows averaging 16 nonzeros,
# alpha 1.6, min(rows, 4096) columns), 4 shards, all on the one card; the
# timing of a sharded call beside the single plan's
SHARDED = (262144, 4096, 16.0, 1.6)
SHARDS = 4
SHARD_ITERS = 50
# phase 16: the differential soak's trials and seed on the card (about a
# minute), and the fuzz slice's lever groups
SOAK_TRIALS, SOAK_SEED = 60, 1
# the fp32 peak outside the tensor cores (NVIDIA's H100 SXM data sheet), the
# operations side of a kernel's bound
FP32_PEAK_FLOPS = 67e12
# timing protocol of the main-path run (spmv_csr measure=True)
ITERS, SAMPLES = 100, 5
PLAIN_ITERS = 10
# the probes: make_inputs keywords of the reduced size every mode is held
# at, the tolerance, and the timed run at the default sizes
PROBE_SMALL = {"profile_kernel": dict(n_steps=8, S=32, n_sup=4),
               "proto_v3": dict(n_steps=4, S=32, out8=512),
               "proto_v4": dict(n_steps=4, S=32, out8=1024),
               "profile_dma_share": dict(n_blocks=16, S=32, n_out=4),
               "proto_v2": dict(n_steps=4, S=32, out8=256)}
PROBE_RTOL = 1e-5
PROBE_ITERS, PROBE_SAMPLES = 20, 2
# each probe's kernel source and the Pallas probe it replaces
PROBE_SOURCES = {
    "profile_kernel": ("probe_profile_kernel.cu",
                       "benchmarks/profile_kernel.py:32"),
    "proto_v3": ("probe_proto_v3.cu", "benchmarks/proto_v3.py:51"),
    "proto_v4": ("probe_proto_v4.cu", "benchmarks/proto_v4.py:42"),
    "profile_dma_share": ("probe_dma_share.cu",
                          "benchmarks/profile_dma_share.py:25"),
    "proto_v2": ("probe_proto_v2.cu", "benchmarks/proto_v2.py:34")}


def log(*args) -> None:
    print(*args, flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip smoke failed: {what}")


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def max_row_excess(y, y_ref, A, x) -> float:
    """max over rows of |y - y_ref| - 1e-5·max((|A||x|)_i, 1): <= 0 when
    every row is within the bound."""
    import numpy as np

    from tpu_spmv_torch.utils.testing import abs_row_scale

    diff = np.abs(np.asarray(y, np.float32) - np.asarray(y_ref, np.float32))
    return float(np.max(diff - REL_TOL * np.maximum(abs_row_scale(A, x), 1)))


def rows_of(out, plan):
    """The original-order rows of a fold output, through the plain
    unpermute (and, for a reordered plan, the plain row permute)."""
    from tpu_spmv_torch.kernels.reorder import (ReorderedPlan,
                                                permute_chunks_plain)
    from tpu_spmv_torch.kernels.window_ell import unpermute_plain
    from tpu_spmv_torch.spmv import PatternPlan

    rp = plan if isinstance(plan, ReorderedPlan) else None
    inner = rp.inner if rp else plan.plan if isinstance(plan, PatternPlan) \
        else plan
    y = out[:inner.num_rows] if inner.lam is None \
        else unpermute_plain(out, inner.lam, inner.num_rows)
    if rp:
        y = permute_chunks_plain(y, rp.row_src, rp.num_rows)
    return y.cpu().numpy()


def bound(nbytes: float, ops: float, stream_gbs: float) -> tuple:
    """``(ms, "bytes" or "operations")``: the least time the card could take
    for a kernel's work, the larger of its bytes over the STREAM rate of
    this run and its fp32 operations over the fp32 peak."""
    t_bytes = nbytes / (stream_gbs * 1e9) * 1e3
    t_ops = ops / FP32_PEAK_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def fold_geometry(plan) -> list:
    """Per fold section of a window-ELL plan, its schedule before and after
    chunking: output superblocks (one CTA each before) and the most runs
    of one, then chunks (one CTA each now), split superblocks and the most
    runs of one chunk."""
    import numpy as np

    base = plan.base.cpu().numpy()
    out = []
    for sec in plan.sections:
        ro = sec.run_order.cpu().numpy()
        _, per_sup = np.unique(base[ro], return_counts=True)
        out.append({"runs": len(ro), "superblocks": sec.n_sup,
                    "max_runs_per_superblock": int(per_sup.max()),
                    "chunks": sec.n_chunks, "split": sec.n_split,
                    "max_runs_per_chunk": sec.max_runs})
    return out


def epilogue_launches(plan) -> tuple:
    """Per SpMV call of a window-ELL plan, ``(section epilogues, K2)``: one
    section epilogue after each section but the last, and one K2 wherever
    the plan is leveled or its last section split a superblock."""
    return (len(plan.sections) - 1,
            int(plan.lam is not None or plan.sections[-1].n_split > 0))


def epilogue_work(plan, sec) -> tuple:
    """``(bytes, operations)`` the section epilogue of ``sec`` must do:
    the section's partial tiles read and summed, its split superblocks'
    output tiles written; the extras region written to the table's tail,
    and read from the output only on the tiles that no split superblock
    of the section owns (a split tile is written from its partial tiles);
    the tile map's entries of the extras region and the split ranges
    read."""
    import numpy as np

    e0 = plan.extras_base // 128
    n_extras = plan.out8 - e0
    n_tb = plan.sup // 128
    unsplit = int(np.count_nonzero(sec.split_of_tile[e0:].cpu().numpy() < 0))
    tiles = (sec.n_slots + sec.n_split) * n_tb + n_extras + unsplit
    return (tiles * 128 * 4.0 + (n_extras + 2 * sec.n_split + 1) * 4.0,
            float(sec.n_slots * plan.sup))


def k2_work(plan, sec, n: int | None = None, tile_src=None) -> tuple:
    """``(bytes, operations)`` K2 must do for ``n`` output rows (default
    the plan's) with the last section ``sec`` (None: no split tiles) and
    the tile map ``tile_src`` (None: the identity): per output tile, its
    ``tile_src`` entry read; per output row, its value written, its
    ``lam`` entry read on a leveled plan, and its source read, one value
    of ``y`` where no split superblock owns the row's source tile (none
    past ``y``'s end), else one value of each of that superblock's partial
    tiles, summed (a split tile's rows never read ``y``); with split
    tiles, the split map's entries of the source tiles and the split
    ranges."""
    import numpy as np

    n = plan.num_rows if n is None else n
    tiles = -(-n // 128)
    rows = np.full(tiles, 128, np.int64)
    rows[-1] = n - 128 * (tiles - 1)
    src = np.arange(tiles) if tile_src is None \
        else tile_src[:tiles].cpu().numpy().astype(np.int64)
    inside = (src >= 0) & (src < plan.out8)
    reads = np.where(inside, rows, 0)
    summed = 0
    index = 0 if tile_src is None else tiles
    if sec is not None and sec.n_split:
        owner = np.full(tiles, -1, np.int64)
        owner[inside] = sec.split_of_tile.cpu().numpy()[src[inside]]
        chunks = np.diff(sec.split_ptr.cpu().numpy())
        split = owner >= 0
        reads[split] = rows[split] * chunks[owner[split]]
        summed = int(reads[split].sum())
        index += tiles + 2 * sec.n_split + 1
    lam = n if plan.lam is not None else 0
    return 4.0 * (n + lam + int(reads.sum()) + index), float(summed)


def setup_work(plan, n_x: int, src) -> float:
    """Bytes the gather table's set-up must move: x and the chunk map
    ``src`` (None: in order) read once, as ``setup_bytes`` counts them for
    the plan's byte model, and the table written once."""
    from tpu_spmv_torch.kernels.window_ell import setup_bytes

    n_table = plan.cols_pad + plan.e8 * 128
    return float(setup_bytes(n_x, 0 if src is None else src.numel())
                 + 4 * n_table)


def cusparse(A, dev):
    """``A`` as a PyTorch sparse CSR tensor on ``dev``: ``M @ x`` is one
    cuSPARSE SpMV, the library call that computes what K1 and K2 compute
    together (timed beside them; the port never calls it)."""
    import torch

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return torch.sparse_csr_tensor(
            torch.from_numpy(A.row_ptrs).to(dev),
            torch.from_numpy(A.col_indices).to(dev),
            torch.from_numpy(A.values).to(dev),
            size=(A.num_rows, A.num_cols), check_invariants=False)


def hold_kernels(plan, xd, A, x, what: str, timed: bool,
                 stream: float | None = None) -> dict:
    """Each kernel of ``plan`` against its plain version on the inputs the
    path gives it: the gather table's set-up (K3: for a reordered plan
    through ``col_src``, else in order), the (inner) plan's fold (K1, under
    the row bound), its section epilogue and K2 (with the last section's
    partial tiles where it splits, and for a reordered plan through
    ``row_src`` as its tile map); K3 and the epilogues exactly.  A pattern
    plan's table is set up from the scaled x, as ``spmv_pattern`` feeds it.
    With ``timed``, each is timed beside its plain version and its library
    call (``torch.nn.functional.pad`` for the set-up in order,
    ``index_select`` of x's chunks, precomputed zero-padded, through it;
    cuSPARSE on ``A`` for the fold, which must match the oracle;
    ``index_add_`` of the partial tiles for the section epilogue;
    ``take_along_dim`` for K2, ``torch.take`` through the precomputed
    composed row index with a tile map), and its bound over ``stream``
    (GB/s) printed beside.  K1 is held whole
    (``window_ell_fold``) and timed as the SpMV runs it
    (``fold_sections``: the folds and the section epilogues after each
    section but the last).  Returns ``{kernel record name: [{"err", "ms",
    "plain_ms", "library_ms", "nbytes", "ops"}, ...]}`` in path order; the
    times are ``None`` untimed."""
    import torch
    import torch.nn.functional as F

    from tpu_spmv_torch.kernels import FOLD_VARIANTS
    from tpu_spmv_torch.kernels import reorder as tr
    from tpu_spmv_torch.kernels import window_ell as twe
    from tpu_spmv_torch.spmv import PatternPlan
    from tpu_spmv_torch.timing import time_cuda, time_turns
    from tpu_spmv_torch.utils.testing import spmv_matches

    rp = plan if isinstance(plan, tr.ReorderedPlan) else None
    pp = plan if isinstance(plan, PatternPlan) else None
    inner = rp.inner if rp else pp.plan if pp else plan
    dev = xd.device
    held, parts = {}, []

    def hold(name, kernel, plain, *args, nbytes, ops=0.0, library=None,
             exact=True, plain_iters=ITERS, kw=None, timed_as=None):
        # timed_as: the (kernel, plain version) calls to time, where they
        # are not the calls held
        kw = kw or {}
        got, ref = kernel(*args, **kw), plain(*args, **kw)
        torch.cuda.synchronize()
        check(not exact or torch.equal(got, ref),
              f"{name} differs from its plain version ({what})")
        rec = {"err": float((got - ref).abs().max()) if got.numel() else 0.0,
               "ms": None, "plain_ms": None, "library_ms": None,
               "nbytes": nbytes, "ops": ops}
        if timed:
            run, run_plain = timed_as or (lambda: kernel(*args, **kw),
                                          lambda: plain(*args, **kw))
            # the kernel's wrapper and its library call in turns
            times = time_turns([run] + ([library] if library else []),
                               iters=ITERS, samples=SAMPLES)
            rec["ms"] = times[0] * 1e3
            if library:
                rec["library_ms"] = times[1] * 1e3
            rec["plain_ms"] = time_cuda(run_plain, iters=plain_iters,
                                        samples=SAMPLES, warmup=2) * 1e3
        held.setdefault(name, []).append(rec)
        parts.append(f"{name} max|Δ| {rec['err']:.3g}" + (
            f" {rec['ms'] * 1e3:.2f} us (plain {rec['plain_ms'] * 1e3:.2f} "
            f"us" + ("" if rec["library_ms"] is None else
                     f", library {rec['library_ms'] * 1e3:.2f} us")
            + ("" if stream is None else
               f", bound {bound(nbytes, ops, stream)[0] * 1e3:.2f} us")
            + ")" if timed else ""))
        return got, ref

    xin = pp.scale * xd if pp else xd
    src = rp.col_src if rp else None
    n_table = inner.cols_pad + inner.e8 * 128
    if src is None:
        pad = n_table - xin.numel()
        library = lambda: F.pad(xin, (0, pad))  # noqa: E731
    else:
        # x's chunks and one zero chunk; each table chunk's source
        n_src = -(-xin.numel() // 128)
        x2d = torch.zeros(n_src + 1, 128, device=dev)
        x2d.view(-1)[:xin.numel()] = xin
        idx = torch.full((n_table // 128,), n_src, dtype=torch.long,
                         device=dev)
        idx[:src.numel()] = src.long()
        library = lambda: x2d.index_select(0, idx)  # noqa: E731
    table, _ = hold("permute_chunks", twe.gather_table,
                    twe.gather_table_plain, inner, xin, src,
                    nbytes=setup_work(inner, xin.numel(), src),
                    library=library)
    # the plan's byte model less its K2 part (stream_bytes)
    k2_model = 0 if inner.lam is None else inner.lam.numel() * 12
    live_slots = sum(s.run_order.numel() for s in inner.sections) \
        * inner.tb * 8 * 128
    M = cusparse(A, xd.device) if timed else None
    fold = FOLD_VARIANTS[inner.values]
    # the timed calls publish into tables of their own
    fold_tables = table.clone(), table.clone()
    out, ref = hold(fold, twe.window_ell_fold, twe.window_ell_fold_plain,
                    inner, table, nbytes=inner.stream_bytes - k2_model,
                    ops=2.0 * live_slots,
                    library=None if M is None else lambda: M @ xd,
                    exact=False, plain_iters=PLAIN_ITERS,
                    timed_as=(lambda: twe.fold_sections(inner,
                                                        fold_tables[0]),
                              lambda: twe.fold_sections(inner, fold_tables[1],
                                                        plain=True)))
    exc = max_row_excess(rows_of(out, plan), rows_of(ref, plan), A, x)
    check(exc <= 0, f"K1 vs its plain version, row bound ({what})")
    again = twe.window_ell_fold(inner, table)
    check(torch.equal(out, again),
          f"K1 is not bit-identical across two calls ({what})")
    parts.append("K1 bit-identical across two calls")
    # the epilogues on random partial tiles (the fold's own stay inside its
    # call): the same sums in the same order, so exactly
    g = torch.Generator(device=dev).manual_seed(5)

    def tiles(sec):
        return torch.randn(max(sec.n_slots, 1), inner.sup, generator=g,
                           device=dev)

    if len(inner.sections) > 1:
        # the section epilogue of the non-last section with the most
        # partial tiles, on a random output, publishing into a copy of the
        # gather table (the kernel called as the path calls it; the plain
        # version into copies of its own); the same tail on both sides too
        sec = max(inner.sections[:-1], key=lambda s: s.n_slots)
        partial = tiles(sec)
        fill = torch.randn(inner.out8 * 128, generator=g, device=dev)
        out_k, table_k = fill.clone(), table.clone()
        out_p, table_p = fill.clone(), table.clone()
        nbytes, ops = epilogue_work(inner, sec)
        library = None
        if sec.n_split:
            ptr = sec.split_ptr.long()
            seg = torch.repeat_interleave(
                torch.arange(sec.n_split, device=dev), ptr[1:] - ptr[:-1])
            sums = torch.zeros(sec.n_split, inner.sup, device=dev)
            library = lambda: sums.index_add_(0, seg, partial)  # noqa: E731
        hold("section_epilogue", twe.section_epilogue,
             lambda p, s, *_: twe.section_epilogue_plain(
                 p, s, out_p, table_p, inner.extras_base),
             partial, sec, out_k, table_k, inner.extras_base,
             nbytes=nbytes, ops=ops, library=library,
             plain_iters=PLAIN_ITERS)
        check(torch.equal(table_k, table_p),
              f"the section epilogue's table differs from its plain "
              f"version's ({what})")
    if M is not None:
        check(spmv_matches((M @ xd).cpu().numpy(), A, x, rel_tol=REL_TOL),
              f"the library call (cuSPARSE) vs the oracle ({what})")
    # a plan with no nonzeros (an empty band) has no section
    last = inner.sections[-1] if inner.sections else None
    if inner.lam is not None or (last and last.n_split) or rp:
        # K2, with the last section's partial tiles where it splits, and a
        # reordered plan's row map
        kw = {}
        if last and last.n_split:
            kw = {"partial": tiles(last), "sec": last}
        n = rp.num_rows if rp else inner.num_rows
        library = None
        if rp:
            kw["tile_src"] = rp.row_src
            rows = torch.arange(n, device=dev)
            t = rp.row_src.long()[rows >> 7] * 128
            lane = rows & 127
            flat = t + (lane if inner.lam is None
                        else inner.lam.view(-1).long()[t + lane])
            library = lambda: torch.take(out, flat)  # noqa: E731
        elif inner.lam is not None:
            yp = twe._pad_tiles(out, inner.lam.shape[0])
            lam64 = inner.lam.long()
            library = lambda: torch.take_along_dim(yp, lam64, 1)  # noqa: E731
        nbytes, ops = k2_work(inner, kw.get("sec"), n, kw.get("tile_src"))
        hold("unpermute", twe.unpermute, twe.unpermute_plain, out,
             inner.lam, n, nbytes=nbytes, ops=ops, library=library, kw=kw)
    log(f"kernels vs plain, {what}: K1 row-bound excess {exc:.3g}; "
        + "; ".join(parts))
    return held


# each kernel record's source and the TPU kernel it replaces
KERNEL_SOURCES = {
    "window_ell_fold": ("window_ell.cu",
                        "tpu_spmv/kernels/window_ell.py:1313"),
    "window_ell_fold_bf16": ("window_ell.cu",
                             "tpu_spmv/kernels/window_ell.py:1313"),
    "window_ell_fold_pattern": ("window_ell.cu",
                                "tpu_spmv/kernels/window_ell.py:1313"),
    "section_epilogue": ("window_ell.cu",
                         "tpu_spmv/kernels/window_ell.py:1313"),
    "unpermute": ("unpermute.cu", "tpu_spmv/kernels/window_ell.py:1463"),
    "permute_chunks": ("permute.cu", "tpu_spmv/kernels/reorder.py:225"),
}


def record(name: str, source: str, replaces: str, launches: int,
           err: float, ms: float, plain_ms: float, nbytes: float, ops: float,
           library_ms, stream_gbs: float) -> dict:
    """One record of the ``kernels`` line."""
    bound_ms, bound_by = bound(nbytes, ops, stream_gbs)
    return {"name": name, "route": "cuda",
            "source": "tpu_spmv_torch/csrc/" + source, "replaces": replaces,
            "launches": launches, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms}


def kernel_record(name: str, held: dict, launches: int,
                  stream_gbs: float) -> dict:
    """The ``kernels`` record of one kernel: its first timed use in
    ``held`` (from :func:`hold_kernels`), the largest error of all."""
    first = next(r for r in held[name] if r["ms"] is not None)
    return record(name, *KERNEL_SOURCES[name], launches,
                  max(r["err"] for r in held[name]), first["ms"],
                  first["plain_ms"], first["nbytes"], first["ops"],
                  first["library_ms"], stream_gbs)


def describe(plan) -> dict:
    """A plan's shape for the log: its type, and per band, level or strip
    the superblock height, groups and sections; a composite's flat tail."""
    from tpu_spmv_torch import DeviceCSR, DeviceELL
    from tpu_spmv_torch.kernels.reorder import ReorderedPlan
    from tpu_spmv_torch.kernels.strips import StripPlan
    from tpu_spmv_torch.kernels.window_ell import BandedPlan, CompositePlan
    from tpu_spmv_torch.spmv import PatternPlan

    if isinstance(plan, (PatternPlan, ReorderedPlan)):
        inner = plan.plan if isinstance(plan, PatternPlan) else plan.inner
        return {"type": type(plan).__name__, "inner": describe(inner)}
    if isinstance(plan, DeviceCSR):
        return {"type": "DeviceCSR (flat path)", "nnz": plan.nnz}
    if isinstance(plan, DeviceELL):
        return {"type": "DeviceELL (flat ELL path)",
                "slots": int(plan.values.shape[0]),
                "rows_pad": plan.rows_pad}
    d = {"type": type(plan).__name__, "groups": plan.n_groups,
         "occupancy": round(plan.occupancy, 4)}
    if isinstance(plan, BandedPlan):
        d["band_rows"] = list(plan.band_rows)
    if isinstance(plan, StripPlan):
        d["bounds"] = [list(b) for b in plan.bounds]
    if isinstance(plan, CompositePlan):
        d["tail_nnz"] = 0 if plan.tail is None else plan.tail.nnz
    if isinstance(plan, (BandedPlan, StripPlan, CompositePlan)):
        d["plans"] = [describe(p) for p in plan.plans]
    else:
        d.update(sup=plan.sup, sections=len(plan.sections),
                 extras=plan.n_extra, leveled=plan.lam is not None,
                 rows=plan.num_rows)
    return d


def check_launches(counts: dict, plan, calls: int, what: str) -> None:
    """The launches of ``calls`` calls of ``plan`` are the plan's own
    (``launches_per_call``: per band, level or strip one table set-up, a
    fold per section, the epilogues), and one of each kernel of the path at
    least."""
    from tpu_spmv_torch.kernels import FOLD_VARIANTS
    from tpu_spmv_torch.spmv import launches_per_call

    want = launches_per_call(plan)
    folds = sum(counts[k] for k in FOLD_VARIANTS.values())
    got = {"fold": folds, **{k: counts[k] for k in (
        "section_epilogue", "unpermute", "permute_chunks")}}
    check(got == {k: calls * v for k, v in want.items()},
          f"{what}: launches {got} over {calls} calls, the plan's "
          f"{want} a call")
    check(all(got[k] > 0 for k, v in want.items() if v),
          f"{what}: a kernel of the path was not launched")


def stack_leaves(plan, A, x) -> list:
    """``(window-ELL plan, matrix, x)`` for each plan of a stacked plan, as
    its kernels see them: a band's rows of ``A`` (padded to the band's
    height), a strip's columns of ``A`` and its slice of x, bands inside a
    strip in turn; a composite's levels each against all of ``A`` (a level
    holds a subset of its nonzeros, so ``A``'s row bound is the looser
    one).  A pattern plan's bands keep the column scale."""
    from tpu_spmv_torch.kernels.plan import _slice_rows
    from tpu_spmv_torch.kernels.strips import StripPlan, _slice_cols
    from tpu_spmv_torch.kernels.window_ell import BandedPlan, CompositePlan
    from tpu_spmv_torch.spmv import PatternPlan

    if isinstance(plan, PatternPlan):
        return [(PatternPlan(p, plan.scale), M, xs)
                for p, M, xs in stack_leaves(plan.plan, A, x)]
    if isinstance(plan, BandedPlan):
        out, a = [], 0
        for p, r in zip(plan.plans, plan.band_rows):
            out.append((p, _slice_rows(A, a, a + r, pad_to=p.num_rows), x))
            a += r
        return out
    if isinstance(plan, StripPlan):
        return [leaf for p, (lo, hi) in zip(plan.plans, plan.bounds)
                for leaf in stack_leaves(p, _slice_cols(A, lo, hi),
                                         x[lo:hi])]
    if isinstance(plan, CompositePlan):
        return [(p, A, x) for p in plan.plans]
    return [(plan, A, x)]


def hold_stack(plan, A, x, dev, what: str) -> None:
    """:func:`hold_kernels` (untimed) on each plan of a stacked plan."""
    import torch

    for k, (p, M, xs) in enumerate(stack_leaves(plan, A, x)):
        hold_kernels(p, torch.from_numpy(xs).to(dev), M, xs,
                     f"{what}, plan {k}", timed=False)


def run_cell(what: str, A, x, cfg, dev, stream: float, kind,
             tol: float = REL_TOL, ell=None):
    """One measured ``spmv_csr`` call of a stacked route (counts from 0),
    or of ``spmv_ell`` on ``ell``, the ELL form of ``A``: the plan must be
    a ``kind``; its launches the plan's; the output finite, of ``A``'s
    rows and within ``tol`` of the oracle (for ELL, of ``spmv_cpu_ell`` at
    the row bound); the plan's streamed bytes over the time under the
    physics guard.  Returns ``(result, x on the card)``."""
    import numpy as np
    import torch

    from tpu_spmv_torch import kernels as tk
    from tpu_spmv_torch import spmv_cpu_ell, spmv_csr, spmv_ell
    from tpu_spmv_torch.spmv import MEASURE_WARMUP
    from tpu_spmv_torch.utils.testing import spmv_matches

    xd = torch.from_numpy(x).to(dev)
    tk.reset_launch_counts()
    if ell is None:
        res = spmv_csr(A, xd, cfg, measure=True, measure_iters=ITERS,
                       measure_samples=SAMPLES)
    else:
        res = spmv_ell(ell, xd, cfg, measure=True, measure_iters=ITERS,
                       measure_samples=SAMPLES)
    torch.cuda.synchronize()
    counts = tk.launch_counts()
    check(res.error_code == 0, f"{what}: error {res.error_code}")
    check(isinstance(res.plan, kind),
          f"{what}: served by a {type(res.plan).__name__}, not {kind}")
    calls = 1 + MEASURE_WARMUP + ITERS * SAMPLES
    check_launches(counts, res.plan, calls, what)
    y = res.y.cpu().numpy()
    ok = spmv_matches(y, A, x, rel_tol=tol) if ell is None \
        else max_row_excess(y, spmv_cpu_ell(ell, x), A, x) <= 0
    oracle = "the CPU oracle" if ell is None else "spmv_cpu_ell"
    check(y.shape == (A.num_rows,) and bool(np.all(np.isfinite(y))) and ok,
          f"{what} vs {oracle} (rel {tol})")
    actual = res.plan.stream_bytes / (res.elapsed_ms / 1e3) / 1e9
    log(f"{what}: OK vs {oracle} (rel {tol}); {res.elapsed_ms * 1e3:.2f} "
        f"us/call (median of {SAMPLES} x {ITERS} calls), "
        f"{res.gflops:.2f} GFLOP/s, "
        f"{'' if ell is None else 'ELL '}byte model {res.bandwidth_gb_s:.1f} "
        f"GB/s, streamed {actual:.1f} GB/s "
        f"({res.plan.stream_bytes / 1e6:.2f} MB/call), STREAM "
        f"{stream:.1f} GB/s; plan_seconds {res.plan_seconds:.2f} s; "
        f"launches {counts} over {calls} calls")
    log(f"{what} plan: " + json.dumps(describe(res.plan)))
    check(actual <= 1.02 * stream,
          f"physics guard: {what} {actual:.1f} GB/s streamed > 1.02 x "
          f"STREAM")
    return res, xd


def repeat_and_yardstick(what: str, res, xd, A, dev,
                         cusparse_turns: bool = True) -> None:
    """The served plan bit-identical across two calls; with
    ``cusparse_turns``, timed in turns with cuSPARSE on the same CSR (a
    yardstick only)."""
    import torch

    from tpu_spmv_torch.spmv import _run
    from tpu_spmv_torch.timing import time_turns

    plan = res.plan
    again = _run(plan, xd)
    torch.cuda.synchronize()
    check(torch.equal(res.y, again),
          f"{what}: not bit-identical across two calls")
    if not cusparse_turns:
        log(f"{what}: bit-identical across two calls")
        return
    M = cusparse(A, dev)
    us = [t * 1e6 for t in time_turns(
        [lambda: _run(plan, xd), lambda: M @ xd], iters=ITERS,
        samples=SAMPLES)]
    log(f"{what}: bit-identical across two calls; in turns {us[0]:.2f} "
        f"us/call, cuSPARSE {us[1]:.2f} us/call (a yardstick only)")


def phase_build() -> None:
    from tpu_spmv_torch import native
    from tpu_spmv_torch.kernels import _build

    t0 = time.perf_counter()
    native.require()
    t1 = time.perf_counter()
    _build.kernels()
    t2 = time.perf_counter()
    log(f"build: planner library {t1 - t0:.2f} s, CUDA kernels "
        f"{t2 - t1:.2f} s (nvcc {_build.nvcc_path()})")
    with open(os.path.join(_build.BUILD_DIR,
                           _build.KERNELS_LIB + ".log")) as f:
        for line in f:
            if "ptxas info" in line and ("registers" in line
                                         or "spill" in line):
                log("  " + line.strip())


def phase_kernels(dev) -> None:
    import numpy as np
    import torch

    from tpu_spmv_torch import kernels as tk
    from tpu_spmv_torch.kernels import plan as tplan
    from tpu_spmv_torch.kernels import window_ell as twe
    from tpu_spmv_torch.utils.testing import RandomGenerator, spmv_matches

    rng = RandomGenerator(42)
    A = rng.power_law_csr(*SMOKE)
    x = rng.vector(A.num_cols)
    xd = torch.from_numpy(x).to(dev)
    ones = type(A)(A.num_rows, A.num_cols, np.ones(A.nnz, np.float32),
                   A.col_indices, A.row_ptrs)
    tk.reset_launch_counts()
    for values in ("float32", "bfloat16", "pattern"):
        # the pattern plan's products are those of the 0/1 matrix; the bf16
        # plan's values are rounded, so the oracle allows their rounding
        M = ones if values == "pattern" else A
        tol = BF16_TOL if values == "bfloat16" else REL_TOL
        for sup in (1024, 4096, 16384):
            split = 128 if sup == 1024 or values != "float32" else None
            for tb in (2, 4, 8):
                for leveled in (False, True):
                    hp = tplan.build(
                        A, split_rows=split, sup=sup, t_base=tb,
                        permute_rows=leveled, pattern=values == "pattern",
                        values_dtype="float32" if values == "pattern"
                        else values)
                    plan = twe.plan_from_host(hp, dev)
                    table = twe.gather_table(plan, xd)
                    out = twe.window_ell_fold(plan, table)
                    ref = twe.window_ell_fold_plain(plan, table)
                    torch.cuda.synchronize()
                    y, y_ref = rows_of(out, plan), rows_of(ref, plan)
                    exc = max_row_excess(y, y_ref, M, x)
                    log(f"kernels vs plain, K1 {plan.values} sup={sup} "
                        f"tb={tb} leveled={leveled} sbn={hp.sbn} "
                        f"groups={hp.n_groups} "
                        f"sections={len(plan.sections)}: max|Δ|="
                        f"{float(np.max(np.abs(y - y_ref))):.3g} row-bound "
                        f"excess={exc:.3g}")
                    check(plan.values == values,
                          f"K1 {values}: plan carries {plan.values}")
                    check(exc <= 0, f"K1 {values} row bound, sup={sup} "
                          f"tb={tb} leveled={leveled}")
                    check(spmv_matches(y, M, x, rel_tol=tol),
                          f"K1 {values} vs the oracle, sup={sup} tb={tb}")
    g = np.random.default_rng(3)
    lam = torch.from_numpy(np.stack([g.permutation(128) for _ in range(256)])
                           .astype(np.int32)).to(dev)
    yv = torch.from_numpy(g.standard_normal(250 * 128).astype(np.float32))
    got = twe.unpermute(yv.to(dev), lam, 32000)
    ref = twe.unpermute_plain(yv.to(dev), lam, 32000)
    torch.cuda.synchronize()
    check(torch.equal(got, ref), "K2 differs from its plain version")
    counts = tk.launch_counts()
    log(f"  K2 random lam: exact; launches in this phase {counts}")
    check(all(counts[k] > 0 for k in tk.FOLD_VARIANTS.values())
          and counts["section_epilogue"] > 0 and counts["unpermute"] > 0
          and counts["permute_chunks"] > 0,
          "a kernel's launch count did not move")


def phase_k3(dev) -> None:
    import numpy as np
    import torch

    from tpu_spmv_torch import kernels as tk
    from tpu_spmv_torch.kernels import reorder as tr

    g = np.random.default_rng(11)
    n = 128 * 37 + 45                     # neither chunks nor float4s
    x = torch.from_numpy(g.standard_normal(n + 1).astype(np.float32))
    src = torch.from_numpy(g.integers(-2, 37 + 6, 300).astype(np.int32))
    order = torch.from_numpy(g.permutation(38).astype(np.int32))
    pos = torch.empty_like(order)
    pos[order.long()] = torch.arange(38, dtype=torch.int32)
    xd, srcd = x.to(dev), src.to(dev)
    tk.reset_launch_counts()
    cases = [("src with repeats and past the end", xd[:n], srcd, 300 * 128),
             ("output ending mid-chunk", xd[:n], srcd, 300 * 128 - 57),
             ("x not 16-byte aligned", xd[1:], srcd, 299 * 128 + 3),
             ("order", xd[:n], order.to(dev), 38 * 128)]
    for what, xv, sv, out_len in cases:
        got = tr.permute_chunks(xv, sv, out_len)
        ref = tr.permute_chunks_plain(xv.cpu(), sv.cpu(), out_len)
        torch.cuda.synchronize()
        check(torch.equal(got.cpu(), ref), f"K3 vs plain: {what}")
    back = tr.permute_chunks(got, pos.to(dev), n)
    torch.cuda.synchronize()
    check(torch.equal(back, xd[:n]), "K3 round trip order -> inverse")
    counts = tk.launch_counts()
    log(f"  K3: {len(cases)} cases exact against plain, round trip exact; "
        f"launches in this phase {counts['permute_chunks']}")
    check(counts["permute_chunks"] == len(cases) + 1,
          "K3 launch count did not move once per call")


def hold_probe(name: str, mod, inp, what: str) -> float:
    """One probe mode's kernel against its plain version; returns
    max|Δ|."""
    import torch

    got, ref = mod.probe(inp), mod.probe_plain(inp)
    torch.cuda.synchronize()
    diff = (got - ref).abs()
    tol = PROBE_RTOL * (ref.abs() + float(ref.abs().max()))
    check(bool(torch.isfinite(got).all()) and bool((diff <= tol).all()),
          f"probe {name} {inp.mode} vs its plain version ({what})")
    return float(diff.max())


def hold_tiles(name: str, mod, inp, cpu, what: str) -> float:
    """A run-ordered probe mode (P3's, P2's w128): two calls of its kernel
    bit-identical, and equal bit for bit to the plain version
    (``probe_plain``) and to the CPU twin that follows the kernel's schedule
    (``probe_schedule``), both on ``cpu``, the same inputs made on the CPU;
    returns max|Δ| (0)."""
    import torch

    got, again = mod.probe(inp), mod.probe(inp)
    torch.cuda.synchronize()
    check(torch.equal(got, again),
          f"probe {name} {inp.mode}: two calls differ ({what})")
    got = got.cpu()
    ref = mod.probe_plain(cpu)
    check(torch.equal(got, ref),
          f"probe {name} {inp.mode} vs plain, bit for bit ({what})")
    check(torch.equal(got, mod.probe_schedule(cpu)),
          f"probe {name} {inp.mode} vs its CPU twin, bit for bit ({what})")
    return float((got - ref).abs().max())


def run_ordered(inp) -> bool:
    """Whether a probe mode adds its runs in run order (bit for bit): its
    inputs carry a run index."""
    return getattr(inp, "index", None) is not None


def phase_probes(dev, stream: float) -> list:
    """Phase 5.  Returns a ``kernels`` record per probe: the largest error
    of every check, and as ``ms``, ``plain_ms`` and ``bound_ms`` the sums
    over the JAX main's modes (each once) of the kernel's and the plain
    version's time per call at the default size and of its bound (the bytes
    the JAX main counts, less any the kernel does not read, over
    ``stream``).  No one PyTorch call computes a probe: ``library_ms`` is
    null."""
    import torch

    from tpu_spmv_torch import probes
    from tpu_spmv_torch.timing import time_cuda

    t0 = time.perf_counter()
    mods = probes.modules()
    errs = {name: 0.0 for name in mods}
    for name, kw in PROBE_SMALL.items():
        mod = mods[name]
        small = mod.make_inputs(**kw, device=dev, modes=mod.MODES)
        cpu = mod.make_inputs(**kw, modes=mod.MODES)
        for mode, inp in small.items():
            err = hold_tiles(name, mod, inp, cpu[mode], "reduced") \
                if run_ordered(inp) \
                else hold_probe(name, mod, inp, "reduced")
            errs[name] = max(errs[name], err)
    for name in ("proto_v2", "proto_v3", "proto_v4"):
        try:
            mods[name].make_inputs(2, 24, device=dev)
            refused = False
        except ValueError:
            refused = True
        check(refused, f"probe {name}: S=24 was not refused")
    log(f"  probes vs plain, every mode at reduced sizes: max|Δ| "
        + ", ".join(f"{n} {e:.3g}" for n, e in errs.items())
        + "; S=24 refused by proto_v2, proto_v3 and proto_v4; P3's modes "
        "and P2's w128 bit for bit against their plain versions and CPU "
        "twins, two calls bit-identical")

    # the probes' entry point at the JAX mains' sizes: counts from 0
    inputs = {name: mod.make_inputs(device=dev,
                                    modes=tuple(dict.fromkeys(mod.MAIN_MODES)))
              for name, mod in mods.items()}
    log(f"probes at the JAX mains' default sizes, {PROBE_SAMPLES} x "
        f"{PROBE_ITERS} calls per mode; STREAM {stream:.1f} GB/s; "
        f"nvidia-smi: {nvidia_smi()}")
    probes.reset_launch_counts()
    timed = {name: mod.time_modes(inputs[name], stream, iters=PROBE_ITERS,
                                  samples=PROBE_SAMPLES)
             for name, mod in mods.items()}
    torch.cuda.synchronize()
    counts = probes.launch_counts()
    log(f"probe launches: {counts}")
    check(all(counts[n] > 0 for n in mods), "a probe kernel was not launched")

    # each mode against its plain version at that size, timed beside it;
    # the run-ordered modes bit for bit, and against their CPU twins
    records = []
    for name, mod in mods.items():
        ms = plain_ms = nbytes = ops = 0.0
        # a mode the main lists twice (P4's +scatter8, P1's three) keeps its
        # first time
        kernel_ms = {r["mode"]: r["ms"] for r in reversed(timed[name])}
        modes = tuple(dict.fromkeys(mod.MAIN_MODES))
        cpu = mod.make_inputs(modes=modes) \
            if any(run_ordered(inputs[name][m]) for m in modes) else {}
        for mode in modes:
            inp = inputs[name][mode]
            err = hold_tiles(name, mod, inp, cpu[mode], "default size") \
                if run_ordered(inp) \
                else hold_probe(name, mod, inp, "default size")
            errs[name] = max(errs[name], err)
            p_ms = time_cuda(lambda: mod.probe_plain(inp), iters=2, samples=1,
                             warmup=1) * 1e3
            b_ms, _ = bound(inp.nbytes, 2.0 * inp.vals.numel(), stream)
            log(f"  {name} {mode}: kernel {kernel_ms[mode]:.3f} ms, plain "
                f"{p_ms:.3f} ms, bound {b_ms:.3f} ms, "
                f"{b_ms / kernel_ms[mode]:.0%} of the bound, max|Δ| "
                f"{err:.3g}")
            ms += kernel_ms[mode]
            plain_ms += p_ms
            nbytes += inp.nbytes
            ops += 2.0 * inp.vals.numel()
        records.append(record(name, *PROBE_SOURCES[name], counts[name],
                              errs[name], ms, plain_ms, nbytes, ops, None,
                              stream))
        del cpu
    del inputs
    log(f"probes phase {time.perf_counter() - t0:.1f} s")
    return records


def phase_main(dev, stream: float) -> tuple:
    """Phase 6, the headline.  Returns ``(K1 and K2 records, A, x)``."""
    import numpy as np
    import torch

    from tpu_spmv_torch import (KernelType, SpMVConfig, spmv_auto_config,
                                spmv_csr)
    from tpu_spmv_torch import kernels as tk
    from tpu_spmv_torch.bandwidth import get_gpu_peak_bandwidth
    from tpu_spmv_torch.kernels import window_ell as twe
    from tpu_spmv_torch.spmv import MEASURE_WARMUP
    from tpu_spmv_torch.timing import time_cuda
    from tpu_spmv_torch.utils.testing import RandomGenerator, spmv_matches

    t0 = time.perf_counter()
    rng = RandomGenerator(42)
    A = rng.power_law_csr(*HEADLINE)
    x = rng.vector(A.num_cols)
    stats = A.compute_stats()
    log(f"matrix: {A.num_rows}x{A.num_cols} nnz={A.nnz} "
        f"avg={stats.avg_nnz_per_row:.2f} max_row={stats.max_nnz_per_row} "
        f"skew={stats.skewness:.1f} (generated in "
        f"{time.perf_counter() - t0:.1f} s)")
    cfg = spmv_auto_config(A)
    log(f"auto-selector: {KernelType(cfg.kernel_type).name}")
    check(cfg.kernel_type == KernelType.MERGE_PATH, "selector")
    xd = torch.from_numpy(x).to(dev)

    # the main path: counts from 0, one measured spmv_csr call
    tk.reset_launch_counts()
    res = spmv_csr(A, xd, cfg, measure=True, measure_iters=ITERS,
                   measure_samples=SAMPLES)
    torch.cuda.synchronize()
    counts = tk.launch_counts()
    check(res.error_code == 0, f"spmv_csr error_code {res.error_code}")
    plan = res.plan
    calls = 1 + MEASURE_WARMUP + ITERS * SAMPLES
    log(f"main path launches: {counts} over {calls} calls, "
        f"{len(plan.sections)} sections")
    n_epi, n_k2 = epilogue_launches(plan)
    check(counts["window_ell_fold"] == calls * len(plan.sections),
          "K1 did not launch once per section per call")
    check(counts["section_epilogue"] == calls * n_epi,
          "the section epilogue did not launch once per section but the "
          "last per call")
    check(counts["unpermute"] == calls * n_k2,
          "K2 did not launch once per call")
    check(counts["permute_chunks"] == calls,
          "the table's set-up (K3) did not launch once per call")
    check(counts["window_ell_fold"] > 0 and counts["section_epilogue"] > 0
          and counts["unpermute"] > 0 and counts["permute_chunks"] > 0,
          "a kernel of the main path was not launched")
    log(f"port kernel launches per call: 1 table set-up, "
        f"{len(plan.sections)} folds, {n_epi} section epilogues, {n_k2} K2")
    y = res.y.cpu().numpy()
    check(y.shape == (A.num_rows,) and bool(np.all(np.isfinite(y))),
          "output shape / finiteness")
    check(spmv_matches(y, A, x, rel_tol=REL_TOL),
          "merge-path output vs the CPU oracle")
    log("correctness vs CPU oracle (rel 1e-5): OK")
    log("plan: " + json.dumps({
        "sup": plan.sup, "groups": plan.n_groups,
        "occupancy": round(plan.occupancy, 4), "extras": plan.n_extra,
        "leveled": plan.lam is not None, "step_groups": plan.step_groups,
        "tb": plan.tb, "sbn": plan.sbn, "sections": len(plan.sections)}))
    log("fold schedule: " + json.dumps(fold_geometry(plan)))
    log(f"plan build + upload: {res.plan_seconds:.2f} s (host planner, "
        f"no JAX)")
    BUILD_SECONDS["headline"] = res.plan_seconds

    secs = res.elapsed_ms / 1e3
    peak = get_gpu_peak_bandwidth(dev.index or 0)
    actual = plan.stream_bytes / secs / 1e9

    def plain_spmv():
        out = twe.window_ell_fold_plain(plan,
                                        twe.gather_table_plain(plan, xd))
        return twe.unpermute_plain(out, plan.lam, plan.num_rows)

    plain_secs = time_cuda(plain_spmv, iters=PLAIN_ITERS, samples=SAMPLES,
                           warmup=2)
    log(f"spmv: {res.elapsed_ms * 1e3:.2f} us/call (median of {SAMPLES} x "
        f"{ITERS} calls), {res.gflops:.2f} GFLOP/s, byte model "
        f"{res.bandwidth_gb_s:.1f} GB/s, streamed {actual:.1f} GB/s "
        f"({plan.stream_bytes / 1e6:.2f} MB/call)")
    log(f"plain PyTorch version of the same plan: "
        f"{plain_secs * 1e6:.2f} us/call")
    log(f"STREAM (256 MB read-reduce): {stream:.1f} GB/s; device-attribute "
        f"peak: {peak:.1f} GB/s")
    check(actual <= 1.02 * stream,
          f"physics guard: {actual:.1f} GB/s streamed > 1.02 x STREAM")

    # each kernel against its plain version at the main path's shapes
    held = hold_kernels(plan, xd, A, x, "headline", timed=True,
                        stream=stream)

    # vector CSR: the same kernels, no row split
    vres = spmv_csr(A, xd, SpMVConfig(kernel_type=KernelType.VECTOR_CSR))
    check(vres.error_code == 0, f"vector spmv_csr {vres.error_code}")
    check(spmv_matches(vres.y.cpu().numpy(), A, x, rel_tol=REL_TOL),
          "vector-CSR output vs the CPU oracle")
    log(f"vector CSR (split_rows=None): OK vs oracle; plan groups "
        f"{vres.plan.n_groups}, extras {vres.plan.n_extra}, build "
        f"{vres.plan_seconds:.2f} s")
    return [kernel_record(k, held, counts[k], stream)
            for k in ("window_ell_fold", "section_epilogue", "unpermute")
            ], A, x


def old_composition(rp, xd):
    """The reordered SpMV as earlier versions ran it, on the same plan:
    ``permute_chunks`` of x into the plan's block order, the inner plan's
    SpMV, ``permute_chunks`` of its rows back (three calls, each its own
    kernel launches)."""
    from tpu_spmv_torch.kernels import reorder as tr
    from tpu_spmv_torch.kernels import window_ell as twe

    xp = tr.permute_chunks(xd, rp.col_src, rp.inner.num_cols)
    return tr.permute_chunks(twe.spmv_window_ell(rp.inner, xp), rp.row_src,
                             rp.num_rows)


def phase_reorder(dev, stream: float) -> tuple:
    """Phase 7.  Returns ``(K3's record, the mesh, x, its reordered
    plan)``."""
    import numpy as np
    import torch

    from tpu_spmv_torch import KernelType
    from tpu_spmv_torch import kernels as tk
    from tpu_spmv_torch import spmv_auto_config, spmv_csr
    from tpu_spmv_torch.kernels import reorder as tr
    from tpu_spmv_torch.kernels.window_ell import setup_bytes
    from tpu_spmv_torch.spmv import MEASURE_WARMUP, MERGE_SPLIT_ROWS
    from tpu_spmv_torch.timing import time_turns
    from tpu_spmv_torch.utils.testing import (RandomGenerator,
                                              scrambled_banded_csr,
                                              spmv_matches)

    t0 = time.perf_counter()
    rng = RandomGenerator(42)
    A = scrambled_banded_csr(rng, *MESH)
    x = rng.vector(A.num_cols)
    log(f"mesh matrix: {A.num_rows}x{A.num_cols} nnz={A.nnz} (generated in "
        f"{time.perf_counter() - t0:.1f} s)")
    cfg = spmv_auto_config(A)
    check(cfg.reorder is None, "the auto configuration probes reordering")
    split = MERGE_SPLIT_ROWS if cfg.kernel_type == KernelType.MERGE_PATH \
        else None
    t0 = time.perf_counter()
    order = tr.maybe_reorder(A, split_rows=split)
    probe_s = time.perf_counter() - t0
    check(order is not None, "the reorder probe skipped the mesh")
    xd = torch.from_numpy(x).to(dev)

    # the reordered path: counts from 0, one measured spmv_csr call
    tk.reset_launch_counts()
    res = spmv_csr(A, xd, cfg, measure=True, measure_iters=ITERS,
                   measure_samples=SAMPLES)
    torch.cuda.synchronize()
    counts = tk.launch_counts()
    check(res.error_code == 0, f"spmv_csr error_code {res.error_code}")
    rp = res.plan
    check(isinstance(rp, tr.ReorderedPlan), "no ReorderedPlan served it")
    check(np.array_equal(rp.col_src.cpu().numpy(), order),
          "the plan's block order is not the probe's")
    inner = rp.inner
    calls = 1 + MEASURE_WARMUP + ITERS * SAMPLES
    log(f"reordered path ({KernelType(cfg.kernel_type).name}) launches: "
        f"{counts} over {calls} calls, {len(inner.sections)} sections")
    check(counts["permute_chunks"] == calls,
          "K3 (the table's set-up) did not launch once per call")
    check(counts["window_ell_fold"] == calls * len(inner.sections),
          "K1 did not launch once per inner section per call")
    check(counts["section_epilogue"] == calls * epilogue_launches(inner)[0],
          "the section epilogue did not launch once per inner section but "
          "the last per call")
    # K2 ends every reordered call: it maps the tiles back
    check(counts["unpermute"] == calls,
          "K2 (with the tile map) did not launch once per call")
    y = res.y.cpu().numpy()
    check(y.shape == (A.num_rows,) and bool(np.all(np.isfinite(y))),
          "output shape / finiteness")
    check(spmv_matches(y, A, x, rel_tol=REL_TOL),
          "reordered output vs the CPU oracle")
    old = old_composition(rp, xd)
    torch.cuda.synchronize()
    check(torch.equal(res.y, old),
          "the reordered output differs from the old composition's")
    log("correctness vs CPU oracle (rel 1e-5): OK; bit-identical to the old "
        "composition (permute_chunks, inner SpMV, permute_chunks)")
    log("reordered plan: " + json.dumps({
        "sup": inner.sup, "groups": inner.n_groups,
        "occupancy": round(inner.occupancy, 4), "extras": inner.n_extra,
        "leveled": inner.lam is not None, "step_groups": inner.step_groups,
        "tb": inner.tb, "sbn": inner.sbn, "sections": len(inner.sections),
        "blocks": len(rp.col_src)}))
    log("fold schedule: " + json.dumps(fold_geometry(inner)))
    log(f"host: probe {probe_s:.2f} s (run alone); plan resolution "
        f"{res.plan_seconds:.2f} s (probe, permuted build, upload)")
    BUILD_SECONDS["mesh"] = res.plan_seconds

    secs = res.elapsed_ms / 1e3
    actual = rp.stream_bytes / secs / 1e9
    log(f"reordered spmv: {res.elapsed_ms * 1e3:.2f} us/call (median of "
        f"{SAMPLES} x {ITERS} calls), {res.gflops:.2f} GFLOP/s, byte model "
        f"{res.bandwidth_gb_s:.1f} GB/s, streamed {actual:.1f} GB/s "
        f"({rp.stream_bytes / 1e6:.2f} MB/call, of which x and the maps "
        f"{(rp.stream_bytes - inner.stream_bytes) / 1e6:.2f} MB); STREAM "
        f"{stream:.1f} GB/s")
    check(actual <= 1.02 * stream,
          f"physics guard: {actual:.1f} GB/s streamed > 1.02 x STREAM")

    # each kernel against its plain version at the reordered path's shapes
    held = hold_kernels(rp, xd, A, x, "mesh, reordered", timed=True,
                        stream=stream)
    n_table = inner.cols_pad + inner.e8 * 128
    log(f"K3 as the table's set-up: x {rp.num_cols} elements and "
        f"{len(rp.col_src)} chunk indices read "
        f"({setup_bytes(rp.num_cols, len(rp.col_src)) / 1e6:.2f} MB), the "
        f"table's {n_table} elements written ({4 * n_table / 1e6:.2f} MB)")
    # the public permute of x into the plan's order, beside index_select
    # of x's chunks (x a whole number of chunks here), in turns
    check(rp.num_cols % 128 == 0, "the mesh is a whole number of chunks")
    x2d, src64 = xd.view(-1, 128), rp.col_src.long()
    us = [t * 1e6 for t in time_turns(
        [lambda: tr.permute_chunks(xd, rp.col_src, inner.num_cols),
         lambda: x2d.index_select(0, src64)], iters=ITERS, samples=SAMPLES)]
    log(f"K3 as the public permute_chunks of x: {us[0]:.2f} us per call, "
        f"index_select {us[1]:.2f} us (in turns, median of {SAMPLES} x "
        f"{ITERS} calls)")
    return kernel_record("permute_chunks", held, counts["permute_chunks"],
                         stream), A, x, rp


def phase_banded(dev, stream: float, A, x, rp):
    """Phase 10: row-banded plans at full width.  The 2^20 mesh of phase 7
    with ``reorder=False`` (its natural arm), and the 1M-node web graph
    through its auto configuration (``bench.py:265-272``), each served by a
    ``BandedPlan`` of two bands or more, measured and counted, each band's
    kernels held to their plain versions; the natural mesh timed in turns
    with the reordered one.  Returns the web graph."""
    import dataclasses

    from tpu_spmv_torch import spmv_auto_config
    from tpu_spmv_torch.kernels.window_ell import BandedPlan
    from tpu_spmv_torch.spmv import _run
    from tpu_spmv_torch.timing import time_turns
    from tpu_spmv_torch.utils.testing import RandomGenerator, web_graph_csr

    cfg = dataclasses.replace(spmv_auto_config(A), reorder=False)
    res, xd = run_cell("mesh natural (reorder=False)", A, x, cfg, dev,
                       stream, BandedPlan)
    bp = res.plan
    check(len(bp.plans) >= 2, f"the natural mesh in {len(bp.plans)} band")
    hold_stack(bp, A, x, dev, "mesh natural")
    us = [t * 1e6 for t in time_turns([lambda: _run(bp, xd),
                                       lambda: _run(rp, xd)],
                                      iters=ITERS, samples=SAMPLES)]
    log(f"mesh natural against reordered, in turns (median of {SAMPLES} x "
        f"{ITERS} calls): natural ({len(bp.plans)} bands, {bp.n_groups} "
        f"groups) {us[0]:.2f} us/call, reordered ({rp.n_groups} groups) "
        f"{us[1]:.2f} us/call; nvidia-smi: {nvidia_smi()}")

    t0 = time.perf_counter()
    rows, cols, avg = WEB
    W = web_graph_csr(RandomGenerator(42), rows, cols, avg_nnz=avg)
    xw = RandomGenerator(7).vector(cols)
    log(f"web graph: {rows}x{cols} nnz={W.nnz} (generated in "
        f"{time.perf_counter() - t0:.1f} s)")
    res, _ = run_cell("web graph 1M (auto configuration)", W, xw,
                      spmv_auto_config(W), dev, stream, BandedPlan)
    check(len(res.plan.plans) >= 2,
          f"the web graph in {len(res.plan.plans)} band")
    hold_stack(res.plan, W, xw, dev, "web graph 1M")
    return W


def phase_pagerank_1m(dev, stream: float, W) -> None:
    """Phase 11: PageRank at 1M nodes, on the web graph of phase 10
    column-normalised, through the pattern-banded route: 30 iterations at
    tolerance 0 after a warm-up run, counted, and held to a float64 power
    iteration by phase 9's rule; each band's kernels held to their plain
    versions."""
    import numpy as np
    import torch

    from tpu_spmv_torch import PageRankConfig, pagerank
    from tpu_spmv_torch import kernels as tk
    from tpu_spmv_torch.kernels.window_ell import BandedPlan
    from tpu_spmv_torch.spmv import _run
    from tpu_spmv_torch.timing import time_cuda
    from tpu_spmv_torch.utils.testing import transition_matrix

    t0 = time.perf_counter()
    A = transition_matrix(W)
    n = A.num_rows
    cfg = PageRankConfig(max_iterations=PR_ITERS, tolerance=0.0)
    warm = pagerank(A, cfg)
    torch.cuda.synchronize()
    check(warm.error_code == 0, f"PageRank 1M warm-up: {warm.error_code}")
    log(f"PageRank 1M warm-up (transition matrix, plan build, upload, "
        f"{warm.iterations} iterations): {time.perf_counter() - t0:.2f} s")
    tk.reset_launch_counts()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    res = pagerank(A, cfg)
    stop.record()
    stop.synchronize()
    wall = time.perf_counter() - t0
    counts = tk.launch_counts()
    check(res.error_code == 0 and res.iterations == PR_ITERS,
          f"PageRank 1M: error {res.error_code}, {res.iterations} "
          f"iterations")
    pp = res.plan
    check(isinstance(pp.plan, BandedPlan) and len(pp.plan.plans) >= 2
          and all(p.pat for p in pp.plan.plans),
          "PageRank 1M was not served by a banded pattern plan")
    check_launches(counts, pp, PR_ITERS, "PageRank 1M")
    ranks = res.ranks_host()
    check(ranks.shape == (n,) and bool(np.all(np.isfinite(ranks))),
          "PageRank 1M ranks: shape / finiteness")
    ref = power_iteration(A, PR_ITERS)
    err = np.abs(ranks - ref)
    check(bool(np.all(err <= PR_ATOL + PR_RTOL * np.abs(ref)))
          and bool(np.all(err <= PR_ATOL_TIGHT + PR_RTOL * np.abs(ref))),
          "PageRank 1M vs the float64 power iteration")
    check(abs(float(ranks.sum(dtype=np.float64)) - 1.0) < 1e-4, "Σr != 1")
    ms_iter = start.elapsed_time(stop) / res.iterations
    per = {k: v // PR_ITERS for k, v in counts.items()}
    log(f"PageRank 1M: {res.iterations} iterations, OK vs float64 power "
        f"iteration (max|Δ| {float(err.max()):.3g}, rtol {PR_RTOL}, atol "
        f"{PR_ATOL} and {PR_ATOL_TIGHT}); {ms_iter:.4f} ms/iteration (CUDA "
        f"events over the call, set-up included), "
        f"{wall * 1e3 / res.iterations:.4f} ms/iteration wall; launches "
        f"per iteration {per}; {pp.plan.stream_bytes / 1e6:.2f} MB streamed "
        f"per iteration")
    log("PageRank 1M plan: " + json.dumps(describe(pp)))
    actual = pp.stream_bytes / (ms_iter / 1e3) / 1e9
    check(actual <= 1.02 * stream, f"physics guard: PageRank 1M {actual:.1f}")
    spmv_us = time_cuda(lambda: _run(pp, res.ranks), iters=ITERS,
                        samples=SAMPLES) * 1e6
    log(f"PageRank 1M SpMV alone (the pattern-banded plan, its scale "
        f"multiply and join): {spmv_us:.2f} us/call over CUDA events "
        f"(median of {SAMPLES} x {ITERS} calls), streamed "
        f"{pp.stream_bytes / spmv_us / 1e3:.1f} GB/s")
    hold_stack(pp, A, ranks * np.float32(n), dev, "PageRank 1M")


def phase_wide(dev, stream: float) -> None:
    """Phase 12: past one gather table, each matrix through its auto
    configuration, measured, counted and held to the oracle: a 1M x 4M web
    graph (past ``PACKED_MAX_COLS``) on column strips, one of them banded;
    the headline's law with 1.5M columns (x past ``VMEM_X_MAX_COLS``) on a
    composite plan; a 1.5M-node web graph, which no composite level packs,
    on the flat path (the JAX dispatch's route for it too).  Each stacked
    plan's kernels are held to their plain versions."""
    from tpu_spmv_torch import DeviceCSR, spmv_auto_config
    from tpu_spmv_torch.kernels.strips import StripPlan
    from tpu_spmv_torch.kernels.window_ell import BandedPlan, CompositePlan
    from tpu_spmv_torch.utils.testing import RandomGenerator, web_graph_csr

    for name, shape, kind in (("strips", WIDE, StripPlan),
                              ("composite", COMPOSITE, CompositePlan),
                              ("web graph 1.5M", WEB_1_5M, DeviceCSR)):
        t0 = time.perf_counter()
        if kind is CompositePlan:
            M = RandomGenerator(42).power_law_csr(*shape)
        else:
            rows, cols, avg = shape
            M = web_graph_csr(RandomGenerator(42), rows, cols, avg_nnz=avg)
        x = RandomGenerator(7).vector(M.num_cols)
        log(f"{name} matrix: {M.num_rows}x{M.num_cols} nnz={M.nnz} "
            f"(generated in {time.perf_counter() - t0:.1f} s)")
        res, _ = run_cell(f"{name} {M.num_rows}x{M.num_cols} (auto "
                          f"configuration)", M, x, spmv_auto_config(M), dev,
                          stream, kind)
        plan = res.plan
        if kind is StripPlan:
            check(len(plan.plans) == 4
                  and any(isinstance(p, BandedPlan) for p in plan.plans),
                  "the 1M x 4M graph is not 4 strips with a banded one")
        elif kind is CompositePlan:
            levels = [(p.sup, p.n_groups, p.n_extra) for p in plan.plans]
            log(f"composite: {len(plan.plans)} levels (sup, groups, "
                f"extras: {levels}), flat tail "
                f"{0 if plan.tail is None else plan.tail.nnz} nnz of "
                f"{M.nnz}")
        if kind is not DeviceCSR:
            hold_stack(plan, M, x, dev, name)
        del M


def phase_floors(dev, stream: float, A, x) -> None:
    """Phase 13: the floors on the headline.  SCALAR_CSR (its naive plan,
    or the flat path where that overflows, as the JAX dispatch routes it)
    and ELL_KERNEL on a CSR (the flat path), each measured, held to the
    oracle, bit-identical across two calls; the naive plan's kernels held
    to their plain versions; the flat path timed in turns with cuSPARSE on
    the same matrix, a yardstick only."""
    from tpu_spmv_torch import DeviceCSR, KernelType, SpMVConfig
    from tpu_spmv_torch.kernels.window_ell import WindowEllPlan

    for kt in (KernelType.SCALAR_CSR, KernelType.ELL_KERNEL):
        what = f"headline {kt.name}"
        kind = DeviceCSR if kt == KernelType.ELL_KERNEL \
            else (WindowEllPlan, DeviceCSR)
        res, xd = run_cell(what, A, x, SpMVConfig(kernel_type=kt), dev,
                           stream, kind)
        plan = res.plan
        flat = isinstance(plan, DeviceCSR)
        log(f"{what}: served by "
            + ("the flat path" if flat else
               f"the naive plan (n_extra {plan.n_extra})"))
        repeat_and_yardstick(what, res, xd, A, dev, cusparse_turns=flat)
        if not flat:
            check(plan.n_extra == 0, f"{what}: the naive plan has extras")
            hold_kernels(plan, xd, A, x, what, timed=False)


def ell_cell(what: str, E, A, x, cfg, dev, stream: float, kind) -> None:
    """One ELL cell of phase 14: ``run_cell`` through ``spmv_ell`` on
    ``E`` (the ELL form of ``A``), the output bit-identical across two
    calls and timed in turns with cuSPARSE on ``A``, and each window-ELL
    plan's kernels held to their plain versions."""
    from tpu_spmv_torch import DeviceELL

    res, xd = run_cell(what, A, x, cfg, dev, stream, kind, ell=E)
    repeat_and_yardstick(what, res, xd, A, dev)
    if not isinstance(res.plan, DeviceELL):
        hold_stack(res.plan, A, x, dev, what)


def phase_ell(dev, stream: float, A, x) -> None:
    """Phase 14: the ELL path at full width, plan files, autotune, the
    harness and the demo.  The 5-point stencil (``bench.py:226-245``) at
    the grid sides of :data:`STENCILS` through ``spmv_ell``, one per route
    of the JAX rule (``ell_cell``), and the 1024 stencil column-scaled on
    the pattern route; the headline's plan (phase 6's, cached on ``A``)
    saved and loaded back onto the card, bit-identical; autotune on the
    headline at step widths 128 and 384; ``benchmark_csr`` and
    ``compare_gpu_cpu_csr`` on the headline, ``benchmark_ell`` on the
    1024 stencil, each ``correct``; and ``python -m tpu_spmv_torch.cli
    --json``, which must exit 0 with every ``correct`` true."""
    import re
    import tempfile

    import numpy as np
    import torch

    from tpu_spmv_torch import (BenchmarkConfig, CSRMatrix, DeviceELL,
                                ELLMatrix, SpMVConfig, benchmark_csr,
                                benchmark_ell, benchmark_to_json,
                                compare_gpu_cpu_csr, comparison_to_json,
                                spmv_auto_config, spmv_csr)
    from tpu_spmv_torch.kernels.strips import StripPlan
    from tpu_spmv_torch.kernels.window_ell import WindowEllPlan
    from tpu_spmv_torch.spmv import PatternPlan, _run
    from tpu_spmv_torch.utils.testing import (RandomGenerator,
                                              spmv_matches, stencil_csr)

    kinds = (WindowEllPlan, WindowEllPlan, StripPlan, DeviceELL)
    E1024 = None
    for g, kind in zip(STENCILS, kinds):
        t0 = time.perf_counter()
        S = stencil_csr(g)
        E = ELLMatrix.from_csr(S)
        xs = RandomGenerator(42).vector(S.num_cols)
        log(f"stencil {g}^2: {S.num_rows} rows, nnz {S.nnz}, "
            f"max_nnz_per_row {E.max_nnz_per_row} (generated in "
            f"{time.perf_counter() - t0:.1f} s)")
        ell_cell(f"ELL stencil {g}^2", E, S, xs, SpMVConfig(), dev, stream,
                 kind)
        if g == PATTERN_STENCIL:
            E1024, S1024, x1024 = E, S, xs
            scale = RandomGenerator(7).rng.uniform(0.5, 2.0, S.num_cols) \
                .astype(np.float32)
            P = CSRMatrix(S.num_rows, S.num_cols, scale[S.col_indices],
                          S.col_indices, S.row_ptrs)
            ell_cell(f"ELL stencil {g}^2 pattern", ELLMatrix.from_csr(P), P,
                     xs, SpMVConfig(pattern=True), dev, stream, PatternPlan)
        del S, E

    # the headline's plan, saved and loaded back onto the card
    cfg = spmv_auto_config(A)
    xd = torch.from_numpy(x).to(dev)
    plan = spmv_csr(A, xd, cfg).plan
    with tempfile.TemporaryDirectory() as tmp:
        plan_file_round_trip("headline", plan, xd, tmp)

    # autotune on the headline
    report = {}
    t0 = time.perf_counter()
    best = WindowEllPlan.autotune(A, x, split_rows=128, widths=(128, 384),
                                  device=dev, report=report)
    tune_s = time.perf_counter() - t0
    y = _run(best, xd).cpu().numpy()
    check(spmv_matches(y, A, x, rel_tol=REL_TOL),
          "autotune's winner vs the CPU oracle")
    log("autotune (headline, split_rows=128): "
        + ", ".join(f"S={w} {t * 1e6:.2f} us/call" for w, t in
                    report.items())
        + f"; winner S={best.step_groups}, OK vs oracle; {tune_s:.1f} s "
        f"(two builds and the timing)")

    # the harness
    bc = BenchmarkConfig()
    for what, r in (
            ("benchmark_csr (headline, auto configuration)",
             benchmark_csr(A, x, cfg, bc, name="headline")),
            (f"benchmark_ell (stencil {PATTERN_STENCIL}^2)",
             benchmark_ell(E1024, x1024, None, bc, name="ell_stencil"))):
        log(f"{what}:\n" + benchmark_to_json(r))
        check(r.correct, f"{what}: correct is false")
    comp = compare_gpu_cpu_csr(A, x, cfg, bc)
    log("compare_gpu_cpu_csr (headline):\n" + comparison_to_json(comp))
    check(comp.device_result.correct and comp.cpu_result.correct,
          "compare_gpu_cpu_csr: correct is false")
    del E1024, S1024, x1024

    # the demo, as a user runs it
    t0 = time.perf_counter()
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=here + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run([sys.executable, "-m", "tpu_spmv_torch.cli",
                           "--json"], cwd=here, env=env,
                          capture_output=True, text=True, timeout=600)
    flags = re.findall(r'"correct": (true|false)', proc.stdout)
    log(f"python -m tpu_spmv_torch.cli --json: exit {proc.returncode}, "
        f"{len(flags)} correct flags, {time.perf_counter() - t0:.1f} s; "
        "its lines:\n" + "\n".join(
            line for line in proc.stdout.splitlines()
            if not line.strip().startswith(('"', "{", "}", "[", "]"))))
    check(proc.returncode == 0, f"the demo exited {proc.returncode}: "
          f"{proc.stderr[-2000:]}")
    check(len(flags) >= 5 and all(f == "true" for f in flags),
          "the demo's JSON has a correct that is not true")


def plan_file_round_trip(what: str, plan, xd, tmp: str) -> None:
    """``plan`` saved with ``save_plan`` and loaded back onto the card with
    ``load_plan``: the same type, and its output bit-identical to the
    saved plan's; the seconds printed beside the plan's build seconds."""
    import torch

    from tpu_spmv_torch import load_plan, save_plan
    from tpu_spmv_torch.spmv import _run

    path = os.path.join(tmp, what + ".npz")
    t0 = time.perf_counter()
    save_plan(plan, path)
    t1 = time.perf_counter()
    loaded = load_plan(path)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    check(type(loaded) is type(plan) and loaded is not plan,
          f"{what}: load_plan gave a {type(loaded).__name__}")
    y, y_loaded = _run(plan, xd), _run(loaded, xd)
    torch.cuda.synchronize()
    check(y_loaded.device == xd.device and torch.equal(y, y_loaded),
          f"{what}: the loaded plan's output differs from the saved plan's")
    log(f"plan file ({what}, {type(plan).__name__}): "
        f"{os.path.getsize(path) / 1e6:.1f} MB, save {t1 - t0:.2f} s, load "
        f"onto the card {t2 - t1:.2f} s, against a build of "
        f"{BUILD_SECONDS.get(what, float('nan')):.2f} s; output "
        f"bit-identical to the saved plan's")


def phase_plan_file_mesh(dev, rp, x) -> None:
    """Phase 14, continued: the mesh's reordered plan (phase 7's) saved and
    loaded back onto the card, bit-identical."""
    import tempfile

    import torch

    with tempfile.TemporaryDirectory() as tmp:
        plan_file_round_trip("mesh", rp, torch.from_numpy(x).to(dev), tmp)


def phase_reorder_ab(dev) -> None:
    import dataclasses

    import torch

    from tpu_spmv_torch import spmv_auto_config, spmv_csr
    from tpu_spmv_torch.kernels import reorder as tr
    from tpu_spmv_torch.utils import testing as tt

    for name, args in AB:
        t0 = time.perf_counter()
        rng = tt.RandomGenerator(42)
        A = getattr(tt, name)(rng, *args)
        x = rng.vector(A.num_cols)
        xd = torch.from_numpy(x).to(dev)
        cfg = spmv_auto_config(A)
        arms = {"natural": dataclasses.replace(cfg, reorder=False),
                "reordered": cfg}
        us = {k: [] for k in arms}
        res = {}
        for arm in ("natural", "reordered", "reordered", "natural"):
            r = spmv_csr(A, xd, arms[arm], measure=True, measure_iters=ITERS,
                         measure_samples=SAMPLES)
            check(r.error_code == 0, f"{name} {arm}: error {r.error_code}")
            if arm not in res:
                check(tt.spmv_matches(r.y.cpu().numpy(), A, x,
                                      rel_tol=REL_TOL),
                      f"{name} {arm} vs the CPU oracle")
                hold_kernels(r.plan, xd, A, x, f"{name} {arm}", timed=False)
                res[arm] = r
            us[arm].append(r.elapsed_ms * 1e3)
        check(not isinstance(res["natural"].plan, tr.ReorderedPlan)
              and isinstance(res["reordered"].plan, tr.ReorderedPlan),
              f"{name}: the A/B arms took the wrong routes")
        log(f"A/B {name}{args}: nnz={A.nnz}, both arms OK vs oracle; "
            f"natural sup {res['natural'].plan.sup} "
            f"{res['natural'].plan.n_groups} groups, "
            f"{', '.join(f'{t:.2f}' for t in us['natural'])} us/call "
            f"(build {res['natural'].plan_seconds:.2f} s); reordered sup "
            f"{res['reordered'].plan.inner.sup} "
            f"{res['reordered'].plan.n_groups} groups, "
            f"{', '.join(f'{t:.2f}' for t in us['reordered'])} us/call "
            f"(probe + build {res['reordered'].plan_seconds:.2f} s); "
            f"{time.perf_counter() - t0:.1f} s in all")


def phase_levers(dev, stream: float, A, x) -> dict:
    """Phase 6, continued: the headline through the JAX bench's two levers
    (``bench.py:332-375``), each through ``spmv_csr`` with the headline's
    configuration, measured, counted from 0 and held to the guard, and its
    kernels held to their plain versions.  Returns K1's bf16 record."""
    import dataclasses

    import numpy as np
    import torch

    from tpu_spmv_torch import CSRMatrix, spmv_auto_config, spmv_csr
    from tpu_spmv_torch import kernels as tk
    from tpu_spmv_torch.spmv import MEASURE_WARMUP, PatternPlan
    from tpu_spmv_torch.utils.testing import RandomGenerator, spmv_matches

    xd = torch.from_numpy(x).to(dev)
    cfg = spmv_auto_config(A)
    calls = 1 + MEASURE_WARMUP + ITERS * SAMPLES
    # a column-scaled matrix of the headline's structure (bench.py:354)
    svals = RandomGenerator(7).rng.uniform(0.5, 2.0, A.num_cols) \
        .astype(np.float32)
    P = CSRMatrix(A.num_rows, A.num_cols, svals[A.col_indices],
                  A.col_indices, A.row_ptrs)
    cases = (("bf16", A, dataclasses.replace(cfg, bf16_values=True),
              "window_ell_fold_bf16", BF16_TOL),
             ("pattern", P, dataclasses.replace(cfg, pattern=True),
              "window_ell_fold_pattern", REL_TOL))
    held16 = counts16 = None
    for what, M, c, fold, tol in cases:
        tk.reset_launch_counts()
        res = spmv_csr(M, xd, c, measure=True, measure_iters=ITERS,
                       measure_samples=SAMPLES)
        torch.cuda.synchronize()
        counts = tk.launch_counts()
        check(res.error_code == 0, f"headline {what}: error {res.error_code}")
        plan = res.plan.plan if isinstance(res.plan, PatternPlan) \
            else res.plan
        check(plan.values == ("pattern" if what == "pattern" else
                              "bfloat16")
              and isinstance(res.plan, PatternPlan) == (what == "pattern"),
              f"headline {what}: served by a {plan.values} plan")
        check(counts[fold] == calls * len(plan.sections)
              and sum(counts[k] for k in tk.FOLD_VARIANTS.values())
              == counts[fold]
              and counts["section_epilogue"]
              == calls * epilogue_launches(plan)[0],
              f"headline {what}: K1 launches {counts}")
        check(counts["unpermute"] == calls * epilogue_launches(plan)[1],
              f"headline {what}: K2 did not launch once per call")
        check(counts["permute_chunks"] == calls,
              f"headline {what}: the table's set-up did not launch once per "
              f"call")
        y = res.y.cpu().numpy()
        check(y.shape == (M.num_rows,) and bool(np.all(np.isfinite(y)))
              and spmv_matches(y, M, x, rel_tol=tol),
              f"headline {what} vs the CPU oracle (rel {tol})")
        secs = res.elapsed_ms / 1e3
        actual = res.plan.stream_bytes / secs / 1e9
        log(f"headline {what}: OK vs oracle (rel {tol}); launches {counts} "
            f"over {calls} calls; {res.elapsed_ms * 1e3:.2f} us/call, byte "
            f"model {res.bandwidth_gb_s:.1f} GB/s, streamed {actual:.1f} "
            f"GB/s ({res.plan.stream_bytes / 1e6:.2f} MB/call), STREAM "
            f"{stream:.1f} GB/s; sup {plan.sup}, {plan.n_groups} groups, "
            f"{len(plan.sections)} sections; plan build "
            f"{res.plan_seconds:.2f} s")
        log(f"headline {what} fold schedule: "
            + json.dumps(fold_geometry(plan)))
        check(actual <= 1.02 * stream,
              f"physics guard: headline {what} {actual:.1f} GB/s streamed")
        held = hold_kernels(res.plan, xd, M, x, f"headline, {what}",
                            timed=True, stream=stream)
        if what == "bf16":
            held16, counts16 = held, counts
    return kernel_record("window_ell_fold_bf16", held16,
                         counts16["window_ell_fold_bf16"], stream)


def power_iteration(A, iters: int, damping: float = 0.85):
    """PageRank's update in float64 on the host, ``iters`` times from the
    uniform vector, renormalised: the reference of phase 9."""
    import numpy as np

    n = A.num_rows
    rows = np.repeat(np.arange(n), np.diff(A.row_ptrs))
    vals = A.values.astype(np.float64)
    dangling = np.bincount(A.col_indices, minlength=n) == 0
    r = np.full(n, 1.0 / n)
    for _ in range(iters):
        r = damping * np.bincount(rows, vals * r[A.col_indices], minlength=n) \
            + damping * r[dangling].sum() / n + (1.0 - damping) / n
    return r / r.sum()


def phase_pagerank(dev, stream: float) -> dict:
    """Phase 9.  Returns K1's pattern record (its launches from the timed
    PageRank run)."""
    import numpy as np
    import torch

    from tpu_spmv_torch import PageRankConfig, pagerank
    from tpu_spmv_torch import kernels as tk
    from tpu_spmv_torch.spmv import PatternPlan
    from tpu_spmv_torch.utils.testing import (RandomGenerator,
                                              transition_matrix,
                                              web_graph_csr)

    t0 = time.perf_counter()
    n, avg = PAGERANK
    A = transition_matrix(web_graph_csr(RandomGenerator(42), n, n,
                                        avg_nnz=avg))
    log(f"PageRank matrix: web graph {n} nodes, {A.nnz} nnz, column-"
        f"normalised (generated in {time.perf_counter() - t0:.1f} s)")
    cfg = PageRankConfig(max_iterations=PR_ITERS, tolerance=0.0)
    t0 = time.perf_counter()
    warm = pagerank(A, cfg)
    torch.cuda.synchronize()
    check(warm.error_code == 0, f"PageRank warm-up: error {warm.error_code}")
    log(f"PageRank warm-up (plan build, upload, {warm.iterations} "
        f"iterations): {time.perf_counter() - t0:.2f} s")

    # the PageRank path: counts from 0, one run of PR_ITERS iterations
    tk.reset_launch_counts()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    res = pagerank(A, cfg)
    stop.record()
    stop.synchronize()
    wall = time.perf_counter() - t0
    counts = tk.launch_counts()
    check(res.error_code == 0 and res.iterations == PR_ITERS,
          f"PageRank: error {res.error_code}, {res.iterations} iterations")
    pp = res.plan
    check(isinstance(pp, PatternPlan) and pp.plan.pat
          and pp.plan.sup == 4096,
          "PageRank was not served by a pattern plan at sup 4096")
    plan = pp.plan
    check(counts["window_ell_fold_pattern"] == PR_ITERS * len(plan.sections)
          and counts["window_ell_fold"] == counts["window_ell_fold_bf16"]
          == 0 and counts["section_epilogue"]
          == PR_ITERS * epilogue_launches(plan)[0],
          f"PageRank: K1 launches {counts}")
    check(plan.lam is not None and counts["unpermute"] == PR_ITERS,
          "PageRank: K2 did not launch once per iteration")
    check(counts["permute_chunks"] == PR_ITERS,
          "PageRank: the table's set-up did not launch once per iteration")
    ranks = res.ranks_host()
    check(ranks.shape == (n,) and bool(np.all(np.isfinite(ranks))),
          "PageRank ranks: shape / finiteness")
    ref = power_iteration(A, PR_ITERS)
    err = np.abs(ranks - ref)
    check(bool(np.all(err <= PR_ATOL + PR_RTOL * np.abs(ref))),
          "PageRank vs the float64 power iteration")
    check(bool(np.all(err <= PR_ATOL_TIGHT + PR_RTOL * np.abs(ref))),
          f"PageRank vs the float64 power iteration at atol {PR_ATOL_TIGHT}")
    check(abs(float(ranks.sum(dtype=np.float64)) - 1.0) < 1e-4, "Σr != 1")
    ms_iter = start.elapsed_time(stop) / res.iterations
    log(f"PageRank: {res.iterations} iterations, launches {counts}; OK vs "
        f"float64 power iteration (max|Δ| {float(err.max()):.3g}, rtol "
        f"{PR_RTOL}, atol {PR_ATOL} and {PR_ATOL_TIGHT}), Σr = "
        f"{float(ranks.sum()):.7f}")
    log("PageRank plan: " + json.dumps({
        "sup": plan.sup, "groups": plan.n_groups,
        "occupancy": round(plan.occupancy, 4), "sbn": plan.sbn,
        "leveled": plan.lam is not None, "step_groups": plan.step_groups,
        "tb": plan.tb, "stream_mb": round(plan.stream_bytes / 1e6, 2)}))
    log("PageRank fold schedule: " + json.dumps(fold_geometry(plan)))
    actual = plan.stream_bytes / (ms_iter / 1e3) / 1e9
    log(f"PageRank: {ms_iter:.4f} ms/iteration (CUDA events over the call, "
        f"set-up included), {wall * 1e3 / res.iterations:.4f} ms/iteration "
        f"wall (as bench.py reports it); plan streamed {actual:.1f} GB/s "
        f"per iteration, STREAM {stream:.1f} GB/s")
    check(actual <= 1.02 * stream, f"physics guard: PageRank {actual:.1f}")

    # K1 (pattern) and K2 against their plain versions on this plan's
    # inputs, and cuSPARSE on the same matrix.  x is the ranks times n (the
    # SpMV is linear): the ranks themselves (about 1/n) would put every
    # row's (|A||x|)_i far below the row bound's floor of 1, where a fold
    # that dropped whole rows would still pass
    held = hold_kernels(pp, res.ranks * n, A, ranks * np.float32(n),
                        "PageRank", timed=True, stream=stream)
    k1 = held["window_ell_fold_pattern"][0]
    k1_gbs = k1["nbytes"] / (k1["ms"] / 1e3) / 1e9
    log(f"PageRank K1 (pattern): {k1['ms'] * 1e3:.2f} us/call, "
        f"{k1_gbs:.1f} GB/s of its {k1['nbytes'] / 1e6:.2f} MB; bound "
        f"{bound(k1['nbytes'], k1['ops'], stream)[0] * 1e3:.2f} us; "
        f"library: cuSPARSE SpMV of the matrix {k1['library_ms'] * 1e3:.2f} "
        f"us")
    check(k1_gbs <= 1.02 * stream, f"physics guard: PageRank K1 {k1_gbs:.1f}")

    conv = pagerank(A)
    check(conv.error_code == 0, f"PageRank default: error {conv.error_code}")
    log(f"PageRank at the default tolerance 1e-6: {conv.iterations} "
        f"iterations, converged={conv.converged}, residual "
        f"{conv.final_residual:.3g}")
    return kernel_record("window_ell_fold_pattern", held,
                         counts["window_ell_fold_pattern"], stream)


def local_structure(rows: int, cols: int, avg: float, rng):
    """``benchmarks/scaling.py``'s ``--structure local`` matrix
    (``:62-82``): each row's columns within 2% of the diagonal's (the
    partition-friendly class, meshes and road networks, where the ring's
    packed footprint beats replicating x)."""
    import numpy as np

    from tpu_spmv_torch import CSRMatrix

    half = max(64, int(cols * 0.02))
    k = max(1, int(avg))
    base_r = np.repeat(np.arange(rows, dtype=np.int64), k)
    off = rng.rng.integers(-half, half + 1, size=len(base_r))
    cc = np.clip((base_r * cols) // rows + off, 0, cols - 1)
    order = np.lexsort((cc, base_r))
    rp = np.zeros(rows + 1, np.int32)
    np.cumsum(np.bincount(base_r, minlength=rows), out=rp[1:])
    return CSRMatrix(rows, cols, rng.vector(len(base_r)).astype(np.float32),
                     cc[order].astype(np.int32), rp)


def sharded_matrices() -> tuple:
    """Phase 15's matrices: ``(A, x, twin, L, xl)``, the power-law matrix
    of ``SHARDED`` and its operand, its column-scaled twin for the pattern
    cell (``benchmarks/scaling.py:148-152``), and the local structure of
    the same size with its operand, for the ring."""
    import numpy as np

    from tpu_spmv_torch import CSRMatrix
    from tpu_spmv_torch.utils.testing import RandomGenerator

    rows, cols, avg, alpha = SHARDED
    rng = RandomGenerator(42)
    A = rng.power_law_csr(rows, cols, avg_nnz=avg, alpha=alpha)
    x = rng.vector(cols)
    s_col = np.abs(rng.vector(cols)) + 0.5
    twin = CSRMatrix(rows, cols, s_col[A.col_indices], A.col_indices,
                     A.row_ptrs)
    L = local_structure(rows, cols, avg, RandomGenerator(42))
    return A, x, twin, L, RandomGenerator(7).vector(cols)


def shard_plans(sh) -> list:
    """The window-ELL plans one call of a sharded matrix runs (none on the
    flat sharded path)."""
    from tpu_spmv_torch.parallel import RingShardedCSR, ShardedWindowEll

    if isinstance(sh, ShardedWindowEll):
        return list(sh.plans)
    if isinstance(sh, RingShardedCSR):
        return [p for d, ring in zip(sh.diag_plans, sh.ring_plans)
                for p in (d, *ring)]
    return []


def sharded_launches(sh) -> dict:
    """The kernel launches of one call of a sharded matrix: each shard
    plan's ``launches_per_call`` (K1's fold in the plans' value stream)."""
    from tpu_spmv_torch.kernels import FOLD_VARIANTS
    from tpu_spmv_torch.spmv import launches_per_call

    want = dict.fromkeys(("section_epilogue", "unpermute", "permute_chunks",
                          *FOLD_VARIANTS.values()), 0)
    for p in shard_plans(sh):
        per = launches_per_call(p)
        want[FOLD_VARIANTS[p.values]] += per.pop("fold")
        for k, v in per.items():
            want[k] += v
    return want


def sharded_cell(what: str, sh, run, A, x, xd, single=None,
                 tol: float = REL_TOL) -> None:
    """One sharded path on the card: the launch counts from 0 around one
    call, each shard plan's own; the output against the CPU oracle on the
    unpartitioned matrix, bit-identical across two calls; then its ms per
    call over CUDA events (in turns with ``single``, the single plan's call
    of the same matrix, where given)."""
    import numpy as np
    import torch

    from tpu_spmv_torch import kernels as tk
    from tpu_spmv_torch.timing import time_turns
    from tpu_spmv_torch.utils.testing import spmv_matches

    tk.reset_launch_counts()
    y = run(sh, xd)
    torch.cuda.synchronize()
    counts = tk.launch_counts()
    want = sharded_launches(sh)
    check(counts == want, f"sharded {what}: launches {counts}, the shard "
          f"plans' {want}")
    check(all(counts[k] > 0 for k, v in want.items() if v),
          f"sharded {what}: a kernel of the path was not launched")
    yh = y.cpu().numpy()
    check(yh.shape == (A.num_rows,) and bool(np.all(np.isfinite(yh)))
          and spmv_matches(yh, A, x, rel_tol=tol),
          f"sharded {what} vs the CPU oracle (rel {tol})")
    check(torch.equal(y, run(sh, xd)),
          f"sharded {what}: not bit-identical across two calls")
    fns = [lambda: run(sh, xd)] + ([single] if single else [])
    ms = [t * 1e3 for t in time_turns(fns, iters=SHARD_ITERS,
                                      samples=SAMPLES, warmup=3)]
    beside = f"; the single plan in turns {ms[1]:.4f} ms" if single else ""
    log(f"sharded {what}: OK vs the CPU oracle (rel {tol}), bit-identical "
        f"across two calls; {ms[0]:.4f} ms/call over CUDA events (median "
        f"of {SAMPLES} x {SHARD_ITERS}){beside}; launches a call {counts}; "
        f"shards' nnz "
        f"{list(sh.shard_nnz)}, imbalance {sh.nnz_imbalance:.4f}")


def built(what: str, make):
    """``make()``, its seconds logged as the plan seconds of ``what``."""
    t0 = time.perf_counter()
    out = make()
    log(f"sharded {what}: plan {time.perf_counter() - t0:.2f} s")
    return out


def phase_sharded(dev) -> None:
    """Phase 15: the multi-device layer on one card, 4 shards on it."""
    import socket

    import numpy as np
    import torch
    import torch.distributed as dist

    from tpu_spmv_torch import (KernelType, PageRankConfig, SpMVConfig,
                                spmv_csr)
    from tpu_spmv_torch import kernels as tk
    from tpu_spmv_torch.kernels.plan import _slice_rows
    from tpu_spmv_torch.pagerank import find_dangling_mask
    from tpu_spmv_torch.parallel import (init_distributed, make_row_mesh,
                                         pagerank_sharded,
                                         pagerank_step_sharded,
                                         ring_traffic_report, shard_csr,
                                         shard_csr_packed, shard_csr_ring,
                                         spmv_csr_ring, spmv_csr_sharded,
                                         spmv_csr_sharded_packed)
    from tpu_spmv_torch.spmv import PatternPlan, _run
    from tpu_spmv_torch.utils.testing import (RandomGenerator,
                                              transition_matrix,
                                              web_graph_csr)

    mesh = make_row_mesh(SHARDS, devices=[str(dev)] * SHARDS)
    t0 = time.perf_counter()
    A, x, twin, L, xl = sharded_matrices()
    log(f"sharded matrices: power law {A.num_rows} x {A.num_cols}, {A.nnz} "
        f"nnz; the local structure {L.nnz} nnz (generated in "
        f"{time.perf_counter() - t0:.1f} s); {SHARDS} shards on {dev}")
    xd = torch.from_numpy(x).to(dev)

    # the single plan of the same matrix, through the dispatch
    cfg = SpMVConfig(kernel_type=KernelType.MERGE_PATH)
    res = spmv_csr(A, xd, cfg, device=dev)
    check(res.error_code == 0, f"sharded: the single plan, error "
          f"{res.error_code}")
    single = lambda: _run(res.plan, xd)  # noqa: E731
    log(f"sharded: the single plan ({type(res.plan).__name__}) in "
        f"{res.plan_seconds:.2f} s")

    sh = built("flat", lambda: shard_csr(A, mesh))
    sharded_cell("flat", sh, spmv_csr_sharded, A, x, xd, single)
    sp = built("packed f32", lambda: shard_csr_packed(A, mesh))
    sharded_cell("packed f32", sp, spmv_csr_sharded_packed, A, x, xd,
                 single)
    # shard 0's plan against its plain versions (its rows of A, padded)
    hold_kernels(sp.plans[0], xd, _slice_rows(A, 0, sp.bounds[1],
                                              pad_to=sp.rows_per_shard),
                 x, "sharded packed, shard 0", timed=False)
    del sp
    sb = built("packed bf16", lambda: shard_csr_packed(
        A, mesh, values_dtype="bfloat16"))
    sharded_cell("packed bf16", sb, spmv_csr_sharded_packed, A, x, xd,
                 tol=BF16_TOL)
    del sb
    spat = built("packed pattern", lambda: shard_csr_packed(
        twin, mesh, pattern=True))
    sharded_cell("packed pattern", spat, spmv_csr_sharded_packed, twin, x,
                 xd)
    hold_kernels(PatternPlan(spat.plans[0], spat.col_scale), xd,
                 _slice_rows(twin, 0, spat.bounds[1],
                             pad_to=spat.rows_per_shard),
                 x, "sharded pattern, shard 0", timed=False)
    del spat
    sl = built("packed permute_rows", lambda: shard_csr_packed(
        A, mesh, permute_rows=True))
    check(sl.has_lam, "sharded permute_rows: the shard plans are not "
          "leveled")
    sharded_cell("packed permute_rows", sl, spmv_csr_sharded_packed, A, x,
                 xd)
    del sl
    rs = built("ring (local structure)", lambda: shard_csr_ring(L, mesh))
    log("sharded ring traffic: " + json.dumps(ring_traffic_report(rs)))
    sharded_cell("ring (local structure)", rs, spmv_csr_ring, L, xl,
                 torch.from_numpy(xl).to(dev))
    del rs

    # the same packed SpMV through a process group of world size 1 (NCCL),
    # bit for bit against the local mesh's one shard
    local = spmv_csr_sharded_packed(shard_csr_packed(
        A, make_row_mesh(1, devices=[str(dev)])), xd)
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    init_distributed(f"127.0.0.1:{port}", 1, 0)
    try:
        gmesh = make_row_mesh()
        check(gmesh.group is not None and gmesh.n_shards == 1,
              "sharded: the process-group mesh")
        sg = shard_csr_packed(A, gmesh)
        tk.reset_launch_counts()
        y = spmv_csr_sharded_packed(sg, xd)
        torch.cuda.synchronize()
        check(tk.launch_counts() == sharded_launches(sg),
              "sharded process group: launches")
        backend = dist.get_backend()
    finally:
        dist.destroy_process_group()
    check(torch.equal(y, local), "sharded: the process group of one is not "
          "bit-identical to the local mesh's one shard")
    log(f"sharded process group ({backend}, world size 1): bit-identical "
        f"to the local one-shard mesh")
    del local, sg, y

    # PageRank over shards: the JAX bench's web graph, 30 iterations
    t0 = time.perf_counter()
    n, pavg = PAGERANK
    T = transition_matrix(web_graph_csr(RandomGenerator(42), n, n,
                                        avg_nnz=pavg))
    mask = find_dangling_mask(T)
    ref = power_iteration(T, PR_ITERS)
    log(f"sharded PageRank matrix: {n} nodes, {T.nnz} nnz "
        f"({time.perf_counter() - t0:.1f} s with its float64 reference)")
    pcfg = PageRankConfig(max_iterations=PR_ITERS, tolerance=0.0)
    for what, make in (("packed", lambda: shard_csr_packed(T, mesh)),
                       ("pattern", lambda: shard_csr_packed(
                           T, mesh, pattern=True))):
        sh = built(f"PageRank {what}", make)
        pagerank_sharded(sh, mask, pcfg)        # warm-up
        torch.cuda.synchronize()
        tk.reset_launch_counts()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        pr = pagerank_sharded(sh, mask, pcfg)
        stop.record()
        stop.synchronize()
        counts = tk.launch_counts()
        want = {k: PR_ITERS * v for k, v in sharded_launches(sh).items()}
        check(pr.error_code == 0 and pr.iterations == PR_ITERS
              and counts == want,
              f"sharded PageRank {what}: error {pr.error_code}, "
              f"{pr.iterations} iterations, launches {counts} ({want})")
        ranks = pr.ranks_host()
        err = np.abs(ranks - ref)
        check(ranks.shape == (n,) and bool(np.all(np.isfinite(ranks)))
              and bool(np.all(err <= PR_ATOL + PR_RTOL * np.abs(ref)))
              and bool(np.all(err <= PR_ATOL_TIGHT + PR_RTOL * np.abs(ref)))
              and abs(float(ranks.sum(dtype=np.float64)) - 1.0) < 1e-4,
              f"sharded PageRank {what} vs the float64 power iteration")
        log(f"sharded PageRank {what}: {PR_ITERS} iterations, "
            f"{start.elapsed_time(stop) / PR_ITERS:.4f} ms/iteration over "
            f"CUDA events; OK vs float64 (max|Δ| {float(err.max()):.3g}); "
            f"launches {counts}")
        del sh
    # one step on the flat form, against the float64 step
    r = np.full(n, 1.0 / n, np.float32)
    step = pagerank_step_sharded(shard_csr(T, mesh), r, mask).cpu().numpy()
    rows_t = np.repeat(np.arange(n), np.diff(T.row_ptrs))
    want = 0.85 * np.bincount(rows_t, T.values.astype(np.float64)
                              * r[T.col_indices], minlength=n) \
        + 0.85 * float(r[mask > 0].sum(dtype=np.float64)) / n + 0.15 / n
    check(bool(np.all(np.abs(step - want)
                      <= PR_ATOL_TIGHT + PR_RTOL * np.abs(want))),
          "sharded PageRank step vs the float64 step")
    log("sharded PageRank step (flat): OK vs the float64 step")


def phase_soak(dev) -> None:
    """Phase 16: the differential soak (``tpu_spmv_torch.soak``) on the
    card at a fixed seed, the sharded paths included, which must report no
    failure and launch each of K1's variants, its section epilogue, K2 and
    K3 (counts from 0 around it); then one plan per lever group of the fuzz
    slice (``soak.LEVER_CASES``) through the card's SpMV against the oracle
    and through :func:`hold_kernels` (each band of the banded one)."""
    import torch

    from tpu_spmv_torch import kernels as tk
    from tpu_spmv_torch import soak
    from tpu_spmv_torch.kernels import window_ell as twe
    from tpu_spmv_torch.utils.testing import spmv_matches

    tk.reset_launch_counts()
    rc = soak.main(["--trials", str(SOAK_TRIALS), "--seed", str(SOAK_SEED)])
    torch.cuda.synchronize()
    counts = tk.launch_counts()
    check(rc == 0, f"the soak on the card exited {rc}")
    check(all(counts.values()),
          f"the soak's paths left a kernel unlaunched: {counts}")
    log(f"soak: seed {SOAK_SEED}, launches {counts}")
    for name in soak.LEVER_CASES:
        A, x, hp = soak.lever_case(name)
        banded = name == "banded"
        plan = (twe.banded_from_host if banded else twe.plan_from_host)(
            hp, dev)
        xd = torch.from_numpy(x).to(dev)
        y = (twe.spmv_banded if banded else twe.spmv_window_ell)(plan, xd)
        inner = plan.plans[0] if banded else plan
        tol = BF16_TOL if inner.values == "bfloat16" else REL_TOL
        check(spmv_matches(y.cpu().numpy(), A, x, rel_tol=tol),
              f"fuzz lever {name}: the SpMV vs the oracle (rel {tol})")
        log(f"fuzz lever {name}: {A.num_rows}x{A.num_cols}, {A.nnz} nnz, "
            f"sup {inner.sup}, step {inner.step_groups}, tb {inner.tb}, "
            f"{inner.values}, leveled {inner.lam is not None}, "
            f"{len(plan.plans) if banded else 1} plan(s); OK vs oracle")
        hold_stack(plan, A, x, dev, f"fuzz lever {name}")


# phase 17: the keys of the port bench's line (bench.py:398-422, then the
# port's two) and its secondaries, each of which must be positive
BENCH_KEYS = ("spmv_over_stream", "stream_gb_s", "gflops", "gnnz_per_s",
              "nnz", "skewness", "occupancy", "winning_plan",
              "plan_fingerprints", "native_planner", "ell_stencil_gb_s",
              "web_graph_1m_gb_s", "pagerank_262k_ms_per_iter",
              "bf16_spmv_gb_s", "bf16_exact", "pattern_spmv_gb_s",
              "correct", "device", "plan_build_s")
BENCH_SECONDARIES = ("ell_stencil_gb_s", "web_graph_1m_gb_s",
                     "pagerank_262k_ms_per_iter", "bf16_spmv_gb_s",
                     "pattern_spmv_gb_s")
BENCH_GUARD = 1.02


def phase_bench() -> None:
    """Phase 17: ``python3 -m tpu_spmv_torch.bench`` as a user runs it, a
    subprocess at full size, which must exit 0 with its one line: the JAX
    bench's keys and the port's two, ``correct``, the winner one of the
    fingerprinted candidates, every secondary positive, and the winner's
    streamed GB/s (its ``final headline`` line on stderr) within 1.02 x
    the line's STREAM."""
    import re

    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=here + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run([sys.executable, "-m", "tpu_spmv_torch.bench"],
                          cwd=here, env=env, capture_output=True, text=True,
                          timeout=900)
    log("python -m tpu_spmv_torch.bench, its diagnostics:\n"
        + proc.stderr[-6000:])
    check(proc.returncode == 0, f"the bench exited {proc.returncode}")
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    log("port bench line: " + json.dumps(line))
    d = line["detail"]
    check(list(line) == ["metric", "value", "unit", "vs_baseline", "detail"]
          and tuple(d) == BENCH_KEYS, f"the bench line's keys: {list(d)}")
    check(line["metric"] == "merge_path_csr_spmv_bandwidth"
          and line["value"] > 0 and line["vs_baseline"] > 0,
          "the bench's metric")
    check(d["correct"] is True, "the bench's correct is not true")
    check(d["winning_plan"] in d["plan_fingerprints"],
          f"the winner {d['winning_plan']} is not a fingerprinted candidate")
    for key in BENCH_SECONDARIES:
        check(d[key] > 0, f"the bench's {key} is {d[key]}")
    final = re.findall(r"final headline .*\((\d+) GB/s streamed\)",
                       proc.stderr)
    check(len(final) == 1, "the bench printed no final headline line")
    check(float(final[0]) <= BENCH_GUARD * d["stream_gb_s"],
          f"the winner streams {final[0]} GB/s, over {BENCH_GUARD} x STREAM "
          f"{d['stream_gb_s']}")


def script_json(main, argv: list) -> tuple:
    """``main(argv)`` in this process, its stdout captured and logged:
    ``(exit code, the JSON of its last line)``."""
    import contextlib
    import io

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    log(out.getvalue().rstrip())
    return rc, json.loads(out.getvalue().strip().splitlines()[-1])


def correct_flags(obj) -> list:
    """Every ``*correct`` value in a JSON object, at any depth."""
    if isinstance(obj, dict):
        return [v for k, v in obj.items() if k.endswith("correct")] \
            + [f for v in obj.values() for f in correct_flags(v)]
    if isinstance(obj, list):
        return [f for v in obj for f in correct_flags(v)]
    return []


def phase_benchmarks() -> None:
    """Phase 18: the mains of ``tpu_spmv_torch.benchmarks``'s ``scaling``
    (its defaults: one row per card present), ``perf_properties`` (its
    defaults) and ``tune --quick`` in this process, each on the card,
    naming it; every ``correct`` true (a ring, leveled or pattern check is
    ``None`` where the packed layout rejects it).  ``perf_properties`` exits
    1 where a property is missed, a measurement, not a failure of the
    port."""
    import torch

    from tpu_spmv_torch.benchmarks import perf_properties, scaling, tune

    name = torch.cuda.get_device_name(0)
    for mod, argv in ((scaling, ["--json"]), (perf_properties, []),
                      (tune, ["--quick"])):
        t0 = time.perf_counter()
        rc, out = script_json(mod.main, argv)
        what = mod.__name__.rsplit(".", 1)[1]
        flags = correct_flags(out)
        log(f"{what} {' '.join(argv)}: exit {rc}, {len(flags)} correct "
            f"flags, {time.perf_counter() - t0:.1f} s")
        check(out["device"] == name, f"{what} names {out['device']}")
        check(flags and all(f in (True, None) for f in flags)
              and any(f is True for f in flags),
              f"{what}: a correct is not true")
        missed = mod is perf_properties and not (
            out["vector_csr_pass"] and out["merge_path_pass"])
        check(rc == 0 or (rc == 1 and missed), f"{what} exited {rc}")


def main() -> int:
    t_start = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available; this script runs "
              "the port on an NVIDIA GPU only", file=sys.stderr)
        return 2
    card = nvidia_smi()
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    log(f"device: {name}; nvidia-smi: {card}; torch {torch.__version__} "
        f"CUDA {torch.version.cuda}; {torch.cuda.device_count()} device(s)")
    from tpu_spmv_torch.bandwidth import measured_stream_bandwidth

    def run(fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        log(f"[{fn.__name__}: {time.perf_counter() - t0:.1f} s]")
        return out

    run(phase_build)
    stream = measured_stream_bandwidth(dev)
    log(f"STREAM (256 MB read-reduce): {stream:.1f} GB/s, the bounds' rate")
    run(phase_kernels, dev)
    run(phase_k3, dev)
    probe_records = run(phase_probes, dev, stream)
    kernels, A, x = run(phase_main, dev, stream)
    lever_record = run(phase_levers, dev, stream, A, x)
    run(phase_floors, dev, stream, A, x)
    run(phase_ell, dev, stream, A, x)
    del A, x
    k3_record, A, x, rp = run(phase_reorder, dev, stream)
    run(phase_plan_file_mesh, dev, rp, x)
    kernels.append(k3_record)
    kernels += probe_records[:-1]
    kernels.append(lever_record)
    W = run(phase_banded, dev, stream, A, x, rp)
    del A, x, rp
    kernels.append(run(phase_pagerank, dev, stream))
    kernels.append(probe_records[-1])
    run(phase_pagerank_1m, dev, stream, W)
    del W
    run(phase_wide, dev, stream)
    run(phase_reorder_ab, dev)
    run(phase_sharded, dev)
    run(phase_soak, dev)
    run(phase_bench)
    run(phase_benchmarks)
    check("jax" not in sys.modules, "JAX was imported")
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
