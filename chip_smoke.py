"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each raises on failure; nothing is caught and passed over):

1. Device: the card's name and power limit (``nvidia-smi``).
2. Build: the host planner library and the CUDA kernels, from the sources
   in this checkout.
3. Kernels against their plain PyTorch versions on the card: the
   window-ELL fold (K1) over plans of the bench's smoke matrix at every
   superblock height and run length, natural and leveled, in each of its
   three variants: f32 values, bf16 values, and none (pattern plans: the
   nibble-15 sentinel at superblock height 1024, -1 at 4096 and 16384),
   the bf16 and pattern plans merge-path with extras sections that publish;
   the unpermute (K2) on a random ``lam``.
4. The chunk permute (K3) against its plain version, exactly: x not a
   whole number of chunks nor of float4s, ``src`` with repeats and chunks
   past the end of x, an output ending mid-chunk, a pointer that is not
   16-byte aligned, and a round trip (order, then its inverse) that gives x
   back bit for bit.
5. The benchmark probes' ports (``tpu_spmv_torch/probes``: P4 the stage
   split of K1, P2 and P3 the scatter candidates, P5 the block re-read, P1
   the round-2 inner-loop candidates, its table-in-output modes defined on
   head rows seeded with x2d):
   every mode of each probe's kernel against its plain version at a reduced
   size (fp32 sums in another order, and in P2 and P3 atomic adds in no
   fixed order: ``|Δ| <= 1e-5 * (|ref| + max|ref|)``), S = 24 refused by
   P1, P2 and P3 (``ValueError``); then the probes' entry point, each probe's
   ``time_modes`` at its JAX main's default size (P4 at S = 128 only),
   printing the JAX scripts' lines under the physics guard, with the launch
   counts from 0; then each mode against its plain version at that size,
   timed beside it.
6. The main path at the headline size: merge-path ``spmv_csr`` on
   ``power_law_csr(262144, 4096, avg 40, alpha 1.6)`` (about 10.3M nnz)
   with the auto-selected configuration, checked against the CPU oracle,
   timed with CUDA events, and held to the physics guard (streamed bytes /
   time must not exceed 1.02 × measured STREAM).  Each kernel is then
   compared with, and timed beside, its plain version at the plan's shapes
   (K1 under the row bound, K2 and K3 exactly).
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
   against the oracle, timed, held to the physics guard with both permutes'
   bytes, and counted: two K3, one K1 per inner section and one K2 launch
   per call.  Each kernel of the path (the x permute, K1 and K2 on the
   inner plan, the row permute) is then compared with, and timed beside,
   its plain version on the inputs the path gives it.
8. Natural against reordered at 262,144 rows, on the planted banded and
   clustered matrices: both plans timed (natural, reordered, reordered,
   natural) and checked against the oracle, and each plan's kernels against
   their plain versions.  A comparison, not a claim.
9. PageRank at full width: the JAX bench's 262,144-node web graph
   (``bench.py:279-306``), column-normalised, through ``pagerank`` for 30
   iterations at tolerance 0 after one warm-up run.  It must run on a
   pattern plan at superblock height 4096 with one K1 (pattern variant)
   launch per section and one K2 launch per iteration, and match a float64
   power iteration on the host (``rtol 1e-4, atol 1e-7``, ``|Σr - 1| <
   1e-4``, and at ``atol 1e-9``, which a bf16-rounded table fails); K1 and
   K2 are held to their plain versions on its inputs, x the ranks times n
   so that every row's bound is set by its own values and not by the
   bound's floor.  The time per iteration is printed over the call.  Then a
   run at the default tolerance reports its iterations.

Where one PyTorch call computes what a kernel computes, it is timed beside
it and printed on a ``library:`` line (cuSPARSE through a sparse CSR tensor
for K1 and K2 together, ``take_along_dim`` for K2, ``index_select`` for
K3); the port never calls them.  Each kernel's bound is the least time the
card could take for its work: its bytes (each input read once, each output
written once) over the STREAM rate measured in this run, or its fp32
operations over the 67 TFLOP/s fp32 peak, whichever is larger.

Everything before the last line is diagnostics.  The line before the
``nvidia-smi`` line is one JSON object with a record per kernel (K1's f32
variant, K2, K3, the probes P4, P2, P3, P5, K1's bf16 and pattern variants,
P1); the last line is ``{"ok": true, "device": {...}}``.  Exits non-zero,
and prints no result, where no CUDA device is available.  Imports nothing
of JAX.
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
# natural against reordered at 262,144 rows: (generator, args)
AB = (("scrambled_banded_csr", (262144, 4096, 12.0)),
      ("clustered_csr", (262144, 32, 14.0)))
REL_TOL = 1e-5
BF16_TOL = 8e-3     # bf16 value rounding (bench.py:337)
# PageRank: the JAX bench's web graph (bench.py:291) and its iterations
PAGERANK = (262144, 15.0)
PR_ITERS = 30
PR_RTOL, PR_ATOL = 1e-4, 1e-7
# the same check at an absolute tolerance a bf16-rounded table fails (the
# ranks are about 1/n = 3.8e-6)
PR_ATOL_TIGHT = 1e-9
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


def time_ms(fn, iters: int = ITERS) -> float:
    """ms per ``fn()`` call on the card (CUDA events, median of
    ``SAMPLES`` runs of ``iters`` calls)."""
    from tpu_spmv_torch.timing import time_cuda

    return time_cuda(fn, iters=iters, samples=SAMPLES,
                     warmup=min(10, iters)) * 1e3


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


def hold_kernels(plan, xd, A, x, what: str, timed: bool) -> dict:
    """Each kernel of ``plan`` against its plain version on the inputs the
    path gives it: for a reordered plan the x permute (K3), then the inner
    plan's fold (K1, under the row bound), unpermute (K2) and the row
    permute (K3); K2 and K3 exactly.  A pattern plan's fold gathers from the
    scaled x, as ``spmv_pattern`` feeds it.  With ``timed``, each is timed
    beside its plain version and its library call (cuSPARSE on ``A`` for
    the fold, which must match the oracle; ``take_along_dim`` for K2,
    ``index_select`` for K3).  Returns ``{kernel record name: [{"err",
    "ms", "plain_ms", "library_ms", "nbytes", "ops"}, ...]}`` in path order;
    the times are ``None`` untimed."""
    import torch

    from tpu_spmv_torch.kernels import FOLD_VARIANTS
    from tpu_spmv_torch.kernels import reorder as tr
    from tpu_spmv_torch.kernels import window_ell as twe
    from tpu_spmv_torch.spmv import PatternPlan
    from tpu_spmv_torch.timing import time_cuda
    from tpu_spmv_torch.utils.testing import spmv_matches

    rp = plan if isinstance(plan, tr.ReorderedPlan) else None
    pp = plan if isinstance(plan, PatternPlan) else None
    inner = rp.inner if rp else pp.plan if pp else plan
    held, parts = {}, []

    def hold(name, kernel, plain, *args, nbytes, ops=0.0, library=None,
             exact=True, plain_iters=ITERS):
        got, ref = kernel(*args), plain(*args)
        torch.cuda.synchronize()
        check(not exact or torch.equal(got, ref),
              f"{name} differs from its plain version ({what})")
        rec = {"err": float((got - ref).abs().max()) if got.numel() else 0.0,
               "ms": None, "plain_ms": None, "library_ms": None,
               "nbytes": nbytes, "ops": ops}
        if timed:
            rec["ms"] = time_ms(lambda: kernel(*args))
            rec["plain_ms"] = time_cuda(lambda: plain(*args),
                                        iters=plain_iters, samples=SAMPLES,
                                        warmup=2) * 1e3
            if library is not None:
                rec["library_ms"] = time_ms(library)
        held.setdefault(name, []).append(rec)
        parts.append(f"{name} max|Δ| {rec['err']:.3g}" + (
            f" {rec['ms'] * 1e3:.2f} us (plain {rec['plain_ms'] * 1e3:.2f} "
            f"us" + ("" if rec["library_ms"] is None else
                     f", library {rec['library_ms'] * 1e3:.2f} us") + ")"
            if timed else ""))
        return got, ref

    def permute_library(v, src):
        n = src.numel() * 128
        v2 = torch.zeros(n, dtype=v.dtype, device=v.device)
        v2[:min(n, v.numel())] = v[:n]
        v2, s64 = v2.view(-1, 128), src.long()
        return lambda: v2.index_select(0, s64)

    xin = xd
    if rp:
        xin, _ = hold("permute_chunks", tr.permute_chunks,
                      tr.permute_chunks_plain, xd, rp.col_src,
                      inner.num_cols, nbytes=tr.permute_bytes(inner.num_cols),
                      library=permute_library(xd, rp.col_src))
    if pp:
        xin = pp.scale * xd
    table = twe.gather_table(inner, xin)
    k2_bytes = 0 if inner.lam is None else inner.lam.numel() * 12
    live_slots = sum(int(s.cta_ptr[-1]) for s in inner.sections) \
        * inner.tb * 8 * 128
    M = cusparse(A, xd.device) if timed else None
    fold = FOLD_VARIANTS[inner.values]
    out, ref = hold(fold, twe.window_ell_fold, twe.window_ell_fold_plain,
                    inner, table, nbytes=inner.stream_bytes - k2_bytes,
                    ops=2.0 * live_slots,
                    library=None if M is None else lambda: M @ xd,
                    exact=False, plain_iters=PLAIN_ITERS)
    exc = max_row_excess(rows_of(out, plan), rows_of(ref, plan), A, x)
    check(exc <= 0, f"K1 vs its plain version, row bound ({what})")
    if M is not None:
        check(spmv_matches((M @ xd).cpu().numpy(), A, x, rel_tol=REL_TOL),
              f"the library call (cuSPARSE) vs the oracle ({what})")
    y = out[:inner.num_rows]
    if inner.lam is not None:
        yp = twe._pad_tiles(out, inner.lam.shape[0])
        lam64 = inner.lam.long()
        y, _ = hold("unpermute", twe.unpermute, twe.unpermute_plain, out,
                    inner.lam, inner.num_rows, nbytes=k2_bytes,
                    library=lambda: torch.take_along_dim(yp, lam64, 1))
    if rp:
        hold("permute_chunks", tr.permute_chunks, tr.permute_chunks_plain, y,
             rp.row_src, rp.num_rows, nbytes=tr.permute_bytes(rp.num_rows),
             library=permute_library(y, rp.row_src))
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
          and counts["unpermute"] > 0, "a kernel's launch count did not move")


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
        for inp in small.values():
            err = hold_probe(name, mod, inp, "reduced")
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
        + "; S=24 refused by proto_v2, proto_v3 and proto_v4")

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

    # each mode against its plain version at that size, timed beside it
    records = []
    for name, mod in mods.items():
        ms = plain_ms = nbytes = ops = 0.0
        # a mode the main lists twice (P4's +scatter8, P1's three) keeps its
        # first time
        kernel_ms = {r["mode"]: r["ms"] for r in reversed(timed[name])}
        for mode in dict.fromkeys(mod.MAIN_MODES):
            inp = inputs[name][mode]
            err = hold_probe(name, mod, inp, "default size")
            errs[name] = max(errs[name], err)
            p_ms = time_cuda(lambda: mod.probe_plain(inp), iters=2, samples=1,
                             warmup=1) * 1e3
            b_ms, _ = bound(inp.nbytes, 2.0 * inp.vals.numel(), stream)
            log(f"  {name} {mode}: kernel {kernel_ms[mode]:.3f} ms, plain "
                f"{p_ms:.3f} ms, bound {b_ms:.3f} ms, max|Δ| {err:.3g}")
            ms += kernel_ms[mode]
            plain_ms += p_ms
            nbytes += inp.nbytes
            ops += 2.0 * inp.vals.numel()
        records.append(record(name, *PROBE_SOURCES[name], counts[name],
                              errs[name], ms, plain_ms, nbytes, ops, None,
                              stream))
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
    check(counts["window_ell_fold"] == calls * len(plan.sections),
          "K1 did not launch once per section per call")
    check(counts["unpermute"] == (calls if plan.lam is not None else 0),
          "K2 did not launch once per call")
    check(counts["window_ell_fold"] > 0 and counts["unpermute"] > 0,
          "a kernel of the main path was not launched")
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
        "tb": plan.tb, "sbn": plan.sbn, "sections": len(plan.sections),
        "ctas": [s.n_cta for s in plan.sections]}))
    log(f"plan build + upload: {res.plan_seconds:.2f} s (host planner, "
        f"no JAX)")

    secs = res.elapsed_ms / 1e3
    peak = get_gpu_peak_bandwidth(dev.index or 0)
    actual = plan.stream_bytes / secs / 1e9

    def plain_spmv():
        out = twe.window_ell_fold_plain(plan, twe.gather_table(plan, xd))
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
    held = hold_kernels(plan, xd, A, x, "headline", timed=True)

    # vector CSR: the same kernels, no row split
    vres = spmv_csr(A, xd, SpMVConfig(kernel_type=KernelType.VECTOR_CSR))
    check(vres.error_code == 0, f"vector spmv_csr {vres.error_code}")
    check(spmv_matches(vres.y.cpu().numpy(), A, x, rel_tol=REL_TOL),
          "vector-CSR output vs the CPU oracle")
    log(f"vector CSR (split_rows=None): OK vs oracle; plan groups "
        f"{vres.plan.n_groups}, extras {vres.plan.n_extra}, build "
        f"{vres.plan_seconds:.2f} s")
    return [kernel_record(k, held, counts[k], stream)
            for k in ("window_ell_fold", "unpermute")], A, x


def phase_reorder(dev, stream: float) -> dict:
    import numpy as np
    import torch

    from tpu_spmv_torch import KernelType
    from tpu_spmv_torch import kernels as tk
    from tpu_spmv_torch import spmv_auto_config, spmv_csr
    from tpu_spmv_torch.kernels import reorder as tr
    from tpu_spmv_torch.spmv import MEASURE_WARMUP, MERGE_SPLIT_ROWS
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
    check(counts["permute_chunks"] == 2 * calls,
          "K3 did not launch twice per call")
    check(counts["window_ell_fold"] == calls * len(inner.sections),
          "K1 did not launch once per inner section per call")
    check(inner.lam is not None and counts["unpermute"] == calls,
          "K2 did not launch once per call")
    y = res.y.cpu().numpy()
    check(y.shape == (A.num_rows,) and bool(np.all(np.isfinite(y))),
          "output shape / finiteness")
    check(spmv_matches(y, A, x, rel_tol=REL_TOL),
          "reordered output vs the CPU oracle")
    log("correctness vs CPU oracle (rel 1e-5): OK")
    log("reordered plan: " + json.dumps({
        "sup": inner.sup, "groups": inner.n_groups,
        "occupancy": round(inner.occupancy, 4), "extras": inner.n_extra,
        "leveled": inner.lam is not None, "step_groups": inner.step_groups,
        "tb": inner.tb, "sbn": inner.sbn, "sections": len(inner.sections),
        "ctas": [s.n_cta for s in inner.sections],
        "blocks": len(rp.col_src)}))
    log(f"host: probe {probe_s:.2f} s (run alone); plan resolution "
        f"{res.plan_seconds:.2f} s (probe, permuted build, upload)")

    secs = res.elapsed_ms / 1e3
    actual = rp.stream_bytes / secs / 1e9
    log(f"reordered spmv: {res.elapsed_ms * 1e3:.2f} us/call (median of "
        f"{SAMPLES} x {ITERS} calls), {res.gflops:.2f} GFLOP/s, byte model "
        f"{res.bandwidth_gb_s:.1f} GB/s, streamed {actual:.1f} GB/s "
        f"({rp.stream_bytes / 1e6:.2f} MB/call, of which permutes "
        f"{(rp.stream_bytes - inner.stream_bytes) / 1e6:.2f} MB); STREAM "
        f"{stream:.1f} GB/s")
    check(actual <= 1.02 * stream,
          f"physics guard: {actual:.1f} GB/s streamed > 1.02 x STREAM")

    # each kernel against its plain version at the reordered path's shapes
    held = hold_kernels(rp, xd, A, x, "mesh, reordered", timed=True)
    log(f"K3 permutes: x {inner.num_cols} elements "
        f"({tr.permute_bytes(inner.num_cols) / 1e6:.2f} MB), y {rp.num_rows} "
        f"elements ({tr.permute_bytes(rp.num_rows) / 1e6:.2f} MB)")
    return kernel_record("permute_chunks", held, counts["permute_chunks"],
                         stream)


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
              == counts[fold], f"headline {what}: K1 launches {counts}")
        check(counts["unpermute"] == (calls if plan.lam is not None else 0),
              f"headline {what}: K2 did not launch once per call")
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
            f"sections {[s.n_cta for s in plan.sections]}; plan build "
            f"{res.plan_seconds:.2f} s")
        check(actual <= 1.02 * stream,
              f"physics guard: headline {what} {actual:.1f} GB/s streamed")
        held = hold_kernels(res.plan, xd, M, x, f"headline, {what}",
                            timed=True)
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
          == 0, f"PageRank: K1 launches {counts}")
    check(plan.lam is not None and counts["unpermute"] == PR_ITERS,
          "PageRank: K2 did not launch once per iteration")
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
    per_cta = [np.diff(s.cta_ptr.cpu().numpy()) for s in plan.sections]
    log(f"PageRank: {res.iterations} iterations, launches {counts}; OK vs "
        f"float64 power iteration (max|Δ| {float(err.max()):.3g}, rtol "
        f"{PR_RTOL}, atol {PR_ATOL} and {PR_ATOL_TIGHT}), Σr = "
        f"{float(ranks.sum()):.7f}")
    log("PageRank plan: " + json.dumps({
        "sup": plan.sup, "groups": plan.n_groups,
        "occupancy": round(plan.occupancy, 4), "sbn": plan.sbn,
        "leveled": plan.lam is not None, "step_groups": plan.step_groups,
        "tb": plan.tb, "ctas": [s.n_cta for s in plan.sections],
        "runs": [int(c.sum()) for c in per_cta],
        "max_runs_per_cta": [int(c.max()) for c in per_cta],
        "stream_mb": round(plan.stream_bytes / 1e6, 2)}))
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
                        "PageRank", timed=True)
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

    phase_build()
    stream = measured_stream_bandwidth(dev)
    log(f"STREAM (256 MB read-reduce): {stream:.1f} GB/s, the bounds' rate")
    phase_kernels(dev)
    phase_k3(dev)
    probe_records = phase_probes(dev, stream)
    kernels, A, x = phase_main(dev, stream)
    lever_record = phase_levers(dev, stream, A, x)
    del A, x
    kernels.append(phase_reorder(dev, stream))
    kernels += probe_records[:-1]
    kernels.append(lever_record)
    kernels.append(phase_pagerank(dev, stream))
    kernels.append(probe_records[-1])
    phase_reorder_ab(dev)
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
