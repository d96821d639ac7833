"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each raises on failure; nothing is caught and passed over):

1. Device: the card's name and power limit (``nvidia-smi``).
2. Build: the host planner library and the CUDA kernels, from the sources
   in this checkout.
3. Kernels against their plain PyTorch versions on the card: the
   window-ELL fold (K1) over plans of the bench's smoke matrix at every
   superblock height and run length, natural and leveled; the unpermute
   (K2) on a random ``lam``.
4. The chunk permute (K3) against its plain version, exactly: x not a
   whole number of chunks nor of float4s, ``src`` with repeats and chunks
   past the end of x, an output ending mid-chunk, a pointer that is not
   16-byte aligned, and a round trip (order, then its inverse) that gives x
   back bit for bit.
5. The main path at the headline size: merge-path ``spmv_csr`` on
   ``power_law_csr(262144, 4096, avg 40, alpha 1.6)`` (about 10.3M nnz)
   with the auto-selected configuration, checked against the CPU oracle,
   timed with CUDA events, and held to the physics guard (streamed bytes /
   time must not exceed 1.02 × measured STREAM).  Each kernel is then
   compared with, and timed beside, its plain version at the plan's shapes
   (K1 under the row bound, K2 and K3 exactly).
   Vector CSR (no row split) runs once against the oracle too.
6. The block-reordered path at full width: ``spmv_csr`` with the auto
   configuration (``reorder=None``: the probe decides) on
   ``scrambled_banded_csr(2^20, bandwidth 4096, avg 12)`` (about 13.5M nnz,
   a 2^20-node mesh), which must be served by a ``ReorderedPlan``, checked
   against the oracle, timed, held to the physics guard with both permutes'
   bytes, and counted: two K3, one K1 per inner section and one K2 launch
   per call.  Each kernel of the path (the x permute, K1 and K2 on the
   inner plan, the row permute) is then compared with, and timed beside,
   its plain version on the inputs the path gives it.
7. Natural against reordered at 262,144 rows, on the planted banded and
   clustered matrices: both plans timed (natural, reordered, reordered,
   natural) and checked against the oracle, and each plan's kernels against
   their plain versions.  A comparison, not a claim.

Everything before the last line is diagnostics.  The line before the
``nvidia-smi`` line is one JSON object with a record per kernel; the last
line is ``{"ok": true, "device": {...}}``.  Exits non-zero, and prints no
result, where no CUDA device is available.  Imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

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
# timing protocol of the main-path run (spmv_csr measure=True)
ITERS, SAMPLES = 100, 5
PLAIN_ITERS = 10


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

    rp = plan if isinstance(plan, ReorderedPlan) else None
    inner = rp.inner if rp else plan
    y = out[:inner.num_rows] if inner.lam is None \
        else unpermute_plain(out, inner.lam, inner.num_rows)
    if rp:
        y = permute_chunks_plain(y, rp.row_src, rp.num_rows)
    return y.cpu().numpy()


def hold_kernels(plan, xd, A, x, what: str, timed: bool) -> dict:
    """Each kernel of ``plan`` against its plain version on the inputs the
    path gives it: for a reordered plan the x permute (K3), then the inner
    plan's fold (K1, under the row bound), unpermute (K2) and the row
    permute (K3); K2 and K3 exactly.  With ``timed``, each is timed beside
    its plain version.  Returns ``{wrapper name: [(max_abs_err, ms,
    plain_ms), ...]}`` in path order; the times are ``None`` untimed."""
    import torch

    from tpu_spmv_torch.kernels import reorder as tr
    from tpu_spmv_torch.kernels import window_ell as twe
    from tpu_spmv_torch.timing import time_cuda

    rp = plan if isinstance(plan, tr.ReorderedPlan) else None
    inner = rp.inner if rp else plan
    held, parts = {}, []

    def hold(kernel, plain, *args, exact=True, plain_iters=ITERS):
        got, ref = kernel(*args), plain(*args)
        torch.cuda.synchronize()
        name = kernel.__name__
        check(not exact or torch.equal(got, ref),
              f"{name} differs from its plain version ({what})")
        err = float((got - ref).abs().max()) if got.numel() else 0.0
        ms = plain_ms = None
        if timed:
            ms = time_cuda(lambda: kernel(*args), iters=ITERS,
                           samples=SAMPLES) * 1e3
            plain_ms = time_cuda(lambda: plain(*args), iters=plain_iters,
                                 samples=SAMPLES, warmup=2) * 1e3
        held.setdefault(name, []).append((err, ms, plain_ms))
        parts.append(f"{name} max|Δ| {err:.3g}" + (
            f" {ms * 1e3:.2f} us (plain {plain_ms * 1e3:.2f} us)"
            if timed else ""))
        return got, ref

    xin = xd
    if rp:
        xin, _ = hold(tr.permute_chunks, tr.permute_chunks_plain, xd,
                      rp.col_src, inner.num_cols)
    table = twe.gather_table(inner, xin)
    out, ref = hold(twe.window_ell_fold, twe.window_ell_fold_plain, inner,
                    table, exact=False, plain_iters=PLAIN_ITERS)
    exc = max_row_excess(rows_of(out, plan), rows_of(ref, plan), A, x)
    check(exc <= 0, f"K1 vs its plain version, row bound ({what})")
    y = out[:inner.num_rows]
    if inner.lam is not None:
        y, _ = hold(twe.unpermute, twe.unpermute_plain, out, inner.lam,
                    inner.num_rows)
    if rp:
        hold(tr.permute_chunks, tr.permute_chunks_plain, y, rp.row_src,
             rp.num_rows)
    log(f"kernels vs plain, {what}: K1 row-bound excess {exc:.3g}; "
        + "; ".join(parts))
    return held


def kernel_record(name: str, held: dict, launches: int) -> dict:
    """The ``kernels`` JSON record of one wrapper: its first timed use in
    ``held`` (from :func:`hold_kernels`), the largest error of all."""
    source, replaces = {
        "window_ell_fold": ("window_ell.cu",
                            "tpu_spmv/kernels/window_ell.py:1313"),
        "unpermute": ("unpermute.cu", "tpu_spmv/kernels/window_ell.py:1463"),
        "permute_chunks": ("permute.cu", "tpu_spmv/kernels/reorder.py:225"),
    }[name]
    _, ms, plain_ms = held[name][0]
    return {"name": name, "route": "cuda",
            "source": "tpu_spmv_torch/csrc/" + source, "replaces": replaces,
            "launches": launches,
            "max_abs_err": max(e for e, _, _ in held[name]),
            "ms": ms, "plain_ms": plain_ms}


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
    from tpu_spmv_torch.utils.testing import RandomGenerator

    rng = RandomGenerator(42)
    A = rng.power_law_csr(*SMOKE)
    x = rng.vector(A.num_cols)
    xd = torch.from_numpy(x).to(dev)
    tk.reset_launch_counts()
    for sup in (1024, 4096, 16384):
        for tb in (2, 4, 8):
            for leveled in (False, True):
                hp = tplan.build(A, split_rows=128 if sup == 1024 else None,
                                 sup=sup, t_base=tb, permute_rows=leveled)
                plan = twe.plan_from_host(hp, dev)
                table = twe.gather_table(plan, xd)
                out = twe.window_ell_fold(plan, table)
                ref = twe.window_ell_fold_plain(plan, table)
                torch.cuda.synchronize()
                y, y_ref = rows_of(out, plan), rows_of(ref, plan)
                exc = max_row_excess(y, y_ref, A, x)
                log(f"  K1 sup={sup} tb={tb} leveled={leveled} sbn={hp.sbn} "
                    f"groups={hp.n_groups} sections={len(plan.sections)}: "
                    f"max|Δ|={float(np.max(np.abs(y - y_ref))):.3g} "
                    f"row-bound excess={exc:.3g}")
                check(exc <= 0, f"K1 row bound, sup={sup} tb={tb}")
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
    check(counts["window_ell_fold"] > 0 and counts["unpermute"] > 0,
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


def phase_main(dev) -> list:
    import numpy as np
    import torch

    from tpu_spmv_torch import (KernelType, SpMVConfig, spmv_auto_config,
                                spmv_csr)
    from tpu_spmv_torch import kernels as tk
    from tpu_spmv_torch.bandwidth import (get_gpu_peak_bandwidth,
                                          measured_stream_bandwidth)
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
    stream = measured_stream_bandwidth(dev)
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
    return [kernel_record(k, held, counts[k])
            for k in ("window_ell_fold", "unpermute")]


def phase_reorder(dev) -> dict:
    import numpy as np
    import torch

    from tpu_spmv_torch import KernelType
    from tpu_spmv_torch import kernels as tk
    from tpu_spmv_torch import spmv_auto_config, spmv_csr
    from tpu_spmv_torch.bandwidth import measured_stream_bandwidth
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
    stream = measured_stream_bandwidth(dev)
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
    return kernel_record("permute_chunks", held, counts["permute_chunks"])


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
    phase_build()
    phase_kernels(dev)
    phase_k3(dev)
    kernels = phase_main(dev)
    kernels.append(phase_reorder(dev))
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
