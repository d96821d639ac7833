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
4. The main path at the headline size: merge-path ``spmv_csr`` on
   ``power_law_csr(262144, 4096, avg 40, alpha 1.6)`` (about 10.3M nnz)
   with the auto-selected configuration, checked against the CPU oracle,
   timed with CUDA events, and held to the physics guard (streamed bytes /
   time must not exceed 1.02 × measured STREAM).  Each kernel is then
   compared with, and timed beside, its plain version at the plan's shapes.
   Vector CSR (no row split) runs once against the oracle too.

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
    """The original-order rows of a fold output (plain unpermute)."""
    from tpu_spmv_torch.kernels.window_ell import unpermute_plain

    if plan.lam is None:
        return out[:plan.num_rows].cpu().numpy()
    return unpermute_plain(out, plan.lam, plan.num_rows).cpu().numpy()


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

    from tpu_spmv_torch.kernels import plan as tplan
    from tpu_spmv_torch.kernels import window_ell as twe
    from tpu_spmv_torch.utils.testing import RandomGenerator

    rng = RandomGenerator(42)
    A = rng.power_law_csr(*SMOKE)
    x = rng.vector(A.num_cols)
    xd = torch.from_numpy(x).to(dev)
    twe.reset_launch_counts()
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
    counts = twe.launch_counts()
    log(f"  K2 random lam: exact; launches in this phase {counts}")
    check(counts["window_ell_fold"] > 0 and counts["unpermute"] > 0,
          "a kernel's launch count did not move")


def phase_main(dev) -> list:
    import numpy as np
    import torch

    from tpu_spmv_torch import (KernelType, SpMVConfig, spmv_auto_config,
                                spmv_csr)
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
    twe.reset_launch_counts()
    res = spmv_csr(A, xd, cfg, measure=True, measure_iters=ITERS,
                   measure_samples=SAMPLES)
    torch.cuda.synchronize()
    counts = twe.launch_counts()
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
    table = twe.gather_table(plan, xd)
    out = twe.window_ell_fold(plan, table)
    ref = twe.window_ell_fold_plain(plan, table)
    torch.cuda.synchronize()
    k1_err = float((out - ref).abs().max())
    exc = max_row_excess(rows_of(out, plan), rows_of(ref, plan), A, x)
    check(exc <= 0, "K1 vs plain at the headline plan (row bound)")
    k1_ms = time_cuda(lambda: twe.window_ell_fold(plan, table),
                      iters=ITERS, samples=SAMPLES) * 1e3
    k1_plain_ms = time_cuda(lambda: twe.window_ell_fold_plain(plan, table),
                            iters=PLAIN_ITERS, samples=SAMPLES,
                            warmup=2) * 1e3
    lam = plan.lam
    k2 = twe.unpermute(out, lam, plan.num_rows)
    k2_ref = twe.unpermute_plain(out, lam, plan.num_rows)
    torch.cuda.synchronize()
    check(torch.equal(k2, k2_ref), "K2 vs plain at the headline plan")
    k2_err = float((k2 - k2_ref).abs().max())
    k2_ms = time_cuda(lambda: twe.unpermute(out, lam, plan.num_rows),
                      iters=ITERS, samples=SAMPLES) * 1e3
    k2_plain_ms = time_cuda(
        lambda: twe.unpermute_plain(out, lam, plan.num_rows),
        iters=ITERS, samples=SAMPLES) * 1e3
    log(f"K1 fold: {k1_ms * 1e3:.2f} us (plain {k1_plain_ms * 1e3:.2f} us), "
        f"max|Δ| {k1_err:.3g}; K2 unpermute: {k2_ms * 1e3:.2f} us (plain "
        f"{k2_plain_ms * 1e3:.2f} us), max|Δ| {k2_err}")

    # vector CSR: the same kernels, no row split
    vres = spmv_csr(A, xd, SpMVConfig(kernel_type=KernelType.VECTOR_CSR))
    check(vres.error_code == 0, f"vector spmv_csr {vres.error_code}")
    check(spmv_matches(vres.y.cpu().numpy(), A, x, rel_tol=REL_TOL),
          "vector-CSR output vs the CPU oracle")
    log(f"vector CSR (split_rows=None): OK vs oracle; plan groups "
        f"{vres.plan.n_groups}, extras {vres.plan.n_extra}, build "
        f"{vres.plan_seconds:.2f} s")
    return [
        {"name": "window_ell_fold", "route": "cuda",
         "source": "tpu_spmv_torch/csrc/window_ell.cu",
         "replaces": "tpu_spmv/kernels/window_ell.py:1313",
         "launches": counts["window_ell_fold"], "max_abs_err": k1_err,
         "ms": k1_ms, "plain_ms": k1_plain_ms},
        {"name": "unpermute", "route": "cuda",
         "source": "tpu_spmv_torch/csrc/unpermute.cu",
         "replaces": "tpu_spmv/kernels/window_ell.py:1463",
         "launches": counts["unpermute"], "max_abs_err": k2_err,
         "ms": k2_ms, "plain_ms": k2_plain_ms},
    ]


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
    kernels = phase_main(dev)
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
