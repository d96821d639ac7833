"""The headline benchmark: merge-path CSR SpMV bandwidth against STREAM
(port of ``bench.py``).

    python3 -m tpu_spmv_torch.bench [--smoke] [--device cpu]

The target is 80% of the measured STREAM bandwidth on a skewed power-law
matrix, in the reference's byte model (``bandwidth.cpp:34-42``: ``nnz*8 +
(rows+1)*4 + cols*4`` read, ``rows*4`` written).  The flow is ``bench.py``'s,
step for step: the native planner library is required; the headline
matrix is ``RandomGenerator(42).power_law_csr(262144, 4096, avg 40, alpha
1.6)``; merge-path candidates are built at the JAX bench's step widths,
natural and leveled, each fingerprinted; each is checked against the CPU
oracle and timed under the physics guard (streamed bytes over time at most
1.02 × STREAM, three tries), and the fastest wins; then the flat path, the
ELL stencil, the 1M-node web graph, PageRank at 262,144 nodes, the bf16
value stream and the pattern path, and a late re-measure of the winner,
whose minimum with the first reading is the headline.

It prints one JSON line on stdout, ``bench.py``'s (``metric``, ``value``,
``unit``, ``vs_baseline`` = fraction of STREAM over 0.80, ``detail``),
with two more ``detail`` keys: ``device`` and ``plan_build_s`` (the
candidates' host build and the first one's upload, the seconds
``bench.py`` logs).  Diagnostics go to stderr.

Where it differs from ``bench.py``, it hides no failure: a candidate that
fails to build or fails the oracle, a secondary metric that raises or
fails its check, and a guard broken three times each end the run with a
non-zero exit and no JSON line; no raw reading is ever reported.

``--smoke`` runs the same flow at tiny sizes (the ``(8192, 2048, 12)``
matrix, step widths 8 and 16, 4 calls a sample, every secondary at a tiny
size).  ``--device cpu`` runs it on the CPU, the kernels' plain versions
serving and timed on the host clock; there STREAM is not measured, so
``stream_gb_s``, ``spmv_over_stream`` and ``vs_baseline`` are null and the
guard is not applied.  Without a card and without ``--device cpu`` it
raises :class:`~tpu_spmv_torch.errors.DeviceAllocError`.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import sys
import time

import numpy as np
import torch

from .bandwidth import _ell_bytes, measured_stream_bandwidth
from .csr import CSRMatrix
from .ell import ELLMatrix
from .errors import guarded_upload, target_device
from .kernels.plan import build
from .kernels.scalar import spmv_csr_scalar
from .kernels.window_ell import plan_from_host, spmv_pattern, spmv_window_ell
from .pagerank import PageRankConfig, pagerank
from .selector import spmv_auto_config
from .spmv import (MERGE_SPLIT_ROWS, KernelType, _run, spmv_csr,
                   spmv_ell)
from .timing import time_cuda, time_runs
from .utils.testing import (RandomGenerator, spmv_matches, stencil_csr,
                            transition_matrix, web_graph_csr)

METRIC = "merge_path_csr_spmv_bandwidth"
TARGET = 0.80               # vs_baseline = fraction of STREAM / TARGET
HEADLINE = (262144, 4096, 40.0)
SMOKE = (8192, 2048, 12.0)
ALPHA = 1.6
SEED = 42
# the candidates' step widths, natural and leveled (bench.py:102-104)
WIDTHS = {False: (128, 384), True: (128, 256, 384)}
SMOKE_WIDTHS = (8, 16)
ITERS, SMOKE_ITERS = 300, 4     # calls a timed sample
SAMPLES = 5
FLAT_ITERS = 3
WEB_ITERS = 100
GUARD = 1.02                # streamed GB/s at most GUARD x STREAM
GUARD_TRIES = 3
REL_TOL = 1e-5
BF16_TOL = 8e-3
# the secondaries' sizes: full, smoke
STENCIL_SIDE = (512, 32)
WEB_NODES = (1_000_000, 4096)
WEB_AVG = 15.0
PAGERANK_NODES = (262144, 2048)
PAGERANK_ITERS = 30
PR_CHECK_TOL = 1e-4


def log(*args) -> None:
    print(*args, file=sys.stderr, flush=True)


class BenchFailure(RuntimeError):
    """A check of the run failed: the oracle, a secondary metric's check or
    the physics guard.  The run ends with a non-zero exit."""


def model_bytes(rows: int, cols: int, nnz: int) -> int:
    """The reference CSR byte model (``bench.py:199``)."""
    return nnz * 8 + (rows + 1) * 4 + cols * 4 + rows * 4


def headline_rates(rows: int, cols: int, nnz: int, secs: float,
                   stream_gbs: float | None) -> dict:
    """Byte-model GB/s, GFLOP/s, Gnnz/s, the fraction of STREAM and
    ``vs_baseline`` of a call of ``secs`` (``bench.py:199-201``,
    ``:393-394``); the last two ``None`` where STREAM was not measured."""
    gb_s = model_bytes(rows, cols, nnz) / secs / 1e9
    frac = None if stream_gbs is None \
        else (gb_s / stream_gbs if stream_gbs > 0 else 0.0)
    return {"gb_s": gb_s, "gflops": 2.0 * nnz / secs / 1e9,
            "gnnz_per_s": nnz / secs / 1e9, "spmv_over_stream": frac,
            "vs_baseline": None if frac is None else frac / TARGET}


@dataclasses.dataclass(frozen=True)
class Clock:
    """How a benchmark times calls on its device: over CUDA events on the
    card (:func:`~tpu_spmv_torch.timing.time_cuda`), on the host clock on
    the CPU (:func:`~tpu_spmv_torch.timing.time_runs`), each the median of
    ``SAMPLES`` runs of ``iters`` calls; and the physics guard against
    STREAM, measured on the card (``None``, not measured, on the CPU)."""

    device: torch.device
    stream_gbs: float | None

    @staticmethod
    def on(device: torch.device) -> "Clock":
        stream = measured_stream_bandwidth(device) \
            if device.type == "cuda" else None
        return Clock(device, stream)

    @property
    def name(self) -> str:
        """The device's name, as every JSON the benchmarks print gives it."""
        return torch.cuda.get_device_name(self.device) \
            if self.device.type == "cuda" else "cpu"

    def seconds(self, fn, iters: int) -> float:
        if self.device.type == "cuda":
            return time_cuda(fn, iters=iters, samples=SAMPLES,
                             device=self.device)
        return statistics.median(time_runs(fn, self.device,
                                           num_runs=SAMPLES,
                                           iters_per_run=iters))

    def guarded(self, fn, stream_bytes: float, iters: int,
                what: str) -> float:
        """:meth:`seconds` of ``fn``, a reading implying more than ``GUARD``
        × STREAM of streamed bytes discarded and taken again, up to
        ``GUARD_TRIES`` times; raises :class:`BenchFailure` when every
        reading breaks the guard.  Unguarded where STREAM is not
        measured."""
        if self.stream_gbs is None:
            return self.seconds(fn, iters)
        for _ in range(GUARD_TRIES):
            s = self.seconds(fn, iters)
            if stream_bytes / s / 1e9 <= GUARD * self.stream_gbs:
                return s
            log(f"  [{what}] discarded: implies {stream_bytes/s/1e9:.0f} "
                f"GB/s streamed > STREAM {self.stream_gbs:.0f}")
        raise BenchFailure(f"{what}: {GUARD_TRIES} readings broke the "
                           "physics guard")


def check(ok: bool, what: str) -> None:
    if not ok:
        raise BenchFailure(what)


def fingerprint(hp) -> dict:
    """A plan's identity (``bench.py:114-117``)."""
    return {"groups": int(hp.n_groups),
            "occupancy": round(float(hp.occupancy), 4),
            "extras": int(hp.n_extra), "leveled": hp.lam is not None}


def candidates(csr: CSRMatrix, widths: dict) -> list:
    """The merge-path candidates, naturals first (``bench.py:92-125``):
    ``(tag, step width, leveled, host plan)`` for each width of
    ``widths[leveled]``, each fingerprint logged.  A leveled candidate
    whose leveling did not engage is dropped, as ``bench.py:120-123`` drops
    it.  The JAX bench keeps both step-width ends and a leveled middle: its
    plans are the JAX planner's, and the card may order them otherwise."""
    out = []
    for perm in (False, True):
        for S in widths[perm]:
            hp = build(csr, split_rows=MERGE_SPLIT_ROWS, step_groups=S,
                       permute_rows=perm)
            tag = f"S={S}{'+perm' if perm else ''}"
            log(f"  candidate [{tag}] fingerprint: {fingerprint(hp)}")
            if perm and hp.lam is None:
                log(f"  candidate [{tag}] REJECTED: permute_rows "
                    "requested but the leveling pass did not engage")
                continue
            out.append((tag, S, perm, hp))
    return out


def matches(y: torch.Tensor, csr: CSRMatrix, x: np.ndarray,
            rel_tol: float = REL_TOL) -> bool:
    return spmv_matches(y.cpu().numpy(), csr, x, rel_tol=rel_tol)


def sweep(cands: list, first, csr: CSRMatrix, x: np.ndarray,
          xd: torch.Tensor, clock: Clock, iters: int) -> tuple:
    """Each candidate on the device (``first``, the first one's device plan,
    already uploaded), held to the oracle at rel 1e-5 and timed under the
    guard (``bench.py:150-187``); each plan but the winner's is dropped
    once timed.  Returns ``(seconds, tag, device plan, host plan)`` of the
    fastest."""
    best = None
    for tag, _S, _perm, hp in cands:
        p = first if hp is cands[0][3] else plan_from_host(hp, clock.device)
        check(matches(spmv_window_ell(p, xd), csr, x),
              f"candidate [{tag}] failed the oracle at rel {REL_TOL}")
        s = clock.guarded(lambda: spmv_window_ell(p, xd), p.stream_bytes,
                          iters, tag)
        log(f"  [{tag}] {s*1e6:.1f} us ({p.stream_bytes/s/1e9:.0f} GB/s "
            "streamed)")
        if best is None or s < best[0]:
            best = (s, tag, p, hp)
        del p
    log(f"  winning candidate: {best[1]}")
    return best


def flat_seconds(csr: CSRMatrix, x: np.ndarray, xd: torch.Tensor,
                 clock: Clock) -> float:
    """The flat path (:func:`~tpu_spmv_torch.kernels.scalar.spmv_csr_scalar`
    on a ``DeviceCSR``), checked and timed over ``FLAT_ITERS`` calls."""
    dcsr = csr.to_device(clock.device)
    check(matches(spmv_csr_scalar(dcsr, xd), csr, x),
          "the flat path failed the oracle")
    return clock.seconds(lambda: spmv_csr_scalar(dcsr, xd), FLAT_ITERS)


def stencil_gb_s(g: int, xe: np.ndarray, clock: Clock, iters: int) -> float:
    """The ``g`` x ``g`` 5-point stencil as an ``ELLMatrix`` through
    ``spmv_ell`` (``bench.py:216-256``), checked against the oracle at
    rel 1e-5; GB/s in the ELL byte model.  On the card
    ``spmv_ell(measure=True)`` times it; on the CPU the plan that served
    it, on the host clock."""
    S = stencil_csr(g)
    E = ELLMatrix.from_csr(S)
    n = g * g
    cuda = clock.device.type == "cuda"
    r = spmv_ell(E, xe, measure=cuda, measure_iters=iters,
                 device=clock.device)
    check(r.error_code == 0 and spmv_matches(r.y_host(), S, xe,
                                             rel_tol=REL_TOL),
          f"ELL stencil failed (error code {r.error_code}) or the oracle")
    if cuda:
        secs = r.elapsed_ms / 1e3
    else:
        xd = guarded_upload(xe, clock.device)
        secs = clock.seconds(lambda: _run(r.plan, xd), iters)
    gbs = _ell_bytes(n, n, E.max_nnz_per_row) / secs / 1e9
    log(f"ELL 5-pt stencil {g}^2: {secs*1e6:.1f} us -> {gbs:.1f} GB/s "
        "(ELL byte model)")
    return gbs


def web_gb_s(W: CSRMatrix, xw: np.ndarray, clock: Clock) -> float:
    """The web graph through the public dispatch with its auto
    configuration (``bench.py:258-277``), checked at rel 1e-5; byte-model
    GB/s over ``WEB_ITERS`` calls (``spmv_csr(measure=True)`` on the card,
    the served plan on the host clock on the CPU)."""
    t0 = time.time()
    cuda = clock.device.type == "cuda"
    r = spmv_csr(W, xw, spmv_auto_config(W), measure=cuda,
                 measure_iters=WEB_ITERS, device=clock.device)
    check(r.error_code == 0 and spmv_matches(r.y_host(), W, xw,
                                             rel_tol=REL_TOL),
          f"web graph failed (error code {r.error_code}) or the oracle")
    if cuda:
        secs = r.elapsed_ms / 1e3
    else:
        xd = guarded_upload(xw, clock.device)
        secs = clock.seconds(lambda: _run(r.plan, xd), WEB_ITERS)
    gbs = model_bytes(W.num_rows, W.num_cols, W.nnz) / secs / 1e9
    log(f"web graph {W.num_rows}: {secs*1e3:.3f} ms -> {gbs:.1f} GB/s "
        f"(byte model), {type(r.plan).__name__}, total "
        f"{time.time()-t0:.0f}s")
    return gbs


def pagerank_ms_per_iter(T: CSRMatrix, device: torch.device) -> float:
    """Wall ms per iteration of ``pagerank`` on the column-normalised
    ``T``, 30 iterations at tolerance 0, after one warm-up run, host
    set-up included (``bench.py:279-306``), the device synchronised before
    the clock stops; the ranks must be finite and sum to 1 (1e-4)."""
    cfg = PageRankConfig(max_iterations=PAGERANK_ITERS, tolerance=0.0)
    pagerank(T, cfg, device=device)              # plans and uploads
    t0 = time.perf_counter()
    r = pagerank(T, cfg, device=device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    ms = (time.perf_counter() - t0) * 1e3 / max(r.iterations, 1)
    check(r.error_code == 0 and r.iterations == PAGERANK_ITERS,
          f"PageRank: error code {r.error_code}, {r.iterations} iterations")
    ranks = r.ranks.cpu().numpy()
    check(bool(np.all(np.isfinite(ranks)))
          and abs(float(ranks.sum(dtype=np.float64)) - 1.0) < PR_CHECK_TOL,
          "PageRank: ranks not finite or not summing to 1")
    log(f"PageRank {T.num_rows} ({type(r.plan).__name__}): {r.iterations} "
        f"iters, {ms:.3f} ms/iter wall")
    return ms


def lever_gb_s(csr: CSRMatrix, x: np.ndarray, xd: torch.Tensor, S: int,
               perm: bool, clock: Clock, iters: int, *,
               svals: np.ndarray | None = None) -> float:
    """The winning configuration's bf16 value stream (``svals`` None:
    ``bench.py:332-353``, checked at 8e-3), or the pattern path on the
    column-scaled twin ``A = B·diag(svals)`` of its structure
    (``bench.py:354-375``, at 1e-5), guarded; byte-model GB/s of the
    headline's bytes."""
    rows, cols = csr.num_rows, csr.num_cols
    if svals is None:
        what, tol, A = "bf16 value stream [exact=false]", BF16_TOL, csr
        p = plan_from_host(build(csr, split_rows=MERGE_SPLIT_ROWS,
                                 step_groups=S, permute_rows=perm,
                                 values_dtype="bfloat16"), clock.device)

        def call():
            return spmv_window_ell(p, xd)
    else:
        what, tol = "pattern SpMV (exact)", REL_TOL
        A = CSRMatrix(rows, cols, svals[csr.col_indices], csr.col_indices,
                      csr.row_ptrs)
        p = plan_from_host(build(A, split_rows=MERGE_SPLIT_ROWS,
                                 step_groups=S, permute_rows=perm,
                                 pattern=True), clock.device)
        scale = guarded_upload(svals, clock.device)

        def call():
            return spmv_pattern(p, scale, xd)
    check(matches(call(), A, x, tol), f"{what} failed the oracle at {tol}")
    s = clock.guarded(call, p.stream_bytes, iters, what)
    gbs = model_bytes(rows, cols, csr.nnz) / s / 1e9
    log(f"{what}: {s*1e6:.1f} us -> {gbs:.1f} GB/s byte-model "
        f"({p.stream_bytes/s/1e9:.0f} GB/s streamed)")
    return gbs


def _round(v: float | None, places: int) -> float | None:
    return None if v is None else round(v, places)


def run(smoke: bool, device: torch.device) -> dict:
    """The whole flow; returns the JSON line as a dict.  Raises
    :class:`BenchFailure` where a check fails, and whatever a build or a
    call raises."""
    from . import native

    t_start = time.time()
    native.require()
    log("native planner library: loaded")
    clock = Clock.on(device)
    log(f"device: {clock.name}")
    rng = RandomGenerator(SEED)
    rows, cols, avg = SMOKE if smoke else HEADLINE
    k = 1 if smoke else 0                # index of the secondaries' sizes
    iters = SMOKE_ITERS if smoke else ITERS
    csr = rng.power_law_csr(rows, cols, avg_nnz=avg, alpha=ALPHA)
    stats = csr.compute_stats()
    log(f"matrix: {rows}x{cols} nnz={csr.nnz} "
        f"avg={stats.avg_nnz_per_row:.1f} max_row={stats.max_nnz_per_row} "
        f"skew={stats.skewness:.1f}")
    log(f"auto-selector: {KernelType(spmv_auto_config(csr).kernel_type).name}")

    t0 = time.time()
    cands = candidates(csr, {p: SMOKE_WIDTHS for p in (False, True)}
                       if smoke else WIDTHS)
    first = plan_from_host(cands[0][3], device)
    plan_build_s = time.time() - t0
    log(f"plan: groups={first.n_groups} occupancy={cands[0][3].occupancy:.3f}"
        f" extras={first.n_extra} build+upload {plan_build_s:.1f}s")
    fingerprints = {tag: fingerprint(hp) for tag, _, _, hp in cands}
    params = {tag: (S, perm) for tag, S, perm, _ in cands}
    x = rng.vector(cols)
    xd = guarded_upload(x, device)
    log(f"measured STREAM: {clock.stream_gbs} GB/s")

    secs, best_tag, plan, plan_host = sweep(cands, first, csr, x, xd, clock,
                                            iters)
    del first
    r = headline_rates(rows, cols, csr.nnz, secs, clock.stream_gbs)
    log(f"merge-path spmv: {secs*1e3:.3f} ms -> {r['gb_s']:.2f} GB/s "
        f"(byte model), {r['gflops']:.2f} GFLOP/s, {r['gnnz_per_s']:.2f} "
        "Gnnz/s")
    s_flat = flat_seconds(csr, x, xd, clock)
    log(f"flat-path spmv: {s_flat*1e3:.3f} ms "
        f"({model_bytes(rows, cols, csr.nnz)/s_flat/1e9:.2f} GB/s) -> "
        f"merge-path speedup {s_flat/secs:.1f}x")

    # the secondaries, in the JAX bench's order of draws
    g = STENCIL_SIDE[k]
    ell_gbs = stencil_gb_s(g, rng.vector(g * g), clock, iters)
    n = WEB_NODES[k]
    W = web_graph_csr(rng, n, n, avg_nnz=WEB_AVG)
    web_gbs = web_gb_s(W, rng.vector(n), clock)
    del W
    n = PAGERANK_NODES[k]
    pr_ms = pagerank_ms_per_iter(
        transition_matrix(web_graph_csr(rng, n, n, avg_nnz=WEB_AVG)), device)
    S_win, perm_win = params[best_tag]
    bf16_gbs = lever_gb_s(csr, x, xd, S_win, perm_win, clock, iters)
    svals = rng.rng.uniform(0.5, 2.0, cols).astype(np.float32)
    pat_gbs = lever_gb_s(csr, x, xd, S_win, perm_win, clock, iters,
                         svals=svals)

    late = clock.guarded(lambda: spmv_window_ell(plan, xd),
                         plan.stream_bytes, iters, "late")
    secs = min(secs, late)
    r = headline_rates(rows, cols, csr.nnz, secs, clock.stream_gbs)
    log(f"final headline (min over run): {secs*1e3:.3f} ms -> "
        f"{r['gb_s']:.2f} GB/s ({plan.stream_bytes/secs/1e9:.0f} GB/s "
        "streamed)")
    log(f"SpMV/STREAM = {r['spmv_over_stream']} (target {TARGET}) -> "
        f"vs_baseline {r['vs_baseline']}; total {time.time()-t_start:.0f}s")
    return {
        "metric": METRIC,
        "value": round(r["gb_s"], 3),
        "unit": "GB/s",
        "vs_baseline": _round(r["vs_baseline"], 4),
        "detail": {
            "spmv_over_stream": _round(r["spmv_over_stream"], 4),
            "stream_gb_s": _round(clock.stream_gbs, 3),
            "gflops": round(r["gflops"], 3),
            "gnnz_per_s": round(r["gnnz_per_s"], 4),
            "nnz": csr.nnz,
            "skewness": round(stats.skewness, 1),
            "occupancy": round(plan_host.occupancy, 4),
            "winning_plan": best_tag,
            "plan_fingerprints": fingerprints,
            "native_planner": True,
            "ell_stencil_gb_s": round(ell_gbs, 3),
            "web_graph_1m_gb_s": round(web_gbs, 3),
            "pagerank_262k_ms_per_iter": round(pr_ms, 3),
            "bf16_spmv_gb_s": round(bf16_gbs, 3),
            "bf16_exact": False,
            "pattern_spmv_gb_s": round(pat_gbs, 3),
            "correct": True,
            "device": clock.name,
            "plan_build_s": round(plan_build_s, 3),
        },
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m tpu_spmv_torch.bench",
        description="Merge-path CSR SpMV bandwidth against STREAM; one "
                    "JSON line on stdout.")
    p.add_argument("--smoke", action="store_true",
                   help="the same flow at tiny sizes")
    p.add_argument("--device", default="cuda",
                   help="where to run: the card (default), or cpu")
    args = p.parse_args(argv)
    device = target_device(args.device, "bench")
    try:
        line = run(args.smoke, device)
    except BenchFailure as e:
        log(f"bench FAILED: {e}")
        return 1
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
