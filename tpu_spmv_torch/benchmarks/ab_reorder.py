"""Block reordering against the natural plan, on the device (port of
``benchmarks/ab_reorder.py``).

    python3 -m tpu_spmv_torch.benchmarks.ab_reorder [--rows N]
        [--device cpu]

First the public chunk permute (K3) of an ``N``-element x through a random
chunk order, timed alone (300 calls, median of 5; the copy's bytes under
the physics guard).  Then, for a scrambled banded matrix, a scrambled
clustered one and an iid web graph (reordering forced on it: the
no-regression leg), the dispatch probe's verdict, the packing model's cost
natural against permuted, and both plans (``build_auto`` of the matrix,
and of the matrix permuted by the block order) held to the CPU oracle at
rel 1e-5 and timed (100 calls, median of 5) under the guard; a plan no
packed layout takes (``WindowEllOverflow``) is reported, not timed.  The
last line is one JSON object, ``device`` and the rows.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from ..bench import model_bytes
from ..errors import guarded_upload
from ..kernels.plan import WindowEllOverflow, build_auto
from ..kernels.reorder import (block_order, build_reordered_host,
                               maybe_reorder, reorder_gain,
                               reordered_from_host)
from ..kernels.window_ell import permute_chunks
from ..spmv import _run, _upload
from ..utils.testing import (RandomGenerator, clustered_csr,
                             scrambled_banded_csr, web_graph_csr)
from . import checked_seconds, device_main, occupancy

PERMUTE_ITERS, ITERS = 300, 100


def permute_row(x: np.ndarray, clock, iters: int = PERMUTE_ITERS) -> dict:
    """K3 as the public permute of ``x`` through a random chunk order."""
    n = x.size
    nb = -(-n // 128)
    xs = guarded_upload(x, clock.device)
    src = guarded_upload(np.random.default_rng(0).permutation(nb)
                         .astype(np.int32), clock.device)
    s = clock.guarded(lambda: permute_chunks(xs, src, nb * 128), 2 * n * 4,
                      iters, "permute_chunks")
    print(f"permute_chunks({n}): {s*1e6:.1f} us "
          f"({2 * n * 4 / s / 1e9:.0f} GB/s copy rate)", flush=True)
    return {"label": f"permute_chunks({n})", "t_us": s * 1e6,
            "copy_gb_s": 2 * n * 4 / s / 1e9}


def reorder_case(name: str, csr, x: np.ndarray, clock,
                 iters: int = ITERS) -> list:
    """Natural against reordered plans of one matrix."""
    bm = model_bytes(csr.num_rows, csr.num_cols, csr.nnz)
    t0 = time.time()
    probe = maybe_reorder(csr)
    print(f"[{name}] nnz={csr.nnz} probe="
          f"{'apply' if probe is not None else 'skip'} "
          f"({time.time() - t0:.1f}s)", flush=True)
    order = probe if probe is not None else block_order(csr)
    nat_c, prm_c = reorder_gain(csr, order)
    print(f"[{name}] model cost nat={nat_c:.3g} prm={prm_c:.3g} "
          f"ratio={prm_c / nat_c:.3f}", flush=True)
    xd = guarded_upload(x, clock.device)
    rows = []
    for label in ("natural", "reordered"):
        t0 = time.time()
        try:
            inner = build_auto(csr) if label == "natural" \
                else build_reordered_host(csr, order)[0]
        except WindowEllOverflow as e:
            print(f"[{name}] {label}: no packed layout ({e})", flush=True)
            rows.append({"label": f"{name} {label}", "overflow": True})
            continue
        plan = _upload(inner, clock.device) if label == "natural" \
            else reordered_from_host(inner, order, csr.num_rows,
                                     csr.num_cols, clock.device)
        build_s = time.time() - t0
        s = checked_seconds(f"[{name}] {label}", lambda: _run(plan, xd), csr,
                            x, plan.stream_bytes, clock, iters)
        n_plans = len(getattr(inner, "plans", (1,)))
        rows.append({"label": f"{name} {label}", "probe": probe is not None,
                     "model_ratio": prm_c / nat_c,
                     "kind": f"{type(inner).__name__}/{n_plans}",
                     "sup": inner.sup, "groups": inner.n_groups,
                     "occupancy": round(occupancy(inner), 4),
                     "build_s": round(build_s, 2), "t_ms": s * 1e3,
                     "gb_s": bm / s / 1e9, "correct": True})
        print(f"[{name}] {label}: kind={rows[-1]['kind']} sup={inner.sup} "
              f"groups={inner.n_groups} occ={occupancy(inner):.4f} "
              f"build={build_s:.0f}s ok=True t={s*1e3:.3f} ms = "
              f"{bm/s/1e9:.2f} GB/s", flush=True)
    if all("t_ms" in r for r in rows):
        print(f"[{name}] reorder speedup: "
              f"{rows[0]['t_ms'] / rows[1]['t_ms']:.2f}x", flush=True)
    return rows


def run(clock, args) -> list:
    rng = RandomGenerator(42)
    rows = [permute_row(rng.vector(args.rows), clock)]
    cases = (
        ("banded", lambda: scrambled_banded_csr(
            rng, args.rows, bandwidth=4096, avg_nnz=12.0)),
        ("clustered", lambda: clustered_csr(
            rng, args.rows, n_clusters=32, avg_nnz=14.0)),
        ("iid-web", lambda: web_graph_csr(
            rng, args.rows, args.rows, avg_nnz=15.0)),
    )
    for name, gen in cases:
        csr = gen()
        rows += reorder_case(name, csr, rng.vector(csr.num_cols), clock)
    return rows


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="tpu_spmv_torch.benchmarks.ab_reorder")
    p.add_argument("--rows", type=int, default=262_144)
    return device_main(p, argv, run)


if __name__ == "__main__":
    sys.exit(main())
