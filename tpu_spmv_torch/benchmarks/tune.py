"""The planner's tuning sweep (port of ``benchmarks/tune.py``).

    python3 -m tpu_spmv_torch.benchmarks.tune [--quick] [--device cpu]

Plans three matrix classes (a power-law matrix on 4,096 columns, a web
graph, a near-uniform dense one; a quarter of the rows with ``--quick``)
at every row split (none, 64, 128, 256) and cap margin (0.15, 0.3, 0.5),
and prints occupancy, extras, groups, ms a call (300 calls, median of 5),
byte-model GB/s and slot GB/s (6 B a slot) for each, a table on stdout.
Each plan is checked against the CPU oracle at rel 1e-5; a combination the
planner rejects (``WindowEllOverflow``) prints ``overflow``.  The last line
is one JSON object: ``device`` and the rows, each with ``correct``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from ..bench import Clock, model_bytes
from ..errors import guarded_upload, target_device
from ..kernels.plan import WindowEllOverflow, build
from ..kernels.window_ell import plan_from_host, spmv_window_ell
from ..utils.testing import RandomGenerator, spmv_matches, web_graph_csr

ITERS = 300
REL_TOL = 1e-5
SPLITS = (None, 64, 128, 256)
MARGINS = (0.15, 0.3, 0.5)


def matrices(rng: RandomGenerator, scale: int) -> dict:
    """The three classes at ``1 / scale`` of the rows, the JAX draws."""
    return {
        "powerlaw_unicol": rng.power_law_csr(65536 // scale, 4096,
                                             avg_nnz=24.0, alpha=1.6),
        "webgraph": web_graph_csr(rng, 65536 // scale, 65536 // scale,
                                  avg_nnz=24.0),
        "uniform_dense": rng.power_law_csr(32768 // scale, 1024,
                                           avg_nnz=64.0, alpha=8.0),
    }


def sweep_matrix(name: str, csr, x, clock: Clock, iters: int = ITERS,
                 splits=SPLITS, margins=MARGINS) -> list:
    """One row per split and margin, printed as it is measured."""
    xd = guarded_upload(x, clock.device)
    bm = model_bytes(csr.num_rows, csr.num_cols, csr.nnz)
    rows = []
    for split in splits:
        for margin in margins:
            t0 = time.time()
            try:
                hp = build(csr, split_rows=split, cap_margin=margin)
            except WindowEllOverflow as e:
                print(f"{name:17s} {str(split):>6s} {margin:>6.2f} "
                      f"overflow: {str(e)[:80]}", flush=True)
                rows.append({"matrix": name, "split": split,
                             "margin": margin, "overflow": True})
                continue
            plan = plan_from_host(hp, clock.device)
            ok = spmv_matches(spmv_window_ell(plan, xd).cpu().numpy(), csr,
                              x, rel_tol=REL_TOL)
            secs = clock.seconds(lambda: spmv_window_ell(plan, xd), iters)
            slots = plan.n_groups * 1024
            row = {"matrix": name, "split": split, "margin": margin,
                   "occupancy": round(hp.occupancy, 4),
                   "extras": plan.n_extra, "groups": plan.n_groups,
                   "ms": secs * 1e3, "model_gb_s": bm / secs / 1e9,
                   "slot_gb_s": slots * 6 / secs / 1e9, "correct": bool(ok),
                   "build_s": round(time.time() - t0, 3)}
            print(f"{name:17s} {str(split):>6s} {margin:>6.2f} "
                  f"{row['occupancy']:6.3f} {row['extras']:8d} "
                  f"{row['groups']:8d} {row['ms']:8.3f} "
                  f"{row['model_gb_s']:9.1f} {row['slot_gb_s']:9.1f} "
                  f"{'ok' if ok else 'WRONG':>7s}", flush=True)
            rows.append(row)
            del plan
    return rows


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m tpu_spmv_torch.benchmarks.tune")
    p.add_argument("--quick", action="store_true",
                   help="a quarter of the rows")
    p.add_argument("--device", default="cuda",
                   help="where to run: the card (default), or cpu")
    args = p.parse_args(argv)
    clock = Clock.on(target_device(args.device, "tune"))
    rng = RandomGenerator(42)
    print(f"{'matrix':17s} {'split':>6s} {'margin':>6s} {'occ':>6s} "
          f"{'extras':>8s} {'groups':>8s} {'ms':>8s} {'modelGB/s':>9s} "
          f"{'slotGB/s':>9s} {'correct':>7s}", flush=True)
    rows = []
    for name, csr in matrices(rng, 4 if args.quick else 1).items():
        rows += sweep_matrix(name, csr, rng.vector(csr.num_cols), clock)
    print(json.dumps({"device": clock.name, "rows": rows}), flush=True)
    return 0 if all(r.get("correct", True) for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
