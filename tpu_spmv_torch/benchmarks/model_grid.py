"""The superblock selector against full builds (port of
``benchmarks/model_grid.py``).

    python3 -m tpu_spmv_torch.benchmarks.model_grid [--out FILE]

For each matrix of a grid spanning the structure classes (power law,
uniform and varying rows, web graphs, clustered and scrambled banded
locality, a mid-depth band), the ground truth is a full build at every
superblock height (a banded rescue where the single build overflows, as
``build_auto`` escalates), each scored at the planner's per-slot rates;
the selector's choice (``_choose_sup``, measure-and-pick on the ambiguous
cases) must cost at most 1.10 × the best on at least 90% of the grid.  It
is host planning only: no device work, so no ``--device``; its JSON names
the host.  The exit code is 1 where the grid misses its target.
"""

from __future__ import annotations

import argparse
import json
import platform
import sys
import time

from ..bench import log
from ..csr import _bucket
from ..kernels import plan as tplan
from ..utils.testing import (RandomGenerator, clustered_csr,
                             scrambled_banded_csr, web_graph_csr)
from .perf_properties import _uniform_csr, _varying_csr

WITHIN = 1.10
TARGET = 0.90


def build_grid(rng: RandomGenerator) -> list:
    """``(name, csr, split_rows)`` cases, the JAX grid's draws."""
    cases = []
    for alpha in (1.2, 1.5, 2.0):
        for avg in (8, 32):
            m = rng.power_law_csr(131072, 4096, avg_nnz=float(avg),
                                  alpha=alpha)
            cases.append((f"power_law a={alpha} avg={avg}", m, 128))
    cases.append(("uniform 131k x 4k avg=32",
                  _uniform_csr(rng, 131072, 4096, 32), 128))
    cases.append(("uniform 131k x 4k avg=128",
                  _uniform_csr(rng, 131072, 4096, 128), 128))
    cases.append(("varying 131k x 4k avg=32",
                  _varying_csr(rng, 131072, 4096, 32), None))
    cases.append(("web_graph 65k", web_graph_csr(rng, 65536, 65536,
                                                 avg_nnz=12.0), None))
    cases.append(("web_graph 262k", web_graph_csr(rng, 262144, 262144,
                                                  avg_nnz=15.0), None))
    cases.append(("web_graph 262k sparse",
                  web_graph_csr(rng, 262144, 262144, avg_nnz=6.0), None))
    cases.append(("clustered 262k", clustered_csr(rng, 262144,
                                                  n_clusters=32,
                                                  avg_nnz=14.0), None))
    cases.append(("banded-scrambled 262k",
                  scrambled_banded_csr(rng, 262144, bandwidth=4096,
                                       avg_nnz=12.0), None))
    cases.append(("uniform 131k x 16k avg=32",
                  _uniform_csr(rng, 131072, 16384, 32), 128))
    cases.append(("power_law 131k x 16k a=1.2 avg=16",
                  rng.power_law_csr(131072, 16384, avg_nnz=16.0,
                                    alpha=1.2), 128))
    return cases


def ground_truth(csr, split_rows) -> dict:
    """Groups and cost at each superblock height from full builds
    (``None`` where no build packs), the banded rescue as ``build_auto``
    escalates."""
    out = {}
    for s in tplan.SUP_LEVELS:
        narrow = s == tplan.SUP_LEVELS[0]
        beta, slack = tplan._auto_caps(s)
        split = split_rows if narrow else None
        t0 = time.time()
        try:
            groups = tplan.build(
                csr, sup=s, split_rows=split, spill_beta=beta,
                cap_slack=slack,
                permute_rows=tplan._permute_default()).n_groups
        except tplan.WindowEllOverflow as e:
            nb = tplan._bands_from_overflow(e)
            if csr.num_rows <= s or nb < 2:
                out[s] = None
                continue
            try:
                groups = tplan.build_banded(
                    csr, sup=s, n_bands=nb, split_rows=split,
                    cap_slack=slack, spill_beta=beta,
                    permute_rows=tplan._permute_default()).n_groups
            except tplan.WindowEllOverflow:
                out[s] = None
                continue
        out[s] = {"groups": int(groups),
                  "cost": groups * (tplan._STREAM_PS + tplan._SCATTER_PS[s]),
                  "build_s": round(time.time() - t0, 1)}
    return out


def grid_row(name: str, csr, split) -> dict:
    """The selector's pick against the ground truth for one case."""
    stats = csr.compute_stats()
    n_sups0 = -(-csr.num_rows // tplan.SUP_LEVELS[0])
    n_windows = _bucket(max(csr.num_cols, 1)) // tplan.WINDOW
    depth = csr.nnz / (n_sups0 * n_windows * 1024)
    t0 = time.time()
    pick = tplan._choose_sup(csr, split_rows=split)
    t_pick = time.time() - t0
    truth = ground_truth(csr, split)
    costs = {s: v["cost"] for s, v in truth.items() if v}
    best = min(costs, key=costs.get) if costs else None
    ok = best is not None and pick in costs \
        and costs[pick] <= WITHIN * costs[best]
    log(f"{name}: depth={depth:.2f} skew={stats.skewness:.0f} pick={pick} "
        f"best={best} ok={ok} "
        f"costs={ {k: round(v) for k, v in costs.items()} } "
        f"pick_time={t_pick:.1f}s")
    return {"case": name, "rows": csr.num_rows, "cols": csr.num_cols,
            "nnz": csr.nnz, "skew": round(stats.skewness, 1),
            "depth": round(depth, 2), "split_rows": split,
            "model_pick": pick, "pick_s": round(t_pick, 1), "best": best,
            "within_10pct": bool(ok),
            "truth": {str(k): v for k, v in truth.items()}}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m tpu_spmv_torch.benchmarks.model_grid")
    p.add_argument("--out", default=None,
                   help="also write the JSON to this file")
    args = p.parse_args(argv)
    from .. import native

    native.require()
    t_start = time.time()
    rows = [grid_row(*case) for case in build_grid(RandomGenerator(42))]
    n_ok = sum(r["within_10pct"] for r in rows)
    report = {
        "device": f"host ({platform.processor() or platform.machine()}; "
                  "planner only, no device work)",
        "criterion": "model choice cost <= 1.10 * best candidate cost "
                     "(actual full-build groups x the planner's per-slot "
                     "rate)",
        "match_rate": round(n_ok / len(rows), 3),
        "target": TARGET,
        "passed": bool(n_ok / len(rows) >= TARGET),
        "n_cases": len(rows),
        "probe": {"ambig_narrow": tplan.PROBE_AMBIG_NARROW,
                  "ambig_wide": tplan.PROBE_AMBIG_WIDE,
                  "min_nnz": tplan.PROBE_MIN_NNZ, "depth_gate": 0.5},
        "wall_s": round(time.time() - t_start, 1),
        "rows": rows,
    }
    print(json.dumps(report), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    log(f"match rate {report['match_rate']} "
        f"({'PASS' if report['passed'] else 'FAIL'})")
    return 0 if report["passed"] else 1


if __name__ == "__main__":
    sys.exit(main())
