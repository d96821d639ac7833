"""Wide-class (web-graph) planner configurations, on the device (port of
``benchmarks/ab_device_wide.py``).

    python3 -m tpu_spmv_torch.benchmarks.ab_device_wide [--rows N]
        [--device cpu]

On ``web_graph_csr(N, N, avg 15)`` (1M nodes by default): a single plan at
superblock height 16384 with margin caps (the round-3 dispatch), the
``build_auto`` layout natural and leveled (the dispatch's default), and
row-banded plans at height 4096 with spill beta 2.6 and cap slack 0 and 1,
each under its balancer settings, held to the CPU oracle at rel 1e-5 and
timed (60 calls, median of 5) under the physics guard; a configuration no
packed layout takes (``WindowEllOverflow``) is reported, not timed.  The
last line is one JSON object, ``device`` and the rows.
"""

from __future__ import annotations

import argparse
import sys
import time

from ..bench import model_bytes
from ..errors import guarded_upload
from ..kernels import upload
from ..kernels.plan import WindowEllOverflow, build, build_auto, build_banded
from ..soak import env
from ..spmv import run_plan
from ..utils.testing import RandomGenerator, web_graph_csr
from . import checked_seconds, device_main, occupancy

ITERS = 60
# (label, balance window, the balancer's scoring mode, host plan maker)
CONFIGS = (
    ("r3-baseline sup=16384", 1, 0,
     lambda A: build(A, sup=16384, cap_slack=2)),
    ("build_auto natural", 2, 2,
     lambda A: build_auto(A, permute_rows=False)),
    ("dispatch build_auto (leveled)", 2, 2, lambda A: build_auto(A)),
    ("banded4096 beta=2.6 slack=0", 1, 0,
     lambda A: build_banded(A, sup=4096, spill_beta=2.6, cap_slack=0)),
    ("banded4096 beta=2.6 slack=1", 1, 0,
     lambda A: build_banded(A, sup=4096, spill_beta=2.6, cap_slack=1)),
)


def ab(csr, x, clock, configs=CONFIGS, iters: int = ITERS) -> list:
    xd = guarded_upload(x, clock.device)
    bm = model_bytes(csr.num_rows, csr.num_cols, csr.nnz)
    rows = []
    for label, win, layer, make in configs:
        t0 = time.time()
        try:
            with env(TPU_SPMV_BALANCE_WINDOW=win,
                     TPU_SPMV_BALANCE_LAYER=layer):
                hp = make(csr)
        except WindowEllOverflow as e:
            print(f"{label}: no packed layout ({e})", flush=True)
            rows.append({"label": label, "overflow": True})
            continue
        p = upload(hp, clock.device)
        build_s = time.time() - t0
        s = checked_seconds(label, lambda: run_plan(p, xd), csr, x,
                            p.stream_bytes, clock, iters)
        n_plans = len(getattr(hp, "plans", (1,)))
        rows.append({"label": label, "kind": f"{type(hp).__name__}/{n_plans}",
                     "sup": hp.sup, "groups": hp.n_groups,
                     "occupancy": round(occupancy(hp), 4),
                     "build_s": round(build_s, 2), "t_ms": s * 1e3,
                     "gb_s": bm / s / 1e9, "correct": True})
        print(f"{label}: kind={rows[-1]['kind']} sup={hp.sup} "
              f"groups={hp.n_groups} occ={occupancy(hp):.4f} "
              f"build={build_s:.0f}s ok=True t={s*1e3:.2f} ms = "
              f"{bm/s/1e9:.2f} GB/s", flush=True)
    return rows


def run(clock, args) -> list:
    rng = RandomGenerator(42)
    csr = web_graph_csr(rng, args.rows, args.rows, avg_nnz=15)
    print(f"nnz={csr.nnz}", flush=True)
    return ab(csr, rng.vector(args.rows), clock)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="tpu_spmv_torch.benchmarks.ab_device_wide")
    p.add_argument("--rows", type=int, default=1_000_000)
    return device_main(p, argv, run)


if __name__ == "__main__":
    sys.exit(main())
