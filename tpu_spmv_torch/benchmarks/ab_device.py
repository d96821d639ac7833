"""Planner lever settings on the headline, on the device (port of
``benchmarks/ab_device.py``).

    python3 -m tpu_spmv_torch.benchmarks.ab_device [--device cpu]

The headline plan (``power_law_csr(262144, 4096, avg 40, alpha 1.6)``,
merge-path) is built under seven settings of spill beta, cap slack, the
balancer's window and scoring mode, step width and leveling, each held to
the CPU oracle at rel 1e-5 and timed (300 calls, median of 5) under the
physics guard.  A setting whose lever did not change the plan (leveling
asked for and not engaged, or a fingerprint seen before) is reported and
not timed.  The last line is one JSON object, ``device`` and the rows.
"""

from __future__ import annotations

import argparse
import sys
import time

from ..bench import log
from ..errors import guarded_upload
from ..kernels.plan import build
from ..kernels.window_ell import plan_from_host, spmv_window_ell
from ..soak import env
from ..utils.testing import RandomGenerator
from . import checked_seconds, device_main

ITERS = 300
# (label, spill beta, cap slack, balance window, step width, the
# balancer's scoring mode (0 the round-3 d^2 greedy, 2 the atom-aware
# layer-cost one; native.cc), leveling)
CONFIGS = (
    ("legacy  beta=0   win=0    S=128", 0.0, 1, 0, 128, 0, False),
    ("r3      beta=2.6 win=1    S=128", 2.6, 1, 1, 128, 0, False),
    ("new     beta=2.2 sl0 w2L2 S=128", 2.2, 0, 2, 128, 2, False),
    ("perm    beta=2.2 sl0 w2L2 S=128", 2.2, 0, 2, 128, 2, True),
    ("perm    beta=2.2 sl0 w2L2 S=384", 2.2, 0, 2, 384, 2, True),
    ("new     beta=2.2 sl0 w2L2 S=384", 2.2, 0, 2, 384, 2, False),
    ("r3      beta=2.6 win=1    S=384", 2.6, 1, 1, 384, 0, False),
)


def ab(csr, x, clock, configs=CONFIGS, iters: int = ITERS) -> list:
    """One row per setting of ``configs``."""
    from .. import native

    native.require()     # without the balancers the levers do nothing
    xd = guarded_upload(x, clock.device)
    seen, rows = {}, []
    for label, beta, slack, win, S, layer, perm in configs:
        t0 = time.time()
        with env(TPU_SPMV_BALANCE_WINDOW=win, TPU_SPMV_BALANCE_LAYER=layer):
            hp = build(csr, split_rows=128, step_groups=S, spill_beta=beta,
                       cap_slack=slack, permute_rows=perm)
        fp = (int(hp.n_groups), round(float(hp.occupancy), 6),
              int(hp.n_extra), hp.lam is not None, S)
        if perm and hp.lam is None:
            log(f"{label}: LEVER NO-OP (permute_rows asked, no lam); "
                "not timed")
            rows.append({"label": label, "no_op": True})
            continue
        if fp in seen:
            log(f"{label}: DUPLICATE PLAN of [{seen[fp]}] {fp}; not timed")
            rows.append({"label": label, "duplicate_of": seen[fp]})
            continue
        seen[fp] = label
        p = plan_from_host(hp, clock.device)
        build_s = time.time() - t0
        s = checked_seconds(label, lambda: spmv_window_ell(p, xd), csr, x,
                            p.stream_bytes, clock, iters)
        rows.append({"label": label, "groups": p.n_groups,
                     "occupancy": round(hp.occupancy, 4),
                     "build_s": round(build_s, 2), "t_us": s * 1e6,
                     "correct": True})
        print(f"{label}: groups={p.n_groups} occ={hp.occupancy:.4f} "
              f"build={build_s:.0f}s ok=True t={s*1e6:.1f} us", flush=True)
    return rows


def run(clock, args) -> list:
    rng = RandomGenerator(42)
    csr = rng.power_law_csr(262144, 4096, avg_nnz=40.0, alpha=1.6)
    return ab(csr, rng.vector(4096), clock)


def main(argv=None) -> int:
    return device_main(argparse.ArgumentParser(
        prog="tpu_spmv_torch.benchmarks.ab_device"), argv, run)


if __name__ == "__main__":
    sys.exit(main())
