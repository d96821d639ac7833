"""The scatter run length (``t_base``) on the headline, on the device
(port of ``benchmarks/ab_tbase.py``).

    python3 -m tpu_spmv_torch.benchmarks.ab_tbase [--device cpu]

The plan pads every superblock's group run to a multiple of ``tb``; a
shorter run buys that padding back at the cost of more output tiles a
fold folds into.  The leveled headline plan is built at step widths 256
and 384 and ``tb`` 8, 4 and 2, each held to the CPU oracle at rel 1e-5
and timed (300 calls, median of 5) under the physics guard; a fingerprint
seen before is reported and not timed.  The last line is one JSON object,
``device`` and the rows.
"""

from __future__ import annotations

import argparse
import sys
import time

from ..bench import model_bytes
from ..errors import guarded_upload
from ..kernels.plan import build
from ..kernels.window_ell import plan_from_host, spmv_window_ell
from ..utils.testing import RandomGenerator
from . import checked_seconds, device_main

ITERS = 300
CONFIGS = tuple((S, tb) for S in (256, 384) for tb in (8, 4, 2))


def ab(csr, x, clock, configs=CONFIGS, iters: int = ITERS) -> list:
    from .. import native

    native.require()
    xd = guarded_upload(x, clock.device)
    bm = model_bytes(csr.num_rows, csr.num_cols, csr.nnz)
    seen, rows = {}, []
    for S, tb in configs:
        label = f"S={S} tb={tb}"
        t0 = time.time()
        hp = build(csr, split_rows=128, step_groups=S, permute_rows=True,
                   t_base=tb)
        fp = (int(hp.n_groups), round(float(hp.occupancy), 6),
              int(hp.n_extra), S, tb)
        if fp in seen:
            print(f"{label}: DUPLICATE PLAN of [{seen[fp]}] {fp}; not timed",
                  flush=True)
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
                     "gb_s": bm / s / 1e9, "correct": True})
        print(f"{label}: groups={p.n_groups} occ={hp.occupancy:.4f} "
              f"build={build_s:.0f}s ok=True t={s*1e6:.1f} us = "
              f"{bm/s/1e9:.1f} GB/s byte-model", flush=True)
    return rows


def run(clock, args) -> list:
    rng = RandomGenerator(42)
    csr = rng.power_law_csr(262144, 4096, avg_nnz=40.0, alpha=1.6)
    return ab(csr, rng.vector(4096), clock)


def main(argv=None) -> int:
    return device_main(argparse.ArgumentParser(
        prog="tpu_spmv_torch.benchmarks.ab_tbase"), argv, run)


if __name__ == "__main__":
    sys.exit(main())
