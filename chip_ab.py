"""Time one cell of ``chip_smoke.py`` in two checkouts of this repo, in
turns, on one NVIDIA GPU.

    python3 chip_ab.py [--cell pagerank|kernels|probes] BEFORE AFTER

``BEFORE`` and ``AFTER`` are the roots of two checkouts (say the parent
commit, unpacked with ``git archive``, and this tree).  Processes run in
the order BEFORE, AFTER, AFTER, BEFORE, twice (``ORDER``), each importing
``tpu_spmv_torch`` (and ``chip_smoke``) from its own checkout, its kernels
built there, and printing one JSON line of times:

* ``pagerank`` (the default): phase 9's PageRank, the JAX bench's
  262,144-node web graph column-normalised (``RandomGenerator(42)``,
  average 15 per row).  After one call that builds and uploads its plan,
  ``CALLS`` calls of 30 iterations at tolerance 0, each between CUDA
  events and on the host's clock, and ``CALLS`` runs of the loop alone
  (``pagerank._iterate`` on the call's plan, mask and start: no set-up)
  between CUDA events: the medians and spreads of the ms per iteration,
  the iterations and the ranks' sum.
* ``kernels``: phase 6's headline SpMV (``spmv_csr(measure=True)``, µs a
  call) and the µs a call of each of its kernels' wrappers as that
  checkout's ``chip_smoke.hold_kernels`` times them (K3's set-up, K1 as
  the SpMV runs it, the section epilogue, K2).

The last lines give each checkout's values and medians over its turns,
and the card's name and power limit.  Fails where no CUDA device is
available or a turn fails.  Imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys

CALLS = 10
# two rounds of turns, each round's order the other's mirror
ORDER = ("before", "after", "after", "before") * 2

PAGERANK = r"""
import json, statistics, sys, time
import numpy as np, torch
from tpu_spmv_torch import PageRankConfig, pagerank
from tpu_spmv_torch.spmv import run_plan
from tpu_spmv_torch.utils.testing import (RandomGenerator, transition_matrix,
                                          web_graph_csr)
n, iters = 262144, 30
A = transition_matrix(web_graph_csr(RandomGenerator(42), n, n, avg_nnz=15))
cfg = PageRankConfig(max_iterations=iters, tolerance=0.0)
warm = pagerank(A, cfg)
assert warm.error_code == 0, warm.error_code
events, wall = [], []
for _ in range(CALLS):
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start.record()
    res = pagerank(A, cfg)
    stop.record()
    stop.synchronize()
    wall.append((time.perf_counter() - t0) * 1e3 / res.iterations)
    events.append(start.elapsed_time(stop) / res.iterations)
ranks = res.ranks_host()
assert res.error_code == 0 and np.all(np.isfinite(ranks))
# the loop alone: the same plan, mask and start, no set-up
pr = sys.modules["tpu_spmv_torch.pagerank"]
plan = res.plan
mask = torch.from_numpy(pr.find_dangling_mask(A)).cuda()
r0 = torch.full((n,), 1.0 / n, device="cuda")
loop = []
for _ in range(CALLS):
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    it, _, _ = pr._iterate(lambda r: run_plan(plan, r)[:n], mask, r0, n,
                           0.85,
                           0.0, iters)
    stop.record()
    stop.synchronize()
    loop.append(start.elapsed_time(stop) / it)
print(json.dumps({"iterations": res.iterations,
                  "loop_ms_per_iteration": statistics.median(loop),
                  "loop_min_max": [min(loop), max(loop)],
                  "ms_per_iteration_events": statistics.median(events),
                  "events_min_max": [min(events), max(events)],
                  "ms_per_iteration_wall": statistics.median(wall),
                  "wall_min_max": [min(wall), max(wall)],
                  "ranks_sum": float(ranks.sum(dtype=np.float64))}))
"""

KERNELS = r"""
import json
import torch
import chip_smoke as cs
from tpu_spmv_torch import spmv_auto_config, spmv_csr
from tpu_spmv_torch.utils.testing import RandomGenerator
rng = RandomGenerator(42)
A = rng.power_law_csr(*cs.HEADLINE)
x = rng.vector(A.num_cols)
xd = torch.from_numpy(x).cuda()
res = spmv_csr(A, xd, spmv_auto_config(A), measure=True)
assert res.error_code == 0, res.error_code
held = cs.hold_kernels(res.plan, xd, A, x, "headline", timed=True)
out = {"spmv_us": res.elapsed_ms * 1e3}
out.update({name + "_us": recs[0]["ms"] * 1e3 for name, recs in held.items()})
print(json.dumps(out))
"""
PROBES = r"""
import json
import torch
from tpu_spmv_torch.probes import proto_v3 as p2, proto_v4 as p3
from tpu_spmv_torch.timing import time_cuda
PROBE_CALLS = 100
out = {}
cases = [(p3, p3.MAIN_MODES, m) for m in p3.MAIN_MODES] + [
    (p2, ("w128",), "w128")]
for mod, modes, mode in cases:
    inp = mod.make_inputs(device="cuda", modes=modes)[mode]
    y = mod.probe(inp)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(y).all()), mode
    out[mode + "_ms"] = time_cuda(lambda: mod.probe(inp), iters=PROBE_CALLS,
                                  samples=3) * 1e3
print(json.dumps(out))
"""
CELLS = {"pagerank": PAGERANK, "kernels": KERNELS, "probes": PROBES}


def turn(tree: str, cell: str) -> dict:
    """One timed process of ``cell`` in ``tree``: its JSON line as a
    dict."""
    out = subprocess.run(
        [sys.executable, "-c", f"CALLS = {CALLS}\n" + CELLS[cell]], cwd=tree,
        env=dict(os.environ, PYTHONPATH=tree), capture_output=True,
        text=True, timeout=600)
    if out.returncode:
        sys.stderr.write(out.stdout + out.stderr)
        raise SystemExit(f"chip_ab: the turn in {tree} failed "
                         f"(exit {out.returncode})")
    return json.loads(out.stdout.strip().splitlines()[-1])


def main(argv=None) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cell", choices=sorted(CELLS), default="pagerank")
    ap.add_argument("before")
    ap.add_argument("after")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_ab: no CUDA device is available", file=sys.stderr)
        return 2
    trees = {"before": os.path.abspath(args.before),
             "after": os.path.abspath(args.after)}
    seen = {"before": [], "after": []}
    for side in ORDER:
        rec = turn(trees[side], args.cell)
        seen[side].append(rec)
        print(json.dumps({"turn": side, **rec}), flush=True)
    for side, recs in seen.items():
        print(f"{side} ({trees[side]}):")
        for key, value in recs[0].items():
            if isinstance(value, (int, float)):
                values = [r[key] for r in recs]
                print(f"  {key}: {values}, median "
                      f"{statistics.median(values)}")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
