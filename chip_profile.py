"""Where one SpMV's device time goes, kernel by kernel, on one NVIDIA GPU.

    python3 chip_profile.py [--calls 20]
                            [--cells headline,mesh,ab,levers,pagerank]
                            [--cells ablation]

For ``chip_smoke.py``'s matrices (``headline``: the merge-path power-law
matrix; ``mesh``: the scrambled 2^20 mesh, served reordered; ``ab``: the
planted banded and clustered matrices at 262,144 rows, natural and
reordered; ``levers``: the headline with a bf16 value stream and, column-
scaled, on the pattern path; ``pagerank``: one PageRank SpMV of the
262,144-node web graph, on its pattern plan), each plan is resolved through
``spmv_csr`` (auto configuration, with the cell's changes) and warmed up,
then ``--calls`` calls are traced with ``torch.profiler``.
Per plan it prints:

* the fold schedule of each section (in launch order) before and after
  chunking: superblocks and the most runs of one, chunks (K1's CTAs),
  split superblocks and the most runs of one chunk;
* device µs per call for each kernel name, with its launches per call;
* K1's device µs per section, in section order: the chunked fold plus,
  where the section splits a superblock, its ordered reduce (the mean over
  the calls).

``ablation`` (not in the default cells) times K1 alone on the PageRank
plan's gather table under three cuts of the same plan: one run per chunk
(R = 1), the module's R, and no cut (one chunk per superblock).

The trace has been seen to drop a few launches of the first kernels of a
call; a kernel whose launches per call are not a whole number is flagged.
The first line is the card's name and power limit (``nvidia-smi``).  Fails
where no CUDA device is available, the trace holds no device time, or it
misses a fold or reduce launch.
Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import sys

import chip_smoke as cs

FOLD_KERNEL = "fold_chunk"
REDUCE_KERNEL = "chunk_reduce"


def trace(fn, calls: int) -> list:
    """Device events of ``calls`` calls of ``fn``, in time order."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile
    from torch.profiler import schedule as schedule_steps

    # one call per profiler step: two untraced (wait, warm-up), then
    # ``calls`` traced, then one more so the traced cycle closes (a trace
    # stopped right after its last call can miss that call's kernels)
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA],
                       schedule=schedule_steps(wait=1, warmup=1,
                                               active=calls, repeat=1),
                       acc_events=True) as prof:
        for _ in range(calls + 3):
            fn()
            torch.cuda.synchronize()
            prof.step()
    # device events, less the schedule's own step spans
    return sorted((e for e in prof.events()
                   if e.device_type == DeviceType.CUDA
                   and not e.name.startswith("ProfilerStep")),
                  key=lambda e: e.time_range.start)


def k1_sections(label: str, kern: list, inner, calls: int) -> list:
    """K1's device µs per call for each section of ``inner``: its fold
    launch plus, where the section splits a superblock, the reduce launch
    that follows it.  Fails unless the trace holds one fold launch per
    section and one reduce per split section, per call."""
    per = len(inner.sections)
    splits = [s.n_split > 0 for s in inner.sections]
    times = [0.0] * per
    folds = reduces = 0
    k = -1
    for e in kern:
        if FOLD_KERNEL in e.name:
            k = folds % per
            folds += 1
            times[k] += e.time_range.elapsed_us()
        elif REDUCE_KERNEL in e.name:
            cs.check(k >= 0 and splits[k],
                     f"{label}: a reduce launch after no split section")
            reduces += 1
            times[k] += e.time_range.elapsed_us()
    cs.check(folds == per * calls,
             f"{label}: {folds} fold launches traced, {per * calls} "
             f"expected")
    cs.check(reduces == sum(splits) * calls,
             f"{label}: {reduces} reduce launches traced, "
             f"{sum(splits) * calls} expected")
    return [t / calls for t in times]


def print_kernels(kern: list, calls: int) -> None:
    by_name = {}
    for e in kern:
        t, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + e.time_range.elapsed_us(), n + 1)
    for name, (t, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0]):
        cs.log(f"  {t / calls:10.2f} us  x{n / calls:g}  {name[:96]}")
    if any(n % calls for _, n in by_name.values()):
        cs.log("  (a launch count that is not a whole number per call: the "
               "trace dropped that kernel's launches, and its time is short)")


def print_schedule(inner) -> None:
    for k, geo in enumerate(cs.fold_geometry(inner)):
        cs.log(f"  section {k}: " + json.dumps(geo))


def profile(label: str, A, x, changes: dict, calls: int, dev) -> None:
    import dataclasses

    import torch

    from tpu_spmv_torch import spmv_auto_config, spmv_csr
    from tpu_spmv_torch.kernels.reorder import ReorderedPlan
    from tpu_spmv_torch.spmv import PatternPlan

    cfg = dataclasses.replace(spmv_auto_config(A), **changes)
    xd = torch.from_numpy(x).to(dev)
    res = spmv_csr(A, xd, cfg)
    cs.check(res.error_code == 0, f"{label}: error {res.error_code}")
    plan = res.plan
    inner = plan.inner if isinstance(plan, ReorderedPlan) \
        else plan.plan if isinstance(plan, PatternPlan) else plan
    # the plan is cached on A: calls run it
    kern = trace(lambda: spmv_csr(A, xd, cfg), calls)
    cs.check(len(kern) > 0, f"{label}: the trace holds no device time")
    total = sum(e.time_range.elapsed_us() for e in kern) / calls
    cs.log(f"== {label}: {type(plan).__name__}, {inner.values} values, sup "
           f"{inner.sup}, {inner.n_groups} groups, tb {inner.tb}, S "
           f"{inner.step_groups}; device {total:.2f} us/call over {calls} "
           f"calls")
    print_schedule(inner)
    print_kernels(kern, calls)
    cs.log("  K1 per section, fold + reduce, section order (us): "
           + ", ".join(f"{t:.2f}" for t in k1_sections(label, kern, inner,
                                                        calls)))


def ablation(A, calls: int, dev) -> None:
    """K1 on the PageRank plan's gather table (x the uniform ranks, scaled
    as ``spmv_pattern`` feeds it) at R = 1, the module's R and no cut."""
    import dataclasses

    import torch

    from tpu_spmv_torch import KernelType, SpMVConfig, spmv_csr
    from tpu_spmv_torch.kernels import window_ell as twe

    n = A.num_rows
    cfg = SpMVConfig(kernel_type=KernelType.VECTOR_CSR, pattern=True)
    res = spmv_csr(A, torch.full((n,), 1.0 / n, device=dev), cfg)
    cs.check(res.error_code == 0, f"ablation: error {res.error_code}")
    pp = res.plan
    table = twe.gather_table(pp.plan, pp.scale * (1.0 / n))
    cs.log(f"== ablation: K1 on the PageRank plan ({pp.plan.values}, sup "
           f"{pp.plan.sup}, tb {pp.plan.tb}); {cs.nvidia_smi()}")
    for what, cap in (("R = 1", 1), (f"R = {twe.CHUNK_RUNS} (module)",
                                     twe.CHUNK_RUNS), ("unsplit", 1 << 30)):
        plan = dataclasses.replace(pp.plan,
                                   sections=twe._fold_schedule(pp.plan, cap))
        kern = trace(lambda: twe.window_ell_fold(plan, table), calls)
        secs = k1_sections(f"ablation {what}", kern, plan, calls)
        ms = cs.time_ms(lambda: twe.window_ell_fold(plan, table))
        cs.log(f"-- {what}: K1 {ms * 1e3:.2f} us/call (CUDA events); per "
               f"section, fold + reduce (us): "
               + ", ".join(f"{t:.2f}" for t in secs))
        print_schedule(plan)
        print_kernels(kern, calls)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--calls", type=int, default=20)
    ap.add_argument("--cells", default="headline,mesh,ab,levers,pagerank")
    args = ap.parse_args()
    import numpy as np
    import torch

    from tpu_spmv_torch import CSRMatrix, KernelType
    from tpu_spmv_torch.utils import testing as tt

    if not torch.cuda.is_available():
        print("chip_profile: no CUDA device is available", file=sys.stderr)
        return 2
    cs.log(cs.nvidia_smi())
    dev = torch.device("cuda", 0)
    cells = args.cells.split(",")
    runs = []
    if "headline" in cells or "levers" in cells:
        arms = [{"reorder": None}] if "headline" in cells else []
        if "levers" in cells:
            arms += [{"bf16_values": True}, {"pattern": True}]
        runs.append(("power_law_csr", cs.HEADLINE, arms))
    if "mesh" in cells:
        runs.append(("scrambled_banded_csr", cs.MESH, [{"reorder": None}]))
    if "ab" in cells:
        runs += [(name, a, [{"reorder": False}, {"reorder": None}])
                 for name, a in cs.AB]
    if "pagerank" in cells or "ablation" in cells:
        # PageRank's SpMV: the pattern path at its VECTOR_CSR kernel type
        runs.append(("web_graph_csr", cs.PAGERANK, [
            {"pattern": True, "kernel_type": KernelType.VECTOR_CSR}]
            if "pagerank" in cells else []))
    for name, a, arms in runs:
        rng = tt.RandomGenerator(42)
        if name == "power_law_csr":
            A = rng.power_law_csr(*a)
        elif name == "web_graph_csr":
            A = tt.transition_matrix(tt.web_graph_csr(rng, a[0], a[0],
                                                      avg_nnz=a[1]))
        else:
            A = getattr(tt, name)(rng, *a)
        x = rng.vector(A.num_cols)
        for changes in arms:
            M = A
            if changes.get("pattern") and name == "power_law_csr":
                # a column-scaled matrix of the headline's structure
                s = tt.RandomGenerator(7).rng.uniform(0.5, 2.0, A.num_cols) \
                    .astype(np.float32)
                M = CSRMatrix(A.num_rows, A.num_cols, s[A.col_indices],
                              A.col_indices, A.row_ptrs)
            profile(f"{name}{a} {changes}", M, x, changes, args.calls, dev)
        if name == "web_graph_csr" and "ablation" in cells:
            ablation(A, args.calls, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
