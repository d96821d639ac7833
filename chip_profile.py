"""Where one SpMV's device time goes, kernel by kernel, on one NVIDIA GPU.

    python3 chip_profile.py [--calls 20] [--cells headline,mesh,ab]

For ``chip_smoke.py``'s matrices (``headline``: the merge-path power-law
matrix; ``mesh``: the scrambled 2^20 mesh, served reordered; ``ab``: the
planted banded and clustered matrices at 262,144 rows, natural and
reordered), each plan is resolved through ``spmv_csr`` (auto configuration)
and warmed up, then ``--calls`` calls are traced with ``torch.profiler``.
Per plan it prints:

* the fold schedule: for each section (in launch order) its CTAs, its runs,
  and the most and the mean runs one CTA walks;
* device µs per call for each kernel name, with its launches per call;
* K1's device µs per launch, in section order (the mean over the calls).

The trace has been seen to drop a few launches of the first kernels of a
call; a kernel whose launches per call are not a whole number is flagged.
The first line is the card's name and power limit (``nvidia-smi``).  Fails
where no CUDA device is available, the trace holds no device time, or it
misses a fold launch.
Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import sys

import chip_smoke as cs


def schedule(plan) -> list:
    """Per fold section: ``(CTAs, runs, max runs per CTA, mean)``."""
    import numpy as np

    out = []
    for sec in plan.sections:
        per_cta = np.diff(sec.cta_ptr.cpu().numpy())
        out.append((sec.n_cta, int(per_cta.sum()), int(per_cta.max()),
                    float(per_cta.mean())))
    return out


def profile(label: str, A, x, reorder, calls: int, dev) -> None:
    import dataclasses

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile
    from torch.profiler import schedule as schedule_steps

    from tpu_spmv_torch import spmv_auto_config, spmv_csr
    from tpu_spmv_torch.kernels.reorder import ReorderedPlan

    cfg = dataclasses.replace(spmv_auto_config(A), reorder=reorder)
    xd = torch.from_numpy(x).to(dev)
    res = spmv_csr(A, xd, cfg)
    cs.check(res.error_code == 0, f"{label}: error {res.error_code}")
    plan = res.plan
    inner = plan.inner if isinstance(plan, ReorderedPlan) else plan
    # one call per profiler step: two untraced (wait, warm-up), then
    # ``calls`` traced, then one more so the traced cycle closes (a trace
    # stopped right after its last call can miss that call's kernels)
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA],
                       schedule=schedule_steps(wait=1, warmup=1,
                                               active=calls, repeat=1),
                       acc_events=True) as prof:
        for _ in range(calls + 3):   # the plan is cached on A: calls run it
            spmv_csr(A, xd, cfg)
            torch.cuda.synchronize()
            prof.step()
    # device events, less the schedule's own step spans
    kern = sorted((e for e in prof.events()
                   if e.device_type == DeviceType.CUDA
                   and not e.name.startswith("ProfilerStep")),
                  key=lambda e: e.time_range.start)
    cs.check(len(kern) > 0, f"{label}: the trace holds no device time")
    by_name = {}
    for e in kern:
        t, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + e.time_range.elapsed_us(), n + 1)
    total = sum(t for t, _ in by_name.values()) / calls
    cs.log(f"== {label}: {type(plan).__name__}, sup {inner.sup}, "
           f"{inner.n_groups} groups, tb {inner.tb}, S {inner.step_groups}; "
           f"device {total:.2f} us/call over {calls} calls")
    for k, (ctas, runs, most, mean) in enumerate(schedule(inner)):
        cs.log(f"  section {k}: {ctas} CTAs, {runs} runs, max {most} / "
               f"mean {mean:.1f} runs per CTA")
    for name, (t, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0]):
        cs.log(f"  {t / calls:10.2f} us  x{n / calls:g}  {name[:96]}")
    if any(n % calls for _, n in by_name.values()):
        cs.log("  (a launch count that is not a whole number per call: the "
               "trace dropped that kernel's launches, and its time is short)")
    folds = [e.time_range.elapsed_us() for e in kern if "fold_" in e.name]
    per = len(inner.sections)
    cs.check(len(folds) == per * calls,
             f"{label}: {len(folds)} fold launches traced, "
             f"{per * calls} expected")
    cs.log("  K1 per launch, section order (us): "
           + ", ".join(f"{sum(folds[k::per]) / calls:.2f}"
                       for k in range(per)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--calls", type=int, default=20)
    ap.add_argument("--cells", default="headline,mesh,ab")
    args = ap.parse_args()
    import torch

    from tpu_spmv_torch.utils import testing as tt

    if not torch.cuda.is_available():
        print("chip_profile: no CUDA device is available", file=sys.stderr)
        return 2
    cs.log(cs.nvidia_smi())
    dev = torch.device("cuda", 0)
    cells = args.cells.split(",")
    runs = []
    if "headline" in cells:
        runs.append(("power_law_csr", cs.HEADLINE, (None,)))
    if "mesh" in cells:
        runs.append(("scrambled_banded_csr", cs.MESH, (None,)))
    if "ab" in cells:
        runs += [(name, a, (False, None)) for name, a in cs.AB]
    for name, a, arms in runs:
        rng = tt.RandomGenerator(42)
        A = rng.power_law_csr(*a) if name == "power_law_csr" \
            else getattr(tt, name)(rng, *a)
        x = rng.vector(A.num_cols)
        for reorder in arms:
            profile(f"{name}{a} reorder={reorder}", A, x, reorder,
                    args.calls, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
