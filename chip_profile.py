"""Where one SpMV's device time goes, kernel by kernel, on one NVIDIA GPU.

    python3 chip_profile.py [--calls 20]
                            [--cells headline,mesh,banded,ab,levers,pagerank]
                            [--cells web,pagerank1m,wide,floors,ablation,ell]
                            [--cells sharded]

For ``chip_smoke.py``'s matrices (``headline``: the merge-path power-law
matrix; ``mesh``: the scrambled 2^20 mesh, served reordered; ``banded``:
the same mesh with ``reorder=False``, its natural arm, served by a
row-banded stack of plans; ``ab``: the planted banded and clustered
matrices at 131,072 rows, natural and reordered; ``levers``: the headline
with a bf16 value stream and, column-scaled, on the pattern path;
``pagerank``: one PageRank SpMV of the 262,144-node web graph, on its
pattern plan; and, not in the default
cells, ``web``: the 1M-node web graph, a banded stack; ``pagerank1m``:
PageRank's SpMV on it column-normalised, a banded pattern stack; ``wide``:
the 1M x 4M web graph on column strips, the headline's law with 1.5M
columns on a composite plan, the 1.5M-node web graph on the flat path;
``floors``: the headline as SCALAR_CSR, its naive plan, and as
ELL_KERNEL, the flat path; ``ell``: the 5-point stencils of
``chip_smoke.py``'s phase 14 as ELL matrices, one per ELL route, and the
1024 stencil column-scaled on the pattern route), each plan is resolved
through ``spmv_csr`` (``spmv_ell`` for ``ell``; the auto configuration,
with the cell's changes) and warmed up, then ``--calls`` calls are traced
with ``torch.profiler``.
Per plan it prints:

* the fold schedule of each section (in launch order) before and after
  chunking: superblocks and the most runs of one, chunks (K1's CTAs),
  split superblocks and the most runs of one chunk;
* a call's device span (first launch's start to last launch's end, the
  median over the calls) beside its busy time, so the device's idle share
  between launches, and the time of one call replayed from a CUDA graph
  (the device's own time, launch gaps included, without the host's);
* device µs per call for each kernel name, with its launches per call,
  and the launches per call in all; the headline's must be 8 (the gather
  table's set-up, K3, the output's zero-fill, three folds, two section
  epilogues and K2), every call must set up its table with one K3 launch,
  and a call may launch nothing besides the port's kernels but the
  output's zero-fill (and a pattern plan's scale multiply): no zero-fill
  or copy of the table, no publish copy, no table clone, no permute pass.
  A banded call sets up, fills and folds per band, and may add one join
  (``other_launches``);
* K1's device µs per section, in section order: the chunked fold plus its
  epilogue, the section epilogue after each section but the last and K2
  after the last where the call ran it (the mean over the calls); for a
  banded call per band, with each band's device µs and launches, and the
  join's.

``sharded`` (not in the default cells) traces ``chip_smoke.py``'s phase
15 cells, 4 shards all on the one card: the single plan of the matrix,
the flat sharded path, packed shards in f32, bf16, pattern and leveled,
and the ring on the local structure.  Per cell it prints the device µs
per call, the span and idle share, the time by kernel name, and holds the
traced launches of each of the port's kernels to the shard plans'
``launches_per_call``.

``ablation`` (not in the default cells) times K1 as the SpMV runs it
(``fold_sections``: no epilogue after the last section, whose split tiles
K2 sums) on the PageRank plan's gather table under three cuts of the same
plan: one run per chunk (R = 1), the module's R, and no cut (one chunk per
superblock).

The trace has been seen to drop a few launches of the first kernels of a
call: such a trace is reported (its launches against the whole number
expected) and taken again, three tries in all, and a kernel whose
launches per call are still not a whole number is flagged.
The first line is the card's name and power limit (``nvidia-smi``).  Fails
where no CUDA device is available, the trace holds no device time, it
misses a table set-up, fold or epilogue launch, a call launches more than
the kernels above, or a call cannot be captured in a CUDA graph.
Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import sys

import chip_smoke as cs

FOLD_KERNEL = "fold_chunk"
EPILOGUE_KERNEL = "section_epilogue"
K2_KERNEL = "unpermute_kernel"
K3_KERNEL = "permute_chunks_kernel"


def window_plans(plan) -> list:
    """The window-ELL plans one call of ``plan`` runs, in launch order
    (none on the flat path)."""
    from tpu_spmv_torch import DeviceCSR, DeviceELL
    from tpu_spmv_torch.kernels.reorder import ReorderedPlan
    from tpu_spmv_torch.kernels.strips import StripPlan
    from tpu_spmv_torch.kernels.window_ell import BandedPlan, CompositePlan
    from tpu_spmv_torch.spmv import PatternPlan

    if isinstance(plan, PatternPlan):
        return window_plans(plan.plan)
    if isinstance(plan, ReorderedPlan):
        return window_plans(plan.inner)
    if isinstance(plan, (BandedPlan, StripPlan, CompositePlan)):
        return [q for p in plan.plans for q in window_plans(p)]
    return [] if isinstance(plan, (DeviceCSR, DeviceELL)) else [plan]


def other_launches(plan) -> int | None:
    """Launches per call besides the port's kernels, by plan type: each
    window-ELL plan's output zero-fill, the join of a banded stack of two
    bands or more, the add after each strip or level but the first, and a
    pattern plan's scale multiply (K3 writes the whole gather table).
    ``None`` where the call runs a flat path (a composite's tail, or the
    matrix itself, CSR or ELL): those are PyTorch's own ops, counted but not
    held to a number."""
    from tpu_spmv_torch import DeviceCSR, DeviceELL
    from tpu_spmv_torch.kernels.reorder import ReorderedPlan
    from tpu_spmv_torch.kernels.strips import StripPlan
    from tpu_spmv_torch.kernels.window_ell import BandedPlan, CompositePlan
    from tpu_spmv_torch.spmv import PatternPlan

    if isinstance(plan, PatternPlan):
        return other_launches(plan.plan) + 1
    if isinstance(plan, ReorderedPlan):
        return other_launches(plan.inner)
    if isinstance(plan, BandedPlan):
        return len(plan.plans) + (len(plan.plans) > 1)
    if isinstance(plan, CompositePlan) and plan.tail is not None \
            or isinstance(plan, (DeviceCSR, DeviceELL)):
        return None
    if isinstance(plan, (StripPlan, CompositePlan)):
        return sum(other_launches(p) for p in plan.plans) \
            + len(plan.plans) - 1
    return 1


def trace(fn, calls: int, tries: int = 3) -> list:
    """Device events of ``calls`` calls of ``fn``, in time order.  A trace
    that dropped launches (none at all, or a count that is not a whole
    number per call) is reported and taken again, up to ``tries`` times in
    all."""
    for k in range(1, tries + 1):
        kern = trace_once(fn, calls)
        if kern and len(kern) % calls == 0 or k == tries:
            return kern
        cs.log(f"  trace {k} of {tries} dropped launches: {len(kern)} over "
               f"{calls} calls; taken again")


def trace_once(fn, calls: int) -> list:
    """Device events of one trace of ``calls`` calls of ``fn``."""
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


def k1_sections(label: str, kern: list, inner, calls: int,
                k2: bool) -> list:
    """K1's device µs per call for each section of ``inner``: its fold
    launch plus its epilogue, the section epilogue after each section but
    the last, and K2 after the last where ``k2`` (an SpMV that ran it;
    else none, as ``fold_sections`` runs K1).  Fails unless the trace
    holds one fold launch per section and those epilogues, per call."""
    per = len(inner.sections)
    times = [0.0] * per
    folds = epilogues = k2s = 0
    k = -1
    for e in kern:
        if FOLD_KERNEL in e.name:
            k = folds % per
            folds += 1
        elif EPILOGUE_KERNEL in e.name:
            cs.check(0 <= k < per - 1,
                     f"{label}: a section epilogue after section {k}")
            epilogues += 1
        elif K2_KERNEL in e.name and k2:
            cs.check(k == per - 1, f"{label}: K2 after section {k}")
            k2s += 1
        else:
            continue
        times[k] += e.time_range.elapsed_us()
    cs.check(folds == per * calls,
             f"{label}: {folds} fold launches traced, {per * calls} "
             f"expected")
    want = (per - 1) * calls
    cs.check(epilogues == want,
             f"{label}: {epilogues} section epilogues traced, {want} "
             f"expected")
    cs.check(k2s == (calls if k2 else 0),
             f"{label}: {k2s} K2 launches traced")
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


def device_span(kern: list, calls: int) -> float | None:
    """The median over the calls of one call's device span, µs: from its
    first launch's start to its last one's end, the busy time plus the
    device's idle gaps between launches (each call ends in a synchronize,
    so no call overlaps the next).  None where the trace dropped launches
    (not the same count for every call)."""
    import statistics

    per, rem = divmod(len(kern), calls)
    if rem or not per:
        return None
    return statistics.median(
        max(e.time_range.end for e in kern[c * per:(c + 1) * per])
        - kern[c * per].time_range.start for c in range(calls))


def graph_replay_us(fn) -> float:
    """µs per replay of one call of ``fn`` captured in a CUDA graph (CUDA
    events, the median of ``SAMPLES`` runs of ``ITERS`` replays): the call's
    device time with the gaps between its launches, and none of the host's
    launch cost."""
    import torch

    from tpu_spmv_torch.timing import time_cuda

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):      # warm up off the capture's stream
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return time_cuda(graph.replay, iters=cs.ITERS, samples=cs.SAMPLES) * 1e6


def print_schedule(inner) -> None:
    for k, geo in enumerate(cs.fold_geometry(inner)):
        cs.log(f"  section {k}: " + json.dumps(geo))


def split_bands(kern: list, calls: int, n_bands: int):
    """A banded call's device events cut at its bands: ``(per band, its
    events over all calls; the join's events)``.  Each band's launches
    start with its table set-up (K3); the join is a call's last launch.
    None where the trace dropped launches."""
    per, rem = divmod(len(kern), calls)
    if rem:
        return None
    bands, join = [[] for _ in range(n_bands)], []
    for c in range(calls):
        events = kern[c * per:(c + 1) * per]
        starts = [i for i, e in enumerate(events) if K3_KERNEL in e.name]
        if len(starts) != n_bands:
            return None
        for k, (a, b) in enumerate(zip(starts, starts[1:] + [per - 1])):
            bands[k] += events[a:b]
        join.append(events[-1])
    return bands, join


OURS = (FOLD_KERNEL, EPILOGUE_KERNEL, K2_KERNEL, K3_KERNEL)


def profile(label: str, A, x, changes: dict, calls: int, dev,
            ell: bool = False) -> None:
    """Trace ``A``'s plan; with ``ell``, ``A`` as an ELL matrix through
    ``spmv_ell``."""
    import dataclasses

    import torch

    from tpu_spmv_torch import (ELLMatrix, spmv_auto_config, spmv_csr,
                                spmv_ell)
    from tpu_spmv_torch.kernels.reorder import ReorderedPlan
    from tpu_spmv_torch.kernels.window_ell import BandedPlan
    from tpu_spmv_torch.spmv import PatternPlan, launches_per_call
    from tpu_spmv_torch.spmv import run_plan

    cfg = dataclasses.replace(spmv_auto_config(A), **changes)
    xd = torch.from_numpy(x).to(dev)
    if ell:
        E = ELLMatrix.from_csr(A)
        call = lambda: spmv_ell(E, xd, cfg)  # noqa: E731
    else:
        call = lambda: spmv_csr(A, xd, cfg)  # noqa: E731
    res = call()
    cs.check(res.error_code == 0, f"{label}: error {res.error_code}")
    plan = res.plan
    inner = plan.inner if isinstance(plan, ReorderedPlan) \
        else plan.plan if isinstance(plan, PatternPlan) else plan
    parts = window_plans(plan)
    # the plan is cached on A: calls run it
    kern = trace(call, calls)
    cs.check(len(kern) > 0, f"{label}: the trace holds no device time")
    total = sum(e.time_range.elapsed_us() for e in kern) / calls
    cs.log(f"== {label}: {type(plan).__name__}"
           + (f" of {len(parts)} window-ELL plans" if len(parts) > 1 else "")
           + (f", {parts[0].values} values, sup "
              f"{'/'.join(str(p.sup) for p in parts)}, "
              f"{sum(p.n_groups for p in parts)} groups, tb {parts[0].tb}, "
              f"S {parts[0].step_groups}" if parts else ", the flat path")
           + f"; device {total:.2f} us/call over {calls} calls, "
           f"{len(kern) / calls:g} launches/call")
    span = device_span(kern, calls)
    if span is not None:
        cs.log(f"  device span per call {span:.2f} us (median): busy "
               f"{total:.2f} us, idle {span - total:.2f} us "
               f"({100 * (1 - total / span):.1f}%)")
    replay = graph_replay_us(lambda: run_plan(plan, xd))
    cs.log(f"  one call replayed from a CUDA graph: {replay:.2f} us (CUDA "
           f"events, median of {cs.SAMPLES} x {cs.ITERS} replays)")
    print_kernels(kern, calls)
    other = [e.name for e in kern if not any(k in e.name for k in OURS)]
    cap = other_launches(plan)
    cs.check(cap is None or len(other) <= cap * calls,
             f"{label}: {len(other) / calls:g} launches per call besides "
             f"the port's kernels: {sorted(set(other))}")
    setups = [e for e in kern if K3_KERNEL in e.name]
    want = launches_per_call(plan)
    cs.check(len(setups) == calls * want["permute_chunks"],
             f"{label}: {len(setups)} table set-ups (K3) traced over "
             f"{calls} calls")
    cs.log(f"  launches per call: {want['permute_chunks']} table set-ups, "
           f"{want['fold']} folds, {want['section_epilogue']} section "
           f"epilogues, {want['unpermute']} K2, {len(other) / calls:g} "
           f"others; the set-ups "
           f"{sum(e.time_range.elapsed_us() for e in setups) / calls:.2f} us")
    # K1 per section: of a call of one window-ELL plan, or per band of a
    # banded call (its pattern form included)
    banded = isinstance(inner, BandedPlan) \
        and not isinstance(plan, ReorderedPlan)
    if not (banded or len(parts) == 1):
        return
    bands = inner.plans if banded else parts
    per_band, join = [kern], []
    if len(bands) > 1:
        cut = split_bands(kern, calls, len(bands))
        cs.check(cut is not None,
                 f"{label}: the trace's calls cannot be cut into bands")
        per_band, join = cut
    for k, (band, events) in enumerate(zip(bands, per_band)):
        n_k2 = cs.epilogue_launches(band)[1] \
            or int(isinstance(plan, ReorderedPlan))
        if len(bands) > 1:
            cs.log(f"  band {k} ({band.num_rows} rows, {band.n_groups} "
                   f"groups): "
                   f"{sum(e.time_range.elapsed_us() for e in events) / calls:.2f}"
                   f" us/call, {len(events) / calls:g} launches/call")
        print_schedule(band)
        cs.log("  K1 per section, fold + epilogue (K2 after the last), "
               "section order (us): "
               + ", ".join(f"{t:.2f}" for t in k1_sections(
                   f"{label} band {k}", events, band, calls,
                   k2=n_k2 == 1)))
    if join:
        cs.log(f"  the join: "
               f"{sum(e.time_range.elapsed_us() for e in join) / calls:.2f} "
               f"us/call, 1 launch/call ({join[0].name[:60]})")


def held_launches(label: str, kern: list, calls: int, want: dict) -> None:
    """Fails unless the trace holds ``want`` launches per call of each of
    the port's kernels (``launches_per_call``'s keys)."""
    for key, name in (("fold", FOLD_KERNEL),
                      ("section_epilogue", EPILOGUE_KERNEL),
                      ("unpermute", K2_KERNEL),
                      ("permute_chunks", K3_KERNEL)):
        got = sum(name in e.name for e in kern)
        cs.check(got == want[key] * calls,
                 f"{label}: {got} {name} launches traced, "
                 f"{want[key] * calls} expected")


def sharded(calls: int, dev) -> None:
    """The sharded cells (module docstring): per cell, device µs per call,
    the span and idle share, by kernel name, the launches held."""
    import torch

    from tpu_spmv_torch import KernelType, SpMVConfig, spmv_csr
    from tpu_spmv_torch.kernels import FOLD_VARIANTS
    from tpu_spmv_torch.parallel import (make_row_mesh, shard_csr,
                                         shard_csr_packed, shard_csr_ring,
                                         spmv_csr_ring, spmv_csr_sharded,
                                         spmv_csr_sharded_packed)
    from tpu_spmv_torch.spmv import run_plan
    from tpu_spmv_torch.spmv import launches_per_call

    A, x, twin, L, xl = cs.sharded_matrices()
    xd, xld = (torch.from_numpy(v).to(dev) for v in (x, xl))
    mesh = make_row_mesh(cs.SHARDS, devices=[str(dev)] * cs.SHARDS)
    res = spmv_csr(A, xd, SpMVConfig(kernel_type=KernelType.MERGE_PATH),
                   device=dev)
    cs.check(res.error_code == 0, f"sharded: error {res.error_code}")
    cells = [("single plan", lambda: run_plan(res.plan, xd),
              launches_per_call(res.plan))]
    packed = {"f32": (A, {}), "bf16": (A, {"values_dtype": "bfloat16"}),
              "pattern": (twin, {"pattern": True}),
              "leveled": (A, {"permute_rows": True})}
    for what, make, run, xs in (
            [("flat", lambda: shard_csr(A, mesh), spmv_csr_sharded, xd)]
            + [(f"packed {k}", lambda M=M, kw=kw: shard_csr_packed(
                M, mesh, **kw), spmv_csr_sharded_packed, xd)
               for k, (M, kw) in packed.items()]
            + [("ring, local structure", lambda: shard_csr_ring(L, mesh),
                spmv_csr_ring, xld)]):
        sh = make()
        per = cs.sharded_launches(sh)
        want = {k: per[k] for k in ("section_epilogue", "unpermute",
                                    "permute_chunks")}
        want["fold"] = sum(per[v] for v in FOLD_VARIANTS.values())
        cells.append((what, lambda sh=sh, run=run, xs=xs: run(sh, xs),
                      want))
    for what, fn, want in cells:
        fn()
        kern = trace(fn, calls)
        label = f"sharded {what}"
        cs.check(len(kern) > 0, f"{label}: the trace holds no device time")
        held_launches(label, kern, calls, want)
        busy = sum(e.time_range.elapsed_us() for e in kern) / calls
        span = device_span(kern, calls)
        idle = "not measured (dropped launches)" if span is None else \
            f"span {span:.2f} us, idle {100 * (1 - busy / span):.1f}%"
        cs.log(f"== {label}: device {busy:.2f} us/call over {calls} calls, "
               f"{len(kern) / calls:g} launches/call; {idle}; the port's "
               f"kernels a call {want}")
        print_kernels(kern, calls)


def ablation(A, calls: int, dev) -> None:
    """K1 as the SpMV runs it on the PageRank plan's gather table (x the
    uniform ranks, scaled as ``spmv_pattern`` feeds it) at R = 1, the
    module's R and no cut."""
    import dataclasses

    import torch

    from tpu_spmv_torch import KernelType, SpMVConfig, spmv_csr
    from tpu_spmv_torch.kernels import window_ell as twe
    from tpu_spmv_torch.timing import time_cuda

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
        kern = trace(lambda: twe.fold_sections(plan, table), calls)
        secs = k1_sections(f"ablation {what}", kern, plan, calls, k2=False)
        us = time_cuda(lambda: twe.fold_sections(plan, table),
                       iters=cs.ITERS, samples=cs.SAMPLES) * 1e6
        cs.log(f"-- {what}: K1 {us:.2f} us/call (CUDA events); per "
               f"section, fold + epilogue (us): "
               + ", ".join(f"{t:.2f}" for t in secs))
        print_schedule(plan)
        print_kernels(kern, calls)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--calls", type=int, default=20)
    ap.add_argument("--cells",
                    default="headline,mesh,banded,ab,levers,pagerank")
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
    if "mesh" in cells or "banded" in cells:
        # banded: the mesh's natural arm, a row-banded stack
        runs.append(("scrambled_banded_csr", cs.MESH,
                     [{"reorder": None}] * ("mesh" in cells)
                     + [{"reorder": False}] * ("banded" in cells)))
    if "ab" in cells:
        runs += [(name, a, [{"reorder": False}, {"reorder": None}])
                 for name, a in cs.AB]
    if "pagerank" in cells or "ablation" in cells:
        # PageRank's SpMV: the pattern path at its VECTOR_CSR kernel type
        runs.append(("web_graph_csr", cs.PAGERANK, [
            {"pattern": True, "kernel_type": KernelType.VECTOR_CSR}]
            if "pagerank" in cells else []))
    if "web" in cells or "pagerank1m" in cells:
        # the 1M-node web graph, and PageRank's SpMV on it column-normalised
        runs.append(("web_graph_1m", cs.WEB,
                     [{}] * ("web" in cells)
                     + [{"pattern": True,
                         "kernel_type": KernelType.VECTOR_CSR}]
                     * ("pagerank1m" in cells)))
    if "wide" in cells:
        runs += [("web_graph_csr", cs.WIDE, [{}]),
                 ("power_law_csr", cs.COMPOSITE, [{}]),
                 ("web_graph_csr", cs.WEB_1_5M, [{}])]
    if "ell" in cells:
        runs += [("stencil_csr", (g,), [{}] + [{"pattern": True}]
                  * (g == cs.PATTERN_STENCIL)) for g in cs.STENCILS]
    if "sharded" in cells:
        sharded(args.calls, dev)
    if "floors" in cells:
        runs.append(("power_law_csr", cs.HEADLINE, [
            {"kernel_type": KernelType.SCALAR_CSR},
            {"kernel_type": KernelType.ELL_KERNEL}]))
    for name, a, arms in runs:
        rng = tt.RandomGenerator(42)
        if name == "power_law_csr":
            A = rng.power_law_csr(*a)
        elif name == "web_graph_csr" and len(a) == 2:
            A = tt.transition_matrix(tt.web_graph_csr(rng, a[0], a[0],
                                                      avg_nnz=a[1]))
        elif name == "stencil_csr":
            A = tt.stencil_csr(*a)
        elif name in ("web_graph_csr", "web_graph_1m"):
            A = tt.web_graph_csr(rng, *a[:2], avg_nnz=a[2])
        else:
            A = getattr(tt, name)(rng, *a)
        x = rng.vector(A.num_cols)
        for changes in arms:
            M = A
            if changes.get("pattern") and name in ("power_law_csr",
                                                   "stencil_csr"):
                # a column-scaled matrix of the headline's structure
                s = tt.RandomGenerator(7).rng.uniform(0.5, 2.0, A.num_cols) \
                    .astype(np.float32)
                M = CSRMatrix(A.num_rows, A.num_cols, s[A.col_indices],
                              A.col_indices, A.row_ptrs)
            elif changes.get("pattern") and name == "web_graph_1m":
                M = tt.transition_matrix(A)
            profile(f"{name}{a} {changes}", M, x, changes, args.calls, dev,
                    ell=name == "stencil_csr")
        if name == "web_graph_csr" and "ablation" in cells:
            ablation(A, args.calls, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
