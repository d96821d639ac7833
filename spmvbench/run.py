"""One run of one cell of the benchmark.

    python3 -m spmvbench --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything is found by name from ``BENCHMARK.json`` at the root of the
checkout: the cell's configuration file (``configs/``), whose
``generator`` names a matrix law (``generators/<law>.py``); the cell's
traffic mix (``traffic/<mix>.json``), whose ``loop`` names the loop that
drives the program (``loops/<loop>.py``); and one reader a metric
(``metrics/<metric>.py``), all under ``spmvbench/``.

A run makes the matrix and its vectors from the seed, hands them to
``tpu_spmv_torch`` (set-up: the first call builds and uploads the plan,
then every shape is warmed up), runs the loop for ``--seconds`` seconds,
and then, with ``--trace 1``, a bounded slice of the same calls under
``torch.profiler``.  A cell on ``chips`` chips runs on the cards 0 to
``chips - 1``; the loop finds them, with the configuration's dict, on its
:class:`Cell`.  Once the window has closed it reads the memory peak (the
fullest card's), looks for JAX in ``sys.modules``, frees the program's
state and holds a sample of the window's outputs, drawn from the seed,
against the plain float64 reference (:mod:`spmvbench.reference.plain`).
It prints each number compared beside its limit as its last lines on
standard error, and one JSON line last on standard output: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and ``checks`` last.

Without a CUDA device (or with fewer than the cell asks for) it exits 2
and prints no result; where a module whose top-level name is ``jax``,
``jaxlib``, ``flax`` or ``tpu_spmv`` was loaded it exits 3 and prints no
result.  ``--control`` puts the control in the program's place (the loop
says which); the benchmark's own runs never pass it.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import os
import sys
import time

from . import trace

BENCH_DIR = "spmvbench"
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "tpu_spmv")


@dataclasses.dataclass
class Run:
    """What one run recorded; the metric readers read it.

    Times in seconds unless named; ``latency_ns`` and ``dispatch_ns`` per
    SpMV call of the window (a call's issue to its result on hand, where
    every call is waited for, and to the program's return);
    ``iterations`` per PageRank call of the window."""

    loop: str
    rows: int
    cols: int
    nnz: int
    device_kind: str
    setup_s: float = 0.0
    plan_s: float = 0.0
    calls: int = 0
    failed: int = 0
    window_s: float = 0.0
    latency_ns: list = dataclasses.field(default_factory=list)
    dispatch_ns: list = dataclasses.field(default_factory=list)
    iterations: list = dataclasses.field(default_factory=list)
    trace: object = None        # trace.Slice of the --trace 1 run
    cards: int = 1              # the distinct devices the run used


@dataclasses.dataclass
class Cell:
    """A cell as a loop sees it."""

    traffic: dict
    matrix: object              # reference.matrix.Matrix
    device: object              # torch.device: the first of ``devices``
    seed: int
    control: bool = False
    config: dict = dataclasses.field(default_factory=dict)
    devices: tuple = ()         # the run's devices, one a chip of the cell


def load_module(path: str, tag: str):
    """The module in ``path``, loaded under a private name."""
    name = "spmvbench_found_" + "".join(
        c if c.isalnum() else "_" for c in tag)
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not os.path.exists(path):
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def find(root: str, kind: str, name: str, ext: str) -> str:
    return os.path.join(root, BENCH_DIR, kind, name + ext)


def read_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def resolve(root: str, workload: str) -> tuple:
    """``(benchmark, cell entry, configuration entry, configuration file,
    traffic mix)`` of ``workload``."""
    bench = read_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    config = read_json(os.path.join(root, conf["file"]))
    traffic = read_json(find(root, "traffic", cell["traffic"], ".json"))
    return bench, cell, conf, config, traffic


def metrics_of(bench: dict, workload: str, traced: bool) -> list:
    """The metric entries the cell reports in this kind of run."""
    group = bench["per_layer"] if traced else bench["end_to_end"]
    return [m for m in group
            if "workloads" not in m or workload in m["workloads"]]


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is JAX's or the
    JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def run_devices(device, chips: int) -> tuple:
    """The devices of a run on ``chips`` chips: the cards 0 to ``chips -
    1``, or ``device`` once a chip where it is not a card."""
    import torch

    if device.type != "cuda":
        return (device,) * chips
    return tuple(torch.device("cuda", i) for i in range(chips))


def run_cell(root: str, workload: str, seed: int, seconds: float,
             traced: bool, device, start: float,
             control: bool = False, devices=None) -> tuple:
    """One run; ``(result, checks)``, or ``(None, message)`` where JAX was
    loaded.  ``result`` is the JSON line's object without ``checks``;
    ``checks`` maps each number compared to ``(value, limit)``.  The run
    uses ``devices`` (one a chip of the cell; by default
    :func:`run_devices`), the matrix drawn on ``device``."""
    import torch

    bench, entry, _, config, traffic = resolve(root, workload)
    seed = int(seed) % (1 << 63)
    law = load_module(find(root, "generators", config["generator"], ".py"),
                      "generator_" + config["generator"])
    loop = load_module(find(root, "loops", traffic["loop"], ".py"),
                       "loop_" + traffic["loop"])
    devices = tuple(run_devices(device, int(entry["chips"]))
                    if devices is None else devices)
    cards = list(dict.fromkeys(devices))
    cuda = device.type == "cuda"
    kind = torch.cuda.get_device_name(device) if cuda else device.type
    t0 = time.perf_counter()
    cell = Cell(traffic, law.generate(config, seed, device), device, seed,
                control, config, devices)
    m = cell.matrix
    if cuda:
        # the peak counts from here: the law's draws on the card are freed
        torch.cuda.empty_cache()
        for d in cards:
            torch.cuda.reset_peak_memory_stats(d)
    run = Run(traffic["loop"], m.num_rows, m.num_cols, m.nnz, kind,
              cards=len(cards))
    t1 = time.perf_counter()
    state = loop.prepare(cell, run)
    if cuda:
        for d in cards:
            torch.cuda.synchronize(d)
    t2 = time.perf_counter()
    run.setup_s = t2 - start
    print(f"spmvbench: set-up {run.setup_s:.3f} s: before the matrix "
          f"{t0 - start:.3f}, the matrix {t1 - t0:.3f} ({m.nnz} nonzeros), "
          f"the program {t2 - t1:.3f} (plan {run.plan_s:.3f})",
          file=sys.stderr, flush=True)
    loop.window(state, float(seconds), run)
    if traced:
        run.trace = trace.record(
            lambda n, spans: loop.run_calls(state, n, spans),
            traffic["trace_warmup"], traffic["trace_calls"],
            traffic["trace_closing"],
            tuple(d.index or 0 for d in cards) if cuda else (0,))
        print(f"spmvbench: trace: {run.trace.waits[0]} of "
              f"{run.trace.waits[1]} device synchronisations inside the "
              f"wait spans", file=sys.stderr, flush=True)
    peak = max(torch.cuda.max_memory_allocated(d) for d in cards) \
        if cuda else 0
    loop.release(state)
    checks = loop.check(state, run)
    correct = all(v <= lim for v, lim in checks.values())

    metrics = {}
    for spec in metrics_of(bench, workload, traced):
        reader = load_module(find(root, "metrics", spec["name"], ".py"),
                             "metric_" + spec["name"])
        value = reader.read(run)
        if value is not None:
            metrics[spec["name"]] = {"value": value, "unit": spec["unit"]}
    dev = {"platform": "gpu" if cuda else device.type, "kind": kind,
           "count": int(entry["chips"]), "memory_peak_bytes": int(peak)}
    result = {"correct": correct, "attempted": run.calls,
              "failed": run.failed, "metrics": metrics, "device": dev}
    if traced:
        t = run.trace
        dev["busy_s"], dev["window_s"] = t.card_busy_s, t.window_s
        result["breakdown"] = {
            "device_ops": [[n, us * 1e-6] for n, us in
                           trace.top_ops(t.device)],
            "idle_gaps": [[n, us * 1e-6] for n, us in
                          trace.idle_gaps(t.device, t.host, *t.span)[:10]]}
    found = forbidden_modules()
    if found:
        return None, f"loaded by the time the window closed: " \
            f"{', '.join(found)}"
    return result, checks


def parse(argv) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="python3 -m spmvbench",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", action="store_true",
                   help="the control in the program's place (not a "
                        "benchmark run)")
    return p.parse_args(argv)


def main(argv, start: float | None = None) -> int:
    start = time.perf_counter() if start is None else start
    args = parse(argv)
    _, entry, _, _, _ = resolve(ROOT, args.workload)
    import torch

    want = int(entry["chips"])
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < want:
        print(f"spmvbench: {args.workload} needs {want} CUDA device(s); "
              f"this machine has {have}", file=sys.stderr)
        return 2
    result, checks = run_cell(ROOT, args.workload, args.seed, args.seconds,
                              bool(args.trace), torch.device("cuda", 0),
                              start, control=args.control)
    if result is None:
        print(f"spmvbench: {checks}", file=sys.stderr)
        return 3
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in checks.items()}
    sys.stdout.flush()
    for k, (v, lim) in checks.items():
        print(f"check {k} {v!r} limit {lim!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
