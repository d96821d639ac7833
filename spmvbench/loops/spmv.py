"""The solver loop: ``spmv_csr(A, x, cfg)`` with one client, closed.

``cfg = spmv_auto_config(A)`` is worked out once in set-up, as a solver
does.  The ``x`` vectors (``vectors`` of them, uniform in [-1, 1)) are
made on the device from the seed and cycled over.  After each call the
client waits for its result (``torch.cuda.synchronize()``, as a solver's
stop test waits), and issues the next; every call's latency, from its
issue to its result on hand, is recorded.

Outputs checked: ``check_outputs`` of the window's ``y``, a reservoir
sample drawn from the seed, each against the float64 product of its ``x``,
row by row against ``|A| @ |x|`` (``y_gap``); and the failed calls.

The control (``--control``): the program with its bf16 value stream
switched on (``SpMVConfig.bf16_values``), the precision below float32.

Traffic keys: ``vectors``, ``warmup_calls``, ``check_outputs``,
``trace_warmup``, ``trace_calls``, ``trace_closing`` and ``limits``.
"""

from __future__ import annotations

import dataclasses
import random
import time

import torch

from spmvbench.reference import plain

SPANS = ("spmv.dispatch", "spmv.wait")


@dataclasses.dataclass
class State:
    cell: object
    A: object                  # the program's CSRMatrix
    cfg: object
    spmv: object
    X: torch.Tensor            # (vectors, cols) f32 on the device
    xs: list                   # X's rows
    next_x: int = 0
    kept: list = dataclasses.field(default_factory=list)


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def prepare(cell, run) -> State:
    import tpu_spmv_torch as program

    t = cell.traffic
    m = cell.matrix
    A = program.CSRMatrix(m.num_rows, m.num_cols, m.values, m.col_indices,
                          m.row_ptrs)
    cfg = program.spmv_auto_config(A)
    if cell.control:
        cfg.bf16_values = True
    g = torch.Generator(device=cell.device)
    g.manual_seed(cell.seed)
    X = torch.rand(int(t["vectors"]), m.num_cols, generator=g,
                   device=cell.device) * 2.0 - 1.0
    spmv = program.spmv_csr
    first = spmv(A, X[0], cfg, device=cell.device)
    if first.error_code:
        raise RuntimeError(f"the first call failed: error {first.error_code}")
    run.plan_s = first.plan_seconds
    state = State(cell, A, cfg, spmv, X, list(X.unbind(0)))
    for _ in range(int(t["warmup_calls"])):
        _call(state)
    state.next_x = 0
    return state


def _call(state: State) -> tuple:
    """One call, then the wait: ``(x index, result, issue, returned,
    result on hand)``, the times in ns."""
    i = state.next_x
    state.next_x = (i + 1) % len(state.xs)
    t0 = time.perf_counter_ns()
    res = state.spmv(state.A, state.xs[i], state.cfg,
                     device=state.cell.device)
    t1 = time.perf_counter_ns()
    _sync(state.cell.device)
    return i, res, t0, t1, time.perf_counter_ns()


def window(state: State, seconds: float, run) -> None:
    rng = random.Random(state.cell.seed)
    k = int(state.cell.traffic["check_outputs"])
    kept = state.kept
    t_start = time.perf_counter_ns()
    deadline = t_start + int(seconds * 1e9)
    while True:
        i, res, t_issue, t_back, t_done = _call(state)
        run.dispatch_ns.append(t_back - t_issue)
        run.latency_ns.append(t_done - t_issue)
        if res.error_code:
            run.failed += 1
        n = run.calls
        run.calls += 1
        item = (i, res.y)
        if len(kept) < k:
            kept.append(item)
        else:
            j = rng.randrange(n + 1)
            if j < k:
                kept[j] = item
        if t_done >= deadline:
            break
    run.window_s = (t_done - t_start) * 1e-9


def run_calls(state: State, n: int, spans: list) -> int:
    """``n`` calls, each call and its wait appended to ``spans`` as
    ``(name, start, end)`` in ``time.time_ns()``; the SpMVs made."""
    xs, A, cfg, spmv, dev = (state.xs, state.A, state.cfg, state.spmv,
                             state.cell.device)
    clock = time.time_ns
    for _ in range(n):
        t0 = clock()
        spmv(A, xs[state.next_x], cfg, device=dev)
        t1 = clock()
        state.next_x = (state.next_x + 1) % len(xs)
        _sync(dev)
        spans += [(SPANS[0], t0, t1), (SPANS[1], t1, clock())]
    return n


def release(state: State) -> None:
    """Drop the program's matrix and the plans cached on it."""
    state.A = state.spmv = state.xs = None


def check(state: State, run) -> dict:
    limits = state.cell.traffic["limits"]
    op = plain.Operator(state.cell.matrix, state.cell.device)
    refs = {}
    gap = 0.0 if state.kept else float("inf")
    for i, y in state.kept:
        if i not in refs:
            x = state.X[i]
            refs[i] = (op.matvec(x), op.matvec(x, absolute=True))
        gap = max(gap, plain.output_gap(y, *refs[i]))
    return {"y_gap": (gap, limits["y_gap"]),
            "failed": (run.failed, limits["failed"])}
