"""PageRank to tolerance: ``pagerank(P, PageRankConfig())`` back to back,
one client, closed.

``P`` is the column-normalised transition matrix of the configuration's
graph (:func:`~spmvbench.reference.matrix.transition_matrix`).  The first
call, in set-up, builds the plan the program caches on ``P``, with the
dangling mask; each call of the window then pays what a user's later call
pays (the plan and mask lookup, each iteration's issue and its read-back),
and the client waits for the ranks before the next call.

A cell on several devices (``Cell.devices``, one a chip of the cell; its
configuration states the layout as ``shards``) ranks ``P`` row-sharded
over them instead: set-up builds the mesh, ``shard_csr_packed(P, mesh,
pattern=True)`` (nnz-balanced row blocks, one pattern window-ELL plan
each) and ``find_dangling_mask(P)`` once, as a caller of
``pagerank_sharded`` must, and makes the first call; each call of the
window is ``pagerank_sharded`` (``x`` copied to every shard's card each
iteration, the rows gathered to the first), and the client waits on the
first card, where the ranks land.

Outputs checked: ``check_outputs`` of the window's calls, a reservoir
sample drawn from the seed.  Each call's ranks against the float64 power
iteration's after as many iterations, node by node against the
reference's rank (``rank_gap``); each call's iteration count against the
count at which the float64 iteration stops (``iter_gap``); the failed
calls.

The control (``--control``): the power iteration with the matrix and the
ranks in bfloat16 (:func:`~spmvbench.reference.plain.pagerank_bf16`) in
the program's place.

Traffic keys: ``damping``, ``tolerance`` and ``max_iterations`` (the
reference's ``PageRankConfig`` defaults, ``pagerank.h:9-15``, given to
both sides), ``warmup_calls``, ``check_outputs``, ``trace_warmup``,
``trace_calls``, ``trace_closing`` and ``limits``.
"""

from __future__ import annotations

import dataclasses
import random
import sys
import time

import torch

from spmvbench.reference import plain
from spmvbench.reference.matrix import transition_matrix

SPANS = ("pagerank.call", "pagerank.wait")


@dataclasses.dataclass
class State:
    cell: object
    P: object                  # the benchmark's transition matrix
    PA: object                 # the program's CSRMatrix of it
    cfg: object
    call: object
    kept: list = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class ControlResult:
    ranks: torch.Tensor
    iterations: int
    error_code: int = 0


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def prepare(cell, run) -> State:
    import tpu_spmv_torch as program

    P = transition_matrix(cell.matrix)
    PA = program.CSRMatrix(P.num_rows, P.num_cols, P.values, P.col_indices,
                           P.row_ptrs)
    t = cell.traffic
    cfg = program.PageRankConfig(damping_factor=float(t["damping"]),
                                 tolerance=float(t["tolerance"]),
                                 max_iterations=int(t["max_iterations"]))
    dev = cell.device
    t0 = time.perf_counter()
    if cell.control:
        def call(_, c, device):
            it, ranks = plain.pagerank_bf16(
                P, float(t["damping"]), float(t["tolerance"]),
                int(t["max_iterations"]), device)
            return ControlResult(ranks, it)
    elif len(cell.devices) > 1:
        call = _sharded(PA, cell)
    else:
        call = program.pagerank
    state = State(cell, P, PA, cfg, call)
    first = call(PA, cfg, device=dev)
    _sync(dev)
    run.plan_s = time.perf_counter() - t0
    if first.error_code:
        raise RuntimeError(f"the first call failed: error {first.error_code}")
    for _ in range(int(cell.traffic["warmup_calls"])):
        call(PA, cfg, device=dev)
        _sync(dev)
    return state


def _sharded(PA, cell):
    """``pagerank_sharded`` over ``PA`` cut into a row block a device of
    the cell, as a call of ``pagerank``'s signature."""
    from tpu_spmv_torch.pagerank import find_dangling_mask
    from tpu_spmv_torch.parallel import (make_row_mesh, pagerank_sharded,
                                         shard_csr_packed)

    mesh = make_row_mesh(devices=cell.devices)
    sp = shard_csr_packed(PA, mesh, pattern=True)
    mask = find_dangling_mask(PA)

    def call(_, cfg, device):
        return pagerank_sharded(sp, mask, cfg)

    return call


def window(state: State, seconds: float, run) -> None:
    rng = random.Random(state.cell.seed)
    k = int(state.cell.traffic["check_outputs"])
    call, PA, cfg, dev = state.call, state.PA, state.cfg, state.cell.device
    kept = state.kept
    t_start = time.perf_counter_ns()
    deadline = t_start + int(seconds * 1e9)
    while True:
        res = call(PA, cfg, device=dev)
        _sync(dev)
        t1 = time.perf_counter_ns()
        if res.error_code:
            run.failed += 1
        run.iterations.append(res.iterations)
        n = run.calls
        run.calls += 1
        item = (res.iterations, res.ranks)
        if len(kept) < k:
            kept.append(item)
        else:
            j = rng.randrange(n + 1)
            if j < k:
                kept[j] = item
        if t1 >= deadline:
            break
    run.window_s = (t1 - t_start) * 1e-9


def run_calls(state: State, n: int, spans: list) -> int:
    """``n`` calls, each call and its wait appended to ``spans`` as
    ``(name, start, end)`` in ``time.time_ns()``; the SpMVs made (one an
    iteration)."""
    clock = time.time_ns
    spmvs = 0
    for _ in range(n):
        t0 = clock()
        res = state.call(state.PA, state.cfg, device=state.cell.device)
        t1 = clock()
        _sync(state.cell.device)
        spans += [(SPANS[0], t0, t1), (SPANS[1], t1, clock())]
        spmvs += res.iterations
    return spmvs


def release(state: State) -> None:
    """Drop the program's matrix and the plans cached on it or held by a
    sharded call, on every card."""
    state.PA = state.call = None


def check(state: State, run) -> dict:
    t = state.cell.traffic
    limits = t["limits"]
    counts = {it for it, _ in state.kept}
    stop, refs, steps = plain.pagerank_iterates(
        state.P, float(t["damping"]), float(t["tolerance"]),
        int(t["max_iterations"]), counts, state.cell.device)
    print(f"spmvbench: the float64 iteration stops at {stop}; its last "
          f"steps {steps[max(stop - 2, 0):stop + 1]}", file=sys.stderr,
          flush=True)
    rank_gap = 0.0 if state.kept else float("inf")
    iter_gap = 0
    for it, ranks in state.kept:
        iter_gap = max(iter_gap, abs(it - stop))
        ref = refs.get(it)
        if ref is None or ranks is None or ranks.shape != ref.shape:
            rank_gap = float("inf")
            continue
        gap = float(((ranks.to(ref.device, torch.float64) - ref).abs()
                     / ref).max())
        rank_gap = max(rank_gap, gap if gap == gap else float("inf"))
    return {"rank_gap": (rank_gap, limits["rank_gap"]),
            "iter_gap": (iter_gap, limits["iter_gap"]),
            "failed": (run.failed, limits["failed"])}
