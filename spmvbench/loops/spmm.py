"""The aggregation loop: ``spmv_csr(A, H, cfg)`` for a dense ``H`` of
``(cols, width)`` with one client, closed: a GCN layer's ``Â · H``.

``cfg = spmv_auto_config(A)`` is worked out once in set-up.  The
``operands`` feature matrices (``(cols, width)``, ``width`` from the
configuration, uniform in [-1, 1), row-major) are made on the device from
the seed and cycled over.  After each call the client waits for its result
and issues the next; every call's latency, from its issue to its result
on hand, is recorded.  ``window``, ``run_calls`` and ``release`` are the
solver loop's (``loops/spmv.py``), and the run records the solver loop's
fields under its kind (``run.loop`` ``"spmv"``), so the ``spmv`` readers
read it; the loop also sets ``run.width``, the operand's width, for the
SpMM's byte model.

Outputs checked: ``check_outputs`` of the window's ``Y``, a reservoir
sample drawn from the seed, each against the float64 product of its
operand, entry by entry against ``|A| @ |H|`` (``y_gap``,
:mod:`spmvbench.reference.spmm`); and the failed calls.

The control (``--control``): the program handed each operand rounded to
bfloat16, the precision below float32, while the check holds ``Y`` to the
float32 operand.  (The value stream is no control: the program's bf16
stream takes no 2-D operand.)

Traffic keys: ``operands``, ``warmup_calls``, ``check_outputs``,
``trace_warmup``, ``trace_calls``, ``trace_closing`` and ``limits``.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from spmvbench.reference import plain, spmm
from spmvbench.run import load_module

solve = load_module(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                 "spmv.py"), "loop_spmv")
window, run_calls, release = solve.window, solve.run_calls, solve.release


def operands(n: int, rows: int, width: int, seed: int, device) -> list:
    """``n`` operands of ``(rows, width)``, uniform in [-1, 1), drawn on
    ``device`` from all the bits of ``seed``, one at a time."""
    g = torch.Generator(device=device)
    g.manual_seed(int(np.random.SeedSequence(seed).generate_state(
        1, np.uint64)[0]) >> 1)
    return [torch.rand(rows, width, generator=g, device=device).mul_(2.0)
            .sub_(1.0) for _ in range(n)]


def prepare(cell, run) -> "solve.State":
    import tpu_spmv_torch as program

    run.loop = "spmv"
    t = cell.traffic
    m = cell.matrix
    width = int(cell.config["width"])
    run.width = width
    A = program.CSRMatrix(m.num_rows, m.num_cols, m.values, m.col_indices,
                          m.row_ptrs)
    cfg = program.spmv_auto_config(A)
    H = operands(int(t["operands"]), m.num_cols, width, cell.seed,
                 cell.device)
    given = [h.bfloat16().float() for h in H] if cell.control else H
    spmv = program.spmv_csr
    first = spmv(A, given[0], cfg, device=cell.device)
    if first.error_code:
        raise RuntimeError(f"the first call failed: error {first.error_code}")
    run.plan_s = first.plan_seconds
    del first
    state = solve.State(cell, A, cfg, spmv, H, given)
    for _ in range(int(t["warmup_calls"])):
        solve._call(state)
    state.next_x = 0
    return state


def check(state: "solve.State", run) -> dict:
    """Each sampled ``Y`` against the float64 product of its operand (the
    float32 one, also in the control), one operand at a time."""
    limits = state.cell.traffic["limits"]
    op = plain.Operator(state.cell.matrix, state.cell.device)
    gap = 0.0 if state.kept else float("inf")
    for i in sorted({i for i, _ in state.kept}):
        ys = [y for j, y in state.kept if j == i]
        gap = max(gap, spmm.output_gap(op, state.X[i], ys))
    return {"y_gap": (gap, limits["y_gap"]),
            "failed": (run.failed, limits["failed"])}
