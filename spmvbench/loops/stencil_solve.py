"""The solver loop over a stencil's CSR matrix: ``spmv_csr(A, x, cfg)``
with one client, closed.

Everything but the control is the solver loop's (``loops/spmv.py``):
``cfg = spmv_auto_config(A)``, the ``x`` vectors drawn from the seed as it
draws them, ``window``, ``run_calls``, ``release`` and ``check``, the
traffic keys, and the outputs checked (each sampled ``y`` against the
float64 product of its ``x``, ``y_gap``; and the failed calls).  The run
records the solver loop's fields under its kind (``run.loop`` ``"spmv"``),
so the ``spmv`` readers read it.

The control (``--control``): the program handed each ``x`` rounded to
bfloat16, the precision below float32, while the check holds its output
to the float32 ``x``.  The value stream is no control here: a stencil's
values (26 and -1 for HPCG) are exact in bfloat16, and past
``VMEM_X_MAX_COLS`` the bf16 configuration is served by the same float32
flat path.
"""

from __future__ import annotations

import os

import torch

from spmvbench.run import load_module

solve = load_module(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                 "spmv.py"), "loop_spmv")
window, run_calls, release, check = (solve.window, solve.run_calls,
                                     solve.release, solve.check)


def prepare(cell, run) -> "solve.State":
    import tpu_spmv_torch as program

    run.loop = "spmv"
    t = cell.traffic
    m = cell.matrix
    A = program.CSRMatrix(m.num_rows, m.num_cols, m.values, m.col_indices,
                          m.row_ptrs)
    cfg = program.spmv_auto_config(A)
    g = torch.Generator(device=cell.device)
    g.manual_seed(cell.seed)
    X = torch.rand(int(t["vectors"]), m.num_cols, generator=g,
                   device=cell.device) * 2.0 - 1.0
    given = X.bfloat16().float() if cell.control else X
    spmv = program.spmv_csr
    first = spmv(A, given[0], cfg, device=cell.device)
    if first.error_code:
        raise RuntimeError(f"the first call failed: error {first.error_code}")
    run.plan_s = first.plan_seconds
    state = solve.State(cell, A, cfg, spmv, X, list(given.unbind(0)))
    for _ in range(int(t["warmup_calls"])):
        solve._call(state)
    state.next_x = 0
    return state
