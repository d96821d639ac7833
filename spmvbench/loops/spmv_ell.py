"""The solver loop over an ELL matrix: ``spmv_ell(E, x, SpMVConfig())``
with one client, closed.

Everything but the set-up is the solver loop's (``loops/spmv.py``):
``window``, ``run_calls``, ``release`` and ``check`` are its own, and so
are the traffic keys, the ``x`` vectors and the outputs checked (each
sampled ``y`` against the float64 CSR product of the configuration's
matrix, ``y_gap``; and the failed calls).

Set-up builds the ELL arrays from the configuration's CSR here, in the
harness: row ``r``'s ``j``-th nonzero in slot ``j``, slot-major
(``values[j * rows + r]``), ``max_nnz_per_row`` slots a row, an unused
slot ``col = -1`` and value 0.

The control (``--control``): the program handed each ``x`` rounded to
bfloat16, the precision below float32, while the check holds its output
to the float32 ``x``.  The value stream is no control here: a stencil's
values (26 and -1 for HPCG) are exact in bfloat16.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from spmvbench.run import load_module

solve = load_module(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                 "spmv.py"), "loop_spmv")
window, run_calls, release, check = (solve.window, solve.run_calls,
                                     solve.release, solve.check)


def ell_arrays(m) -> tuple:
    """``(max_nnz_per_row, values, col_indices)`` of the CSR ``m`` in the
    slot-major ELL layout."""
    lens = np.diff(m.row_ptrs.astype(np.int64))
    k = int(lens.max(initial=0))
    values = np.zeros(k * m.num_rows, np.float32)
    cols = np.full(k * m.num_rows, -1, np.int32)
    rows = np.repeat(np.arange(m.num_rows, dtype=np.int64), lens)
    slot = np.arange(m.nnz, dtype=np.int64) - np.repeat(
        m.row_ptrs[:-1].astype(np.int64), lens)
    flat = slot * m.num_rows + rows
    values[flat] = m.values
    cols[flat] = m.col_indices
    return k, values, cols


def prepare(cell, run) -> "solve.State":
    import tpu_spmv_torch as program

    # the loop records the solve loop's fields, and the readers key on
    # that kind
    run.loop = "spmv"
    t = cell.traffic
    m = cell.matrix
    E = program.ELLMatrix(m.num_rows, m.num_cols, *ell_arrays(m))
    cfg = program.SpMVConfig()
    g = torch.Generator(device=cell.device)
    g.manual_seed(cell.seed)
    X = torch.rand(int(t["vectors"]), m.num_cols, generator=g,
                   device=cell.device) * 2.0 - 1.0
    given = X.bfloat16().float() if cell.control else X
    spmv = program.spmv_ell
    first = spmv(E, given[0], cfg, device=cell.device)
    if first.error_code:
        raise RuntimeError(f"the first call failed: error {first.error_code}")
    run.plan_s = first.plan_seconds
    state = solve.State(cell, E, cfg, spmv, X, list(given.unbind(0)))
    for _ in range(int(t["warmup_calls"])):
        solve._call(state)
    state.next_x = 0
    return state
