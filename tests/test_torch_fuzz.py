"""Structural fuzz of the port's window-ELL planner and its plain SpMVs:
the seven cases of ``tests/test_fuzz.py``, one for one, with the same
structures (``tpu_spmv_torch.soak.fuzz_matrix``, the JAX ``_matrix``), the
same seed (``RandomGenerator(42)``, the JAX suite's ``rng`` fixture), trial
counts, size ranges, levers, environment settings and ``tested >=`` floors.

Each trial builds the plan with both planners and holds the port's to the
JAX package's leaf for leaf (the port's plan as it is uploaded, so a bf16
value stream is compared bit for bit through ``uint16``); a layout that one
planner rejects (``WindowEllOverflow``) the other must reject too.  The
port's plan then runs through the kernels' plain versions on the CPU
(``plan_from_host(hp, "cpu")``, ``spmv_window_ell``, ``spmv_banded``), held
to the CPU oracle at the JAX slice's tolerance: ``spmv_matches`` at rel
1e-5, and for bf16 values the row-mass bound ``|y - y_ref| <= 5e-3 * mass +
1e-4``.  The equal plans and the oracle together stand in for the JAX
slice's interpret-mode Pallas runs, which the port's tests leave out.

Where the JAX slice leaves the step width to its planner, both planners get
8, the width the JAX planner takes in interpret mode.  The JAX planner's
missing ``_absorb_run_padding`` (F0) is bound from the port for each test.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import tpu_spmv.kernels.window_ell as jwe  # noqa: E402
from tpu_spmv.csr import CSRMatrix as JaxCSRMatrix  # noqa: E402

from tpu_spmv_torch import CSRMatrix  # noqa: E402
from tpu_spmv_torch.kernels import plan as tplan  # noqa: E402
from tpu_spmv_torch.kernels import window_ell as twe  # noqa: E402
from tpu_spmv_torch.soak import fuzz_matrix  # noqa: E402
from tpu_spmv_torch.utils.testing import (RandomGenerator,  # noqa: E402
                                          spmv_matches)

CPU = "cpu"
REL_TOL = 1e-5
# the step width of the JAX planner in interpret mode, where the JAX slice
# leaves it to the planner
INTERPRET_STEP = 8


@pytest.fixture
def r(monkeypatch):
    """The JAX suite's ``rng`` fixture's generator, with F0's helper bound
    into the JAX planner."""
    monkeypatch.setattr(jwe, "_absorb_run_padding",
                        tplan._absorb_run_padding, raising=False)
    return RandomGenerator(42).rng


def to_jax(A):
    return JaxCSRMatrix(A.num_rows, A.num_cols, A.values, A.col_indices,
                        A.row_ptrs)


def bf16_bits(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int16).numpy().view(np.uint16)


def assert_plans_equal(jp, plan) -> None:
    """A JAX plan and the port's plan as uploaded to the CPU: every leaf
    equal (bf16 values bit for bit) and every static field."""
    for name in tplan.LEAVES:
        a, b = getattr(jp, name), getattr(plan, name)
        if a is None or b is None:
            assert a is None and b is None, name
        elif b.dtype == torch.bfloat16:
            assert str(np.asarray(a).dtype) == "bfloat16", name
            assert np.array_equal(np.asarray(a).view(np.uint16),
                                  bf16_bits(b)), name
        else:
            a = np.asarray(a)
            assert a.dtype == b.numpy().dtype, name
            assert np.array_equal(a, b.numpy()), name
    for name in tplan.AUX:
        assert getattr(jp, name) == getattr(plan, name), name


def both_plans(csr, port_kw: dict, jax_kw: dict):
    """The port's plan on the CPU, held to the JAX planner's; ``None`` where
    both planners reject the layout."""
    try:
        hp = tplan.build(csr, **port_kw)
    except tplan.WindowEllOverflow:
        hp = None
    try:
        jp = jwe.WindowEllPlan.build(to_jax(csr), **jax_kw)
    except jwe.WindowEllOverflow:
        jp = None
    assert (hp is None) == (jp is None), "one planner rejected the layout"
    if hp is None:
        return None
    plan = twe.plan_from_host(hp, CPU)
    assert_plans_equal(jp, plan)
    return plan


def spmv(plan, x) -> np.ndarray:
    return twe.spmv_window_ell(plan, torch.from_numpy(x)).numpy()


def test_packer_fuzz(r):
    tested = 0
    for trial in range(40):
        kind = int(r.integers(0, 5))
        if trial % 2 == 0:
            rows = int(r.integers(2049, 6000))
            cols = int(r.integers(1025, 5000))
        else:
            rows = int(r.integers(1, 1200))
            cols = int(r.integers(1, 2500))
        csr = fuzz_matrix(r, kind, rows, cols)
        split = [None, 32, 128][int(r.integers(0, 3))]
        perm = bool(r.integers(0, 2))
        pattern = bool(r.integers(0, 4) == 0)
        t_base = [2, 4, 8][int(r.integers(0, 3))]
        kw = dict(split_rows=split, spill_rounds=int(r.integers(1, 4)),
                  cap_margin=float(r.uniform(0.1, 0.6)),
                  sup=[None, 1024, 4096][int(r.integers(0, 3))],
                  permute_rows=perm, pattern=pattern, t_base=t_base,
                  step_groups=INTERPRET_STEP)
        plan = both_plans(csr, kw, kw)
        if plan is None:
            continue
        assert plan.tb == t_base
        tested += 1
        oracle = csr if not pattern else CSRMatrix(
            csr.num_rows, csr.num_cols,
            np.ones(csr.nnz, np.float32), csr.col_indices, csr.row_ptrs)
        x = r.uniform(-3, 3, cols).astype(np.float32)
        assert spmv_matches(spmv(plan, x), oracle, x, rel_tol=REL_TOL), \
            (trial, kind, rows, cols, split, perm, pattern)
    assert tested >= 20


def test_packer_fuzz_tpu_step_width(r):
    """The JAX package's production step width (128) on shapes crossing the
    superblock, window and block boundaries."""
    for trial in range(6):
        rows = int(r.integers(2500, 9000))
        cols = int(r.integers(1100, 4200))
        kind = int(r.integers(0, 5))
        csr = fuzz_matrix(r, kind, rows, cols)
        kw = dict(split_rows=128, step_groups=128)
        plan = both_plans(csr, kw, kw)
        if plan is None:
            continue
        x = r.uniform(-3, 3, cols).astype(np.float32)
        assert spmv_matches(spmv(plan, x), csr, x, rel_tol=REL_TOL), \
            (trial, rows, cols)


def test_packer_fuzz_spill_beta_and_balancer(r, monkeypatch):
    """Order-statistic spill caps and the extras slot balancer's windows
    and scoring (``TPU_SPMV_BALANCE_WINDOW`` / ``_LAYER``), which both
    planners read."""
    tested = 0
    for trial in range(18):
        kind = int(r.integers(0, 5))
        rows = int(r.integers(1500, 6000))
        cols = int(r.integers(1025, 4200))
        csr = fuzz_matrix(r, kind, rows, cols)
        beta = [1.5, 3.0, 6.0][trial % 3]
        win = [0, 1, 2, 4][int(r.integers(0, 4))]
        monkeypatch.setenv("TPU_SPMV_BALANCE_WINDOW", str(win))
        monkeypatch.setenv("TPU_SPMV_BALANCE_LAYER", str(trial % 3))
        kw = dict(split_rows=[None, 128][trial % 2], spill_beta=beta,
                  cap_slack=int(r.integers(0, 2)),
                  spill_rounds=int(r.integers(1, 3)),
                  step_groups=INTERPRET_STEP)
        plan = both_plans(csr, kw, kw)
        if plan is None:
            continue
        tested += 1
        x = r.uniform(-3, 3, cols).astype(np.float32)
        assert spmv_matches(spmv(plan, x), csr, x, rel_tol=REL_TOL), \
            (trial, kind, rows, cols, beta, win)
    assert tested >= 10


def test_packer_fuzz_combine_levers(r, monkeypatch):
    """The combine-split levers ``TPU_SPMV_BYPASS_K`` and
    ``TPU_SPMV_L2_BALANCE``, on structures heavy in extras."""
    tested = 0
    for trial in range(16):
        kind = [1, 4, 0, 2][trial % 4]
        rows = int(r.integers(1200, 6000))
        cols = int(r.integers(1025, 4200))
        csr = fuzz_matrix(r, kind, rows, cols)
        monkeypatch.setenv("TPU_SPMV_BYPASS_K", str([1, 2, 3, 5][trial % 4]))
        if trial % 2:
            monkeypatch.setenv("TPU_SPMV_L2_BALANCE", "1")
        else:
            monkeypatch.delenv("TPU_SPMV_L2_BALANCE", raising=False)
        kw = dict(split_rows=[None, 32, 128][trial % 3],
                  permute_rows=bool(r.integers(0, 2)),
                  step_groups=INTERPRET_STEP)
        plan = both_plans(csr, kw, kw)
        if plan is None:
            continue
        tested += 1
        x = r.uniform(-3, 3, cols).astype(np.float32)
        assert spmv_matches(spmv(plan, x), csr, x, rel_tol=REL_TOL), \
            (trial, kind, rows, cols)
    assert tested >= 10


def test_packer_fuzz_nonstandard_step_widths(r):
    """Step widths that are not multiples of 16 are normalised at plan time
    (to 8, 16 or a multiple of 16), in both planners alike."""
    for S in (3, 5, 12, 20, 24, 40, 72):
        rows = int(r.integers(1500, 4000))
        cols = int(r.integers(1025, 3000))
        csr = fuzz_matrix(r, int(r.integers(0, 5)), rows, cols)
        kw = dict(split_rows=128, step_groups=S)
        plan = both_plans(csr, kw, kw)
        if plan is None:
            continue
        assert plan.step_groups in (8, 16) or plan.step_groups % 16 == 0
        x = r.uniform(-3, 3, cols).astype(np.float32)
        assert spmv_matches(spmv(plan, x), csr, x, rel_tol=REL_TOL), \
            (S, rows, cols)


def test_packer_fuzz_banded(r):
    """Banded plans: every (n_bands, sup, beta, slack) combination, auto
    band sizing and bands padded to the common height included, band for
    band equal to the JAX planner's."""
    tested = 0
    for trial in range(14):
        kind = int(r.integers(0, 5))
        rows = int(r.integers(2500, 9000))
        cols = int(r.integers(1025, 4200))
        csr = fuzz_matrix(r, kind, rows, cols)
        nb = [None, 2, 3, 5][trial % 4]
        kw = dict(sup=1024, n_bands=nb, spill_beta=[None, 2.6, 2.2][trial % 3],
                  cap_slack=int(r.integers(0, 2)), step_groups=INTERPRET_STEP)
        try:
            hb = tplan.build_banded(csr, **kw)
        except tplan.WindowEllOverflow:
            hb = None
        try:
            jbp = jwe.build_banded(to_jax(csr), **kw)
        except jwe.WindowEllOverflow:
            jbp = None
        assert (hb is None) == (jbp is None), "one planner rejected it"
        if hb is None:
            continue
        tested += 1
        assert sum(hb.band_rows) == csr.num_rows
        assert tuple(jbp.band_rows) == tuple(hb.band_rows)
        bp = twe.banded_from_host(hb, CPU)
        assert len(bp.plans) == len(jbp.plans)
        for jp, plan in zip(jbp.plans, bp.plans):
            assert_plans_equal(jp, plan)
        x = r.uniform(-3, 3, cols).astype(np.float32)
        y = twe.spmv_banded(bp, torch.from_numpy(x)).numpy()
        assert spmv_matches(y, csr, x, rel_tol=REL_TOL), \
            (trial, kind, rows, cols, nb)
    assert tested >= 10


def test_packer_fuzz_bf16_values(r):
    """bf16 value streams with split, sup and leveling, under the per-row
    bf16 value-rounding bound (the row-mass metric)."""
    tested = 0
    for trial in range(12):
        kind = int(r.integers(0, 5))
        rows = int(r.integers(256, 4000))
        cols = int(r.integers(128, 3000))
        csr = fuzz_matrix(r, kind, rows, cols)
        kw = dict(split_rows=[None, 128][int(r.integers(0, 2))],
                  sup=[None, 1024][int(r.integers(0, 2))],
                  permute_rows=bool(r.integers(0, 2)),
                  step_groups=INTERPRET_STEP)
        plan = both_plans(csr, dict(kw, values_dtype="bfloat16"),
                          dict(kw, values_dtype=jnp.bfloat16))
        if plan is None:
            continue
        assert plan.values == "bfloat16"
        tested += 1
        x = r.uniform(-3, 3, cols).astype(np.float32)
        y = spmv(plan, x)
        yref = np.zeros(csr.num_rows, np.float32)
        rl = np.diff(csr.row_ptrs)
        idx = np.repeat(np.arange(csr.num_rows), rl)
        np.add.at(yref, idx, csr.values * x[csr.col_indices])
        mass = np.zeros(csr.num_rows, np.float32)
        np.add.at(mass, idx, np.abs(csr.values * x[csr.col_indices]))
        assert np.all(np.abs(y - yref) <= 5e-3 * mass + 1e-4), \
            (trial, kind, rows, cols)
    assert tested >= 6
