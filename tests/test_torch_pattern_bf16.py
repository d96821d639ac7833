"""The port's pattern plans and bf16 value streams against the JAX package's.

* The port planner's pattern and bf16 plans equal the JAX planner's leaf for
  leaf; a bf16 value stream is compared bit for bit (through ``uint16``)
  after the port's upload cast, which rounds to nearest even as JAX's
  ``astype`` does.
* ``plan_from_arrays`` takes a JAX bf16 plan's leaves as they are.
* K1's plain version on pattern plans (sup 1024 with the nibble-15
  sentinel, 4096 and 16384 with -1, merge-path with extras sections that
  publish) is held to JAX ``spmv_pattern`` in interpret mode and to the CPU
  oracle at the row bound ``1e-5 * max((|A||x|)_i, 1)``: both sum the same
  products in different orders.  bf16 plans are held to JAX's bf16 plan at
  the same bound and to the oracle at 8e-3 (the value rounding).
* The dispatch: ``SpMVConfig(pattern=True)`` and ``bf16_values``, and the
  plan cache keyed on the bf16 flag.

The JAX planner calls ``_absorb_run_padding``, which its module does not
define; the tests bind the port's copy into it for their duration.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import tpu_spmv  # noqa: E402
import tpu_spmv.kernels.window_ell as jwe  # noqa: E402
from tpu_spmv.csr import CSRMatrix as JaxCSRMatrix  # noqa: E402

import tpu_spmv_torch  # noqa: E402
from tpu_spmv_torch import KernelType, SpMVConfig  # noqa: E402
from tpu_spmv_torch.kernels import plan as tplan  # noqa: E402
from tpu_spmv_torch.kernels import window_ell as twe  # noqa: E402
from tpu_spmv_torch.spmv import PatternPlan  # noqa: E402
from tpu_spmv_torch.utils.testing import (RandomGenerator,  # noqa: E402
                                          abs_row_scale, spmv_matches)

ROW_TOL = 1e-5
BF16_TOL = 8e-3
CPU = "cpu"


@pytest.fixture
def absorb_helper(monkeypatch):
    monkeypatch.setattr(jwe, "_absorb_run_padding",
                        tplan._absorb_run_padding, raising=False)


@pytest.fixture(scope="module")
def matrix():
    A = RandomGenerator(42).power_law_csr(8192, 2048, 12.0, 1.6)
    return A, RandomGenerator(7).vector(A.num_cols)


def column_scaled(A, seed=3):
    """``A``'s structure with every stored value of column j equal to
    ``s[j]``, s uniform in [0.5, 2.0) (``bench.py:354``): the matrices the
    pattern path serves.  Returns ``(matrix, s)``."""
    s = RandomGenerator(seed).rng.uniform(0.5, 2.0, A.num_cols) \
        .astype(np.float32)
    return tpu_spmv_torch.CSRMatrix(A.num_rows, A.num_cols, s[A.col_indices],
                                    A.col_indices, A.row_ptrs), s


def to_jax(A):
    return JaxCSRMatrix(A.num_rows, A.num_cols, A.values, A.col_indices,
                        A.row_ptrs)


def bf16_bits(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int16).numpy().view(np.uint16)


def device_leaves(hp: tplan.HostPlan) -> dict:
    """The leaves as the port uploads them: bf16 values cast."""
    plan = twe.plan_from_host(hp, CPU)
    return {k: getattr(plan, k) for k in tplan.LEAVES}


def assert_plans_equal(jp, hp: tplan.HostPlan):
    leaves = device_leaves(hp)
    for name in tplan.LEAVES:
        a, b = getattr(jp, name), leaves[name]
        if a is None or b is None:
            assert a is None and b is None, name
        elif name == "vals" and b.dtype == torch.bfloat16:
            assert str(np.asarray(a).dtype) == "bfloat16"
            assert np.array_equal(np.asarray(a).view(np.uint16),
                                  bf16_bits(b))
        else:
            a = np.asarray(a)
            assert a.dtype == b.numpy().dtype and np.array_equal(
                a, b.numpy()), name
    for name in tplan.AUX:
        assert getattr(jp, name) == getattr(hp, name), name


def assert_row_bound(y, y_ref, A, x, tol=ROW_TOL):
    diff = np.abs(np.asarray(y, np.float32) - np.asarray(y_ref, np.float32))
    bound = tol * np.maximum(abs_row_scale(A, x), 1.0)
    assert np.all(diff <= bound), float(np.max(diff - bound))


def jax_plan(hp: tplan.HostPlan) -> jwe.WindowEllPlan:
    """The JAX plan of the port planner's arrays (bf16 values cast by JAX)."""
    leaves = {k: None if v is None else jnp.asarray(v)
              for k, v in hp.leaves().items()}
    if hp.values_dtype == "bfloat16":
        leaves["vals"] = leaves["vals"].astype(jnp.bfloat16)
    return jwe.WindowEllPlan(**leaves, **hp.aux(), occupancy=hp.occupancy)


# ---- the planner ----

@pytest.mark.parametrize("sup", [1024, 4096, 16384])
@pytest.mark.parametrize("leveled", [False, True])
def test_pattern_plan_equals_jax_plan(matrix, absorb_helper, sup, leveled):
    A, _ = matrix
    kw = dict(split_rows=128, step_groups=16, sup=sup, permute_rows=leveled,
              pattern=True)
    hp = tplan.build(A, **kw)
    assert hp.vals is None and hp.pat and hp.sbn == (sup == 1024)
    assert_plans_equal(jwe.WindowEllPlan.build(A, **kw), hp)


@pytest.mark.parametrize("sup", [1024, 4096])
@pytest.mark.parametrize("leveled", [False, True])
def test_bf16_plan_equals_jax_plan(matrix, absorb_helper, sup, leveled):
    A, _ = matrix
    kw = dict(split_rows=128, step_groups=16, sup=sup, permute_rows=leveled)
    hp = tplan.build(A, **kw, values_dtype="bfloat16")
    assert hp.values_dtype == "bfloat16" and hp.vals.dtype == np.float32
    assert_plans_equal(jwe.WindowEllPlan.build(
        A, **kw, values_dtype=jnp.bfloat16), hp)


def test_build_auto_pattern_and_bf16_equal_jax(matrix, absorb_helper):
    A, _ = matrix
    _, jp = jwe.build_auto(A, split_rows=None, step_groups=8, pattern=True)
    assert_plans_equal(jp, tplan.build_auto(A, split_rows=None,
                                            step_groups=8, pattern=True))
    _, jp = jwe.build_auto(A, split_rows=128, step_groups=8,
                           values_dtype=jnp.bfloat16)
    assert_plans_equal(jp, tplan.build_auto(A, split_rows=128, step_groups=8,
                                            values_dtype="bfloat16"))


def test_plan_from_arrays_takes_jax_bf16_leaves(matrix, absorb_helper):
    A, x = matrix
    kw = dict(split_rows=128, step_groups=8, permute_rows=True)
    jp = jwe.WindowEllPlan.build(A, **kw, values_dtype=jnp.bfloat16)
    leaves = {k: None if getattr(jp, k) is None
              else np.asarray(getattr(jp, k)) for k in tplan.LEAVES}
    assert str(leaves["vals"].dtype) == "bfloat16"
    from_jax = twe.plan_from_arrays(leaves, {k: getattr(jp, k)
                                             for k in tplan.AUX}, CPU)
    from_port = twe.plan_from_host(tplan.build(
        A, **kw, values_dtype="bfloat16"), CPU)
    assert from_jax.values == "bfloat16"
    assert np.array_equal(bf16_bits(from_jax.vals), bf16_bits(from_port.vals))
    xt = torch.from_numpy(x)
    assert torch.equal(twe.spmv_window_ell(from_jax, xt),
                       twe.spmv_window_ell(from_port, xt))
    assert from_jax.stream_bytes == jp.stream_bytes


def test_pattern_sentinel_runs_leave_the_schedule(matrix):
    """A pattern plan's runs that hold only pad slots (sentinel sub-block)
    are dropped from the fold schedule, as valued plans' all-zero runs
    are; every run with a real slot stays."""
    A, _ = matrix
    for sup in (1024, 4096):
        hp = tplan.build(A, split_rows=128, step_groups=16, sup=sup,
                         pattern=True, permute_rows=True)
        plan = twe.plan_from_host(hp, CPU)
        sbu = twe._unpack_sb(hp.sb, hp.sbn)
        live = np.any((sbu != twe.sentinel(hp.sbn))
                      .reshape(-1, hp.tb * 8 * 128), axis=1)
        n_runs = int((hp.blk_step >= 0).sum()) * hp.step_groups // hp.tb
        assert len(live) == n_runs and 0 < live.sum() < n_runs
        runs = torch.cat([s.run_order for s in plan.sections]).numpy()
        assert np.array_equal(np.sort(runs), np.flatnonzero(live))


def test_pattern_plan_sub_blocks_are_checked(matrix):
    A, _ = matrix
    for sup, bad in ((1024, 9), (4096, -2)):
        hp = tplan.build(A, split_rows=128, step_groups=16, sup=sup,
                         pattern=True)
        sb = hp.sb.copy()
        sb[0, 0] = bad    # with sbn: low nibble 9, high nibble 0
        with pytest.raises(tplan.InvalidFormatError, match="sub-block"):
            twe.plan_from_arrays({**hp.leaves(), "sb": sb}, hp.aux(), CPU)
        with pytest.raises(tplan.InvalidFormatError, match="value stream"):
            twe.plan_from_arrays({**hp.leaves(), "vals": np.zeros(
                (hp.n_groups * 8, 128), np.float32)}, hp.aux(), CPU)


# ---- K1's plain version against JAX ----

@pytest.mark.parametrize("sup", [1024, 4096, 16384])
def test_pattern_fold_matches_jax_spmv_pattern(matrix, sup):
    A, x = matrix
    B, s = column_scaled(A)
    hp = tplan.build(B, split_rows=128, step_groups=8, sup=sup,
                     permute_rows=True, pattern=True)
    plan = twe.plan_from_host(hp, CPU)
    assert plan.sbn == (sup == 1024) and len(plan.sections) > 1
    y = twe.spmv_pattern(plan, torch.from_numpy(s), torch.from_numpy(x))
    y_jax = np.asarray(jwe.spmv_pattern(jax_plan(hp), jnp.asarray(s),
                                        jnp.asarray(x)))
    assert y.shape == y_jax.shape == (A.num_rows,)
    assert_row_bound(y.numpy(), y_jax, B, x)
    assert spmv_matches(y.numpy(), B, x, rel_tol=ROW_TOL)


@pytest.mark.parametrize("sup, leveled", [(1024, True), (1024, False),
                                          (4096, True)])
def test_bf16_fold_matches_jax_bf16_plan(matrix, absorb_helper, sup,
                                         leveled):
    A, x = matrix
    kw = dict(split_rows=128, step_groups=8, sup=sup, permute_rows=leveled)
    hp = tplan.build(A, **kw, values_dtype="bfloat16")
    jp = jwe.WindowEllPlan.build(A, **kw, values_dtype=jnp.bfloat16)
    y = twe.spmv_window_ell(twe.plan_from_host(hp, CPU),
                            torch.from_numpy(x)).numpy()
    y_jax = np.asarray(jwe.spmv_window_ell(jp, jnp.asarray(x)))
    assert_row_bound(y, y_jax, A, x)
    assert spmv_matches(y, A, x, rel_tol=BF16_TOL)


def test_pattern_pad_slots_are_masked_before_the_add(matrix):
    """Pad slots gather a real x entry (their lo and wg are 0); a pattern
    plan's plain fold drops them by sentinel, so a huge x there changes
    nothing but the rows that really read it."""
    A, x = matrix
    ones = tpu_spmv_torch.CSRMatrix(A.num_rows, A.num_cols,
                                    np.ones(A.nnz, np.float32),
                                    A.col_indices, A.row_ptrs)
    for sup in (1024, 4096, 16384):
        plan = twe.plan_from_host(tplan.build(
            ones, split_rows=None, step_groups=16, sup=sup, pattern=True),
            CPU)
        xx = x.copy()
        xx[0] = 1e30
        y = twe.spmv_window_ell(plan, torch.from_numpy(xx)).numpy()
        assert spmv_matches(y, ones, xx, rel_tol=ROW_TOL)


# ---- the dispatch ----

def test_pattern_config_routes_by_factorability(matrix):
    """``pattern=True`` serves a column-scaled matrix on a pattern plan and
    a matrix whose values are not column-scaled on the f32 plan, both held
    against the oracle."""
    A, x = matrix
    B, _ = column_scaled(A)
    cfg = SpMVConfig(kernel_type=KernelType.MERGE_PATH, pattern=True)
    pat = tpu_spmv_torch.spmv_csr(B, x, cfg, device=CPU)
    assert isinstance(pat.plan, PatternPlan) and pat.plan.plan.pat
    assert spmv_matches(pat.y_host(), B, x, rel_tol=ROW_TOL)
    assert B._plan_cache["_cscale"] is not None
    C = tpu_spmv_torch.CSRMatrix(A.num_rows, A.num_cols, A.values,
                                 A.col_indices, A.row_ptrs)
    f32 = tpu_spmv_torch.spmv_csr(C, x, cfg, device=CPU)
    assert f32.plan.values == "float32"
    assert C._plan_cache["_cscale"] is None
    assert spmv_matches(f32.y_host(), C, x, rel_tol=ROW_TOL)


def test_pattern_dispatch_matches_jax(matrix, absorb_helper):
    A, x = matrix
    B, _ = column_scaled(A)
    cfg = SpMVConfig(kernel_type=KernelType.VECTOR_CSR, pattern=True,
                     block_size=16)
    res = tpu_spmv_torch.spmv_csr(B, x, cfg, device=CPU)
    jres = tpu_spmv.spmv_csr(to_jax(B), x, tpu_spmv.SpMVConfig(
        kernel_type=tpu_spmv.KernelType.VECTOR_CSR, pattern=True,
        block_size=16))
    assert res.error_code == 0 == jres.error_code
    assert_row_bound(res.y_host(), np.asarray(jres.y), B, x)


def test_bf16_after_f32_gets_a_bf16_plan(matrix):
    """The plan cache keys on the bf16 flag: asked for f32, then bf16, then
    f32 again, one matrix gets each its own plan (the JAX key,
    ``tpu_spmv/spmv.py:155``)."""
    A, x = matrix
    A = tpu_spmv_torch.CSRMatrix(A.num_rows, A.num_cols, A.values,
                                 A.col_indices, A.row_ptrs)
    f32, bf16 = (SpMVConfig(kernel_type=KernelType.MERGE_PATH,
                            bf16_values=b) for b in (False, True))
    r32 = tpu_spmv_torch.spmv_csr(A, x, f32, device=CPU)
    r16 = tpu_spmv_torch.spmv_csr(A, x, bf16, device=CPU)
    again = tpu_spmv_torch.spmv_csr(A, x, f32, device=CPU)
    assert r32.plan.values == "float32" == again.plan.values
    assert r16.plan.values == "bfloat16" and again.plan is r32.plan
    assert r16.plan.stream_bytes == r32.plan.stream_bytes \
        - 2.0 * r32.plan.n_groups * 8 * 128
    assert not torch.equal(r16.y, r32.y)
    assert spmv_matches(r16.y_host(), A, x, rel_tol=BF16_TOL)


def test_bf16_reordered_plan(matrix):
    """A forced reorder with bf16 values: the inner plan carries the bf16
    stream, and the output holds to the oracle at the bf16 bound."""
    from tpu_spmv_torch.kernels.reorder import ReorderedPlan
    from tpu_spmv_torch.utils.testing import scrambled_banded_csr

    A = scrambled_banded_csr(RandomGenerator(42), 16384, 1024, 6.0)
    x = RandomGenerator(7).vector(A.num_cols)
    res = tpu_spmv_torch.spmv_csr(A, x, SpMVConfig(
        kernel_type=KernelType.VECTOR_CSR, bf16_values=True, reorder=True),
        device=CPU)
    assert isinstance(res.plan, ReorderedPlan)
    assert res.plan.inner.values == "bfloat16"
    assert spmv_matches(res.y_host(), A, x, rel_tol=BF16_TOL)


def test_values_dtype_names():
    assert tplan.values_dtype_name(np.float32) == "float32"
    assert tplan.values_dtype_name("bfloat16") == "bfloat16"
    assert tplan.values_dtype_name(jnp.bfloat16) == "bfloat16"
    assert tplan.values_dtype_name(torch.bfloat16) == "bfloat16"
    with pytest.raises(ValueError):
        tplan.values_dtype_name(np.float64)
    plan = twe.plan_from_host(tplan.build(
        RandomGenerator(1).power_law_csr(256, 256, 4.0, 1.5), step_groups=8,
        values_dtype="bfloat16"), CPU)
    assert dataclasses.replace(plan, vals=plan.vals.float()).values \
        == "float32"
