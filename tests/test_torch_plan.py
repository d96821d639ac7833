"""The port's NumPy planner against the JAX package's planner.

Both planners run on the same host CSR (made by the same seeded generator)
and must give equal plans: every array leaf equal element for element
(``np.array_equal``) and every static field equal.  The JAX planner calls
``_absorb_run_padding``, which its module no longer defines; the tests bind
the port's copy of that helper into the JAX module for the test's duration
(``monkeypatch``), so no file of the JAX package changes.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import tpu_spmv.kernels.window_ell as jwe  # noqa: E402
from tpu_spmv.utils.testing import RandomGenerator as JaxRandomGenerator  # noqa: E402

from tpu_spmv_torch.kernels import plan as tplan  # noqa: E402
from tpu_spmv_torch.utils.testing import RandomGenerator  # noqa: E402


def smoke_matrix():
    """The bench's smoke matrix (``bench.py:74-75``)."""
    return RandomGenerator(42).power_law_csr(8192, 2048, 12.0, 1.6)


@pytest.fixture
def absorb_helper(monkeypatch):
    monkeypatch.setattr(jwe, "_absorb_run_padding",
                        tplan._absorb_run_padding, raising=False)


def assert_plans_equal(jax_plan, host_plan):
    for name in tplan.LEAVES:
        a, b = getattr(jax_plan, name), getattr(host_plan, name)
        if a is None or b is None:
            assert a is None and b is None, name
            continue
        a = np.asarray(a)
        assert a.dtype == b.dtype, name
        assert np.array_equal(a, b), name
    for name in tplan.AUX:
        assert getattr(jax_plan, name) == getattr(host_plan, name), name
    assert jax_plan.occupancy == host_plan.occupancy


@pytest.mark.parametrize("t_base", [2, 4, 8])
@pytest.mark.parametrize("sup", [1024, 4096])
@pytest.mark.parametrize("permute_rows", [False, True])
@pytest.mark.parametrize("step_groups", [8, 16])
def test_plan_equals_jax_plan(absorb_helper, step_groups, permute_rows, sup,
                              t_base):
    A = smoke_matrix()
    kw = dict(split_rows=128, step_groups=step_groups, sup=sup,
              permute_rows=permute_rows, t_base=t_base)
    assert_plans_equal(jwe.WindowEllPlan.build(A, **kw),
                       tplan.build(A, **kw))


def test_plan_equals_jax_plan_without_helper():
    """A plan the JAX planner builds today, with nothing bound into it: no
    superblock of this matrix has a run-padding deficit."""
    A = RandomGenerator(42).power_law_csr(512, 512, 25.0, 1.8)
    kw = dict(split_rows=128, step_groups=8, permute_rows=True)
    host = tplan.build(A, **kw)
    assert host.lam is not None
    assert_plans_equal(jwe.WindowEllPlan.build(A, **kw), host)


@pytest.mark.parametrize("split_rows", [None, 128])
def test_superblock_choice_matches(absorb_helper, split_rows):
    A = smoke_matrix()
    assert tplan._choose_sup(A, with_groups=True, split_rows=split_rows) \
        == jwe._choose_sup(A, with_groups=True, split_rows=split_rows)
    _, jax_plan = jwe.build_auto(A, split_rows=split_rows, step_groups=8)
    host = tplan.build_auto(A, split_rows=split_rows, step_groups=8)
    assert host.sup == jax_plan.sup
    assert_plans_equal(jax_plan, host)


def test_choose_sup_without_short_circuit():
    """A shallow matrix (mean narrow bucket depth < 2) runs the sampled
    cost model in both planners."""
    A = RandomGenerator(5).power_law_csr(4096, 16384, 3.0, 1.6)
    assert tplan._choose_sup(A, with_groups=True, split_rows=128) \
        == jwe._choose_sup(A, with_groups=True, split_rows=128)


@pytest.mark.parametrize("shape", [(8192, 2048, 12.0, 1.6),
                                   (300, 700, 9.0, 1.3)])
def test_generator_matches(shape):
    a = RandomGenerator(42).power_law_csr(*shape)
    b = JaxRandomGenerator(42).power_law_csr(*shape)
    assert (a.num_rows, a.num_cols) == (b.num_rows, b.num_cols)
    for name in ("values", "col_indices", "row_ptrs"):
        assert np.array_equal(getattr(a, name), getattr(b, name)), name
    assert np.array_equal(RandomGenerator(3).vector(77),
                          JaxRandomGenerator(3).vector(77))


def test_dense_generators_match():
    a, b = RandomGenerator(9), JaxRandomGenerator(9)
    assert a.uniform(-1.0, 2.0) == b.uniform(-1.0, 2.0)
    assert a.uniform_int(3, 70) == b.uniform_int(3, 70)
    ca, cb = a.csr(60, 45, 0.2), b.csr(60, 45, 0.2)
    for name in ("values", "col_indices", "row_ptrs"):
        assert np.array_equal(getattr(ca, name), getattr(cb, name)), name


def test_absorb_run_padding_spreads_deficit_by_excess():
    """Superblock 0 has buckets of excess 3, 1, 0 and a deficit of 2: the
    deepest bucket takes both.  Superblock 1 (excess 1, 1; deficit 3)
    takes what its buckets can absorb, 1 each."""
    cap = np.array([1, 1, 1, 2, 2])
    excess = np.array([1, 3, 0, 1, 1])
    sup_binv = np.array([0, 0, 0, 1, 1])
    out = tplan._absorb_run_padding(cap, excess, sup_binv, 2,
                                    np.array([2, 3]))
    assert out.tolist() == [1, 3, 1, 3, 3]
    assert cap.tolist() == [1, 1, 1, 2, 2]


def test_banded_routes_are_not_ported():
    """Where the JAX build_auto would build a row-banded stack, the port
    raises instead of building another plan."""
    A = smoke_matrix()
    with pytest.raises(NotImplementedError, match="M7"):
        tplan.build_auto(A, split_rows=128, step_groups=8,
                         choice=(1024, tplan.MAX_GROUPS + 1))
    # bf16 value streams are ported: a value stream of any other type is
    # refused, not built
    assert tplan.build(A, split_rows=128, step_groups=8,
                       values_dtype="bfloat16").values_dtype == "bfloat16"
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        tplan.build(A, split_rows=128, values_dtype=np.float16)
