"""The port's window-ELL fold (K1) and unpermute (K2) against the JAX
package's kernels.

On the CPU the port's wrappers take their plain PyTorch versions; the JAX
kernels run in Pallas interpret mode, as the JAX package's own tests run
them.  Both see identical plan arrays: the JAX ``WindowEllPlan`` is made from
the port planner's arrays with ``jnp.asarray``.  Both sum in f32 in different
orders, so outputs are held to the backward-error row bound
``|y_port - y_jax|_i <= 1e-5 * max((|A||x|)_i, 1)``
(``tpu_spmv/utils/testing.py:221-248``).

The CUDA kernels themselves are compared with their plain versions on the
card by ``tests/test_torch_cuda.py``.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import tpu_spmv.kernels.window_ell as jwe  # noqa: E402

from tpu_spmv_torch import kernels as tk  # noqa: E402
from tpu_spmv_torch.kernels import plan as tplan  # noqa: E402
from tpu_spmv_torch.kernels import window_ell as twe  # noqa: E402
from tpu_spmv_torch.utils.testing import (RandomGenerator,  # noqa: E402
                                          abs_row_scale, spmv_matches)

ROW_TOL = 1e-5


@pytest.fixture(scope="module")
def matrix():
    A = RandomGenerator(42).power_law_csr(8192, 2048, 12.0, 1.6)
    x = RandomGenerator(7).vector(A.num_cols)
    return A, x


@pytest.fixture
def absorb_helper(monkeypatch):
    monkeypatch.setattr(jwe, "_absorb_run_padding",
                        tplan._absorb_run_padding, raising=False)


def jax_plan_from_host(hp: tplan.HostPlan) -> jwe.WindowEllPlan:
    leaves = {k: None if v is None else jnp.asarray(v)
              for k, v in hp.leaves().items()}
    return jwe.WindowEllPlan(**leaves, **hp.aux(), occupancy=hp.occupancy)


def assert_row_bound(y, y_ref, A, x):
    diff = np.abs(np.asarray(y, np.float32) - np.asarray(y_ref, np.float32))
    bound = ROW_TOL * np.maximum(abs_row_scale(A, x), 1.0)
    assert np.all(diff <= bound), float(np.max(diff - bound))


@pytest.mark.parametrize("leveled", [False, True])
@pytest.mark.parametrize("tb", [2, 8])
@pytest.mark.parametrize("sup", [1024, 4096])
def test_plain_path_matches_jax_kernel(matrix, sup, tb, leveled):
    A, x = matrix
    hp = tplan.build(A, split_rows=128, step_groups=8, sup=sup, t_base=tb,
                     permute_rows=leveled)
    assert (hp.lam is not None) == leveled
    y_jax = np.asarray(jwe.spmv_window_ell(jax_plan_from_host(hp),
                                           jnp.asarray(x)))
    plan = twe.plan_from_host(hp, "cpu")
    y = twe.spmv_window_ell(plan, torch.from_numpy(x)).numpy()
    assert y.shape == (A.num_rows,)
    assert_row_bound(y, y_jax, A, x)
    assert spmv_matches(y, A, x, rel_tol=ROW_TOL)


def test_sections_partition_the_plan(matrix):
    """The fold schedule covers every run that holds a value once, and a
    section's output superblocks are disjoint from every other section's."""
    A, _ = matrix
    hp = tplan.build(A, split_rows=128, step_groups=16, sup=1024,
                     permute_rows=True)
    plan = twe.plan_from_host(hp, "cpu")
    assert len(plan.sections) == 1 + int(hp.fin_step.sum())
    runs = torch.cat([s.run_order for s in plan.sections]).numpy()
    n_runs = int((hp.blk_step >= 0).sum()) * hp.step_groups // hp.tb
    live = np.any(hp.vals.reshape(n_runs, -1) != 0, axis=1)
    assert 0 < live.sum() < n_runs    # the block padding is left out
    assert np.array_equal(np.sort(runs), np.flatnonzero(live))
    bases = [set(hp.base[s.run_order.numpy()].tolist())
             for s in plan.sections]
    assert all(len(b) == s.n_cta for b, s in zip(bases, plan.sections))
    assert sum(len(b) for b in bases) == len(set().union(*bases))


def test_unpermute_plain_matches_jax_bitwise():
    rng = np.random.default_rng(3)
    n_tiles_pad, out8, num_rows = 16, 13, 1500
    y = rng.standard_normal(out8 * 128).astype(np.float32)
    lam = np.stack([rng.permutation(128) for _ in range(n_tiles_pad)]) \
        .astype(np.int32)
    ref = np.asarray(jwe._unpermute_tiles(
        jnp.asarray(y.reshape(out8, 128)), jnp.asarray(lam), num_rows))
    got = twe.unpermute(torch.from_numpy(y), torch.from_numpy(lam),
                        num_rows).numpy()
    assert got.dtype == ref.dtype and np.array_equal(got, ref)


def test_plan_from_jax_plan_gives_same_output(matrix, absorb_helper):
    A, x = matrix
    kw = dict(split_rows=128, step_groups=8, permute_rows=True)
    jp = jwe.WindowEllPlan.build(A, **kw)
    leaves = {k: None if getattr(jp, k) is None
              else np.asarray(getattr(jp, k)) for k in tplan.LEAVES}
    aux = {k: getattr(jp, k) for k in tplan.AUX}
    from_jax = twe.plan_from_arrays(leaves, aux, "cpu")
    from_port = twe.plan_from_host(tplan.build(A, **kw), "cpu")
    xt = torch.from_numpy(x)
    assert torch.equal(twe.spmv_window_ell(from_jax, xt),
                       twe.spmv_window_ell(from_port, xt))
    assert from_jax.stream_bytes == jp.stream_bytes


def test_fold_refuses_bf16_and_pattern_plans(matrix):
    """bf16 and pattern plans now have routes: the fold serves both, held
    against the oracle (bf16 at the value-rounding bound 8e-3, the pattern
    plan against the 0/1 matrix at 1e-5), and refuses only a plan whose
    value stream it has no variant for."""
    A, x = matrix
    xt = torch.from_numpy(x)
    plan = twe.plan_from_host(tplan.build(A, split_rows=128, step_groups=8),
                              "cpu")
    bf16 = dataclasses.replace(plan, vals=plan.vals.to(torch.bfloat16))
    assert bf16.values == "bfloat16"
    assert spmv_matches(twe.spmv_window_ell(bf16, xt).numpy(), A, x,
                        rel_tol=8e-3)
    pattern = twe.plan_from_host(tplan.build(A, split_rows=128,
                                             step_groups=8, pattern=True),
                                 "cpu")
    assert pattern.vals is None and pattern.values == "pattern"
    ones = type(A)(A.num_rows, A.num_cols, np.ones(A.nnz, np.float32),
                   A.col_indices, A.row_ptrs)
    assert spmv_matches(twe.spmv_window_ell(pattern, xt).numpy(), ones, x,
                        rel_tol=ROW_TOL)
    table = twe.gather_table(plan, xt)
    f16 = dataclasses.replace(plan, vals=plan.vals.half())
    with pytest.raises(ValueError, match="float32 and bfloat16"):
        twe.window_ell_fold(f16, table)


def test_plan_from_arrays_rejects_out_of_range_indices(matrix):
    A, _ = matrix
    hp = tplan.build(A, split_rows=128, step_groups=8, permute_rows=True)
    bad_lam = hp.lam.copy()
    bad_lam[0, 0] = 128
    with pytest.raises(tplan.InvalidFormatError):
        twe.plan_from_arrays({**hp.leaves(), "lam": bad_lam}, hp.aux(),
                             "cpu")
    bad_wg = hp.wg.copy()
    bad_wg[0] = 1 << 20
    with pytest.raises(tplan.InvalidFormatError):
        twe.plan_from_arrays({**hp.leaves(), "wg": bad_wg}, hp.aux(),
                             "cpu")


def test_launch_counts_do_not_move_on_cpu(matrix):
    A, x = matrix
    plan = twe.plan_from_host(tplan.build(A, split_rows=128, step_groups=8,
                                          permute_rows=True), "cpu")
    tk.reset_launch_counts()
    twe.spmv_window_ell(plan, torch.from_numpy(x))
    assert tk.launch_counts() == {
        "window_ell_fold": 0, "window_ell_fold_bf16": 0,
        "window_ell_fold_pattern": 0, "unpermute": 0, "permute_chunks": 0}
    assert sum(twe.window_ell_fold.launches.values()) == 0
