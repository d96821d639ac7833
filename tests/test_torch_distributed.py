"""The port's row-sharded multi-device layer against the JAX package's
(``tpu_spmv/parallel/distributed.py``), case for case with
``tests/test_distributed.py``.

The port's meshes here are local meshes of CPU devices (``["cpu"] * n``: n
shards in one process, each running the kernels' plain versions); the JAX
side runs on the 8 CPU devices ``tests/conftest.py`` forces, its packed
kernel in Pallas interpret mode.  Held equal or close, per case:

* the row bounds and per-shard nnz, exactly;
* the sharded outputs against the JAX package's, flat ones by
  ``spmv_rel_equal`` at 1e-5, those of the packed, leveled, pattern, bf16
  and ring plans by the fold's row bound ``|y - y_jax|_i <= 1e-5 *
  max((|A||x|)_i, 1)`` (two folds sum a row in different orders), and all
  against the CPU oracle on the unpartitioned matrix (F2; bf16 at 8e-3);
* each shard's plan, leaf for leaf, against the JAX planner's plan of the
  same sub-matrix at the port's superblock height;
* the port's one superblock height, chosen with the row split (F1);
* the ring's packed layout (``pack_idx``, ``col_bounds``, ``pack_len``), its
  traffic report, its output, the mesh cap and its override;
* ``pagerank_sharded``'s ranks and iteration counts;
* the process-group collectives, in two gloo ranks, bit for bit against a
  local mesh of two shards.

Both planners run at step width 8 (``step_groups``), which JAX interpret
mode runs far faster than the default 256; the JAX planner's missing
``_absorb_run_padding`` (F0) is bound from the port for each test.
"""

import functools
import socket
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import tpu_spmv.kernels.window_ell as jwe  # noqa: E402
import tpu_spmv.parallel as jpar  # noqa: E402
from tpu_spmv import PageRankConfig as JaxPageRankConfig  # noqa: E402
from tpu_spmv.csr import CSRMatrix as JaxCSRMatrix  # noqa: E402

from tpu_spmv_torch import (PageRankConfig, csr_from_dense,  # noqa: E402
                            pagerank)
from tpu_spmv_torch.errors import (DeviceAllocError,  # noqa: E402
                                   InvalidArgumentError, InvalidFormatError,
                                   SpMVError)
from tpu_spmv_torch.kernels import plan as tplan  # noqa: E402
from tpu_spmv_torch.pagerank import find_dangling_mask  # noqa: E402
from tpu_spmv_torch.parallel import (init_distributed,  # noqa: E402
                                     make_row_mesh, pagerank_sharded,
                                     pagerank_step_sharded,
                                     ring_traffic_report, shard_csr,
                                     shard_csr_packed, shard_csr_ring,
                                     spmv_csr_ring, spmv_csr_sharded,
                                     spmv_csr_sharded_packed)
from tpu_spmv_torch.parallel import distributed as tdist  # noqa: E402
from tpu_spmv_torch.utils.testing import (RandomGenerator,  # noqa: E402
                                          abs_row_scale, spmv_matches,
                                          spmv_rel_equal)

FOLD_TOL = 1e-5
BF16_TOL = 8e-3
STEP = 8
GLOO_TIMEOUT = 120.0
# the planners at their default step width (the F1 case)
JAX_BUILD = jwe.WindowEllPlan.build


@pytest.fixture(autouse=True)
def both_planners(monkeypatch):
    """F0's helper bound into the JAX module, and both planners at step
    width 8."""
    monkeypatch.setattr(jwe, "_absorb_run_padding",
                        tplan._absorb_run_padding, raising=False)
    monkeypatch.setattr(tdist, "build",
                        functools.partial(tplan.build, step_groups=STEP))
    monkeypatch.setattr(jwe.WindowEllPlan, "build", staticmethod(
        functools.partial(JAX_BUILD, step_groups=STEP)))


def cpu_mesh(n):
    return make_row_mesh(n, devices=["cpu"] * n)


def jmesh(n):
    return jpar.make_row_mesh(n)


def to_jax(A):
    return JaxCSRMatrix(A.num_rows, A.num_cols, A.values, A.col_indices,
                        A.row_ptrs)


def host(t):
    return t.cpu().numpy()


def leaf(v):
    """A plan leaf as NumPy, bf16 as its bits."""
    if isinstance(v, torch.Tensor):
        if v.dtype == torch.bfloat16:
            return v.view(torch.int16).numpy().view(np.uint16)
        return v.numpy()
    a = np.asarray(v)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def assert_plan_equals_jax(p, jp):
    for name in tplan.LEAVES:
        a, b = getattr(p, name), getattr(jp, name)
        assert (a is None) == (b is None), name
        if a is not None:
            la, lb = leaf(a), leaf(b)
            assert la.dtype == lb.dtype and np.array_equal(la, lb), name
    for name in tplan.AUX:
        assert getattr(p, name) == getattr(jp, name), name


def rows_close(y, y_ref, A, x, tol=FOLD_TOL):
    """The fold's tolerance: ``|y - y_ref|_i <= tol * max((|A||x|)_i, 1)``
    (two folds sum each row in different orders)."""
    return bool(np.all(np.abs(y - y_ref)
                       <= tol * np.maximum(abs_row_scale(A, x), 1.0)))


def assert_shards_equal_jax(sp, A, **kw):
    """Each port shard plan against the JAX planner's plan of the same
    padded row block at the port's superblock height."""
    for d, p in enumerate(sp.plans):
        sub = tplan._slice_rows(A, sp.bounds[d], sp.bounds[d + 1],
                                pad_to=sp.rows_per_shard)
        jp = jwe.WindowEllPlan.build(to_jax(sub), split_rows=128,
                                     sup=sp.sup, **kw)
        assert_plan_equals_jax(p, jp)


def transition(rng_np, n, m):
    """A column-normalised random graph without self loops
    (``tests/test_distributed.py``'s ``_transition``)."""
    from tpu_spmv_torch import CSRMatrix

    rows = rng_np.integers(0, n, m)
    cols = rng_np.integers(0, n, m)
    keep = rows != cols
    rows, cols = rows[keep], cols[keep]
    outdeg = np.bincount(cols, minlength=n)
    vals = (1.0 / np.maximum(outdeg, 1)[cols]).astype(np.float32)
    order = np.lexsort((cols, rows))
    ptr = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(rows, minlength=n), out=ptr[1:])
    return CSRMatrix(n, n, vals[order], cols[order].astype(np.int32),
                     ptr.astype(np.int32))


def column_normalised(rng, n, p):
    adj = (rng.rng.random((n, n)) < p).astype(np.float32)
    np.fill_diagonal(adj, 0.0)
    cs = adj.sum(axis=0)
    adj[:, cs > 0] /= cs[cs > 0]
    return adj


class TestShardedSpMV:
    def test_matches_oracle(self):
        rng = RandomGenerator(42)
        mesh, jm = cpu_mesh(8), jmesh(8)
        for _ in range(10):
            rows = rng.uniform_int(8, 200)
            cols = rng.uniform_int(1, 200)
            A = csr_from_dense(rng.dense_matrix(rows, cols, 0.2))
            x = rng.vector(cols)
            sh = shard_csr(A, mesh)
            jsh = jpar.shard_csr(to_jax(A), jm)
            assert sh.bounds == jsh.bounds and sh.shard_nnz == jsh.shard_nnz
            y = host(spmv_csr_sharded(sh, x, mesh))
            assert spmv_matches(y, A, x)
            jy = np.asarray(jpar.spmv_csr_sharded(jsh, x, jm))
            assert spmv_rel_equal(y, jy, FOLD_TOL)

    def test_skewed_matrix(self):
        rng = RandomGenerator(42)
        A = rng.power_law_csr(150, 150, avg_nnz=5.0)
        x = rng.vector(150)
        y = host(spmv_csr_sharded(shard_csr(A, cpu_mesh(8)), x))
        assert spmv_matches(y, A, x, rel_tol=1e-5)
        jy = np.asarray(jpar.spmv_csr_sharded(
            jpar.shard_csr(to_jax(A), jmesh(8)), x))
        assert spmv_rel_equal(y, jy, FOLD_TOL)

    def test_single_device_mesh(self):
        rng = RandomGenerator(42)
        A = csr_from_dense(rng.dense_matrix(30, 30, 0.3))
        x = rng.vector(30)
        mesh = cpu_mesh(1)
        sh = shard_csr(A, mesh)
        assert sh.n_shards == 1 and sh.bounds == (0, 30)
        assert spmv_matches(host(spmv_csr_sharded(sh, x, mesh)), A, x)

    def test_row_count_not_divisible(self):
        rng = RandomGenerator(42)
        rows = 8 * 13 + 5
        A = csr_from_dense(rng.dense_matrix(rows, 64, 0.15))
        x = rng.vector(64)
        sh = shard_csr(A, cpu_mesh(8))
        jsh = jpar.shard_csr(to_jax(A), jmesh(8))
        assert sh.bounds == jsh.bounds and sh.shard_nnz == jsh.shard_nnz
        assert spmv_matches(host(spmv_csr_sharded(sh, x)), A, x)


class TestShardedPageRankStep:
    def test_step_matches_dense(self):
        rng = RandomGenerator(42)
        n = 64
        dense = column_normalised(rng, n, 0.2)
        A = csr_from_dense(dense)
        mask = find_dangling_mask(A)
        r = np.full(n, 1.0 / n, np.float32)
        mesh = cpu_mesh(8)
        out = host(pagerank_step_sharded(shard_csr(A, mesh), r, mask,
                                         damping=0.85, mesh=mesh))
        expected = 0.85 * (dense @ r) + 0.85 * float(mask @ r) / n \
            + 0.15 / n
        assert spmv_rel_equal(out, expected.astype(np.float32), 1e-5)
        jm = jmesh(8)
        jout = np.asarray(jpar.pagerank_step_sharded(
            jpar.shard_csr(to_jax(A), jm), r, mask, damping=0.85, mesh=jm))
        assert spmv_rel_equal(out, jout, FOLD_TOL)


class TestDistributedPageRank:
    def test_matches_single_device_pagerank(self):
        rng = RandomGenerator(42)
        A = csr_from_dense(column_normalised(rng, 96, 0.15))
        mask = find_dangling_mask(A)
        mesh = cpu_mesh(4)
        dist = pagerank_sharded(shard_csr(A, mesh), mask, PageRankConfig(),
                                mesh)
        single = pagerank(A, PageRankConfig(), device="cpu")
        assert dist.converged
        np.testing.assert_allclose(dist.ranks_host(), single.ranks_host(),
                                   rtol=1e-4, atol=1e-7)
        jm = jmesh(4)
        jdist = jpar.pagerank_sharded(jpar.shard_csr(to_jax(A), jm), mask,
                                      JaxPageRankConfig(), jm)
        assert dist.iterations == jdist.iterations
        np.testing.assert_allclose(dist.ranks_host(), jdist.ranks_host(),
                                   rtol=1e-4, atol=1e-7)

    def test_edge_cases(self):
        mesh = cpu_mesh(2)
        rect = csr_from_dense(np.ones((4, 6), np.float32))
        res = pagerank_sharded(shard_csr(rect, mesh), np.zeros(6))
        assert res.error_code == int(SpMVError.INVALID_DIMENSION)
        assert np.isnan(res.final_residual)
        empty = csr_from_dense(np.zeros((0, 0), np.float32))
        res = pagerank_sharded(shard_csr(empty, mesh), np.zeros(0))
        assert res.error_code == 0 and res.ranks_host().shape == (0,)


class TestPackedSharding:
    def test_packed_matches_oracle(self):
        rng = RandomGenerator(42)
        A = rng.power_law_csr(2048, 1500, avg_nnz=9, alpha=1.6)
        x = rng.vector(1500)
        mesh, jm = cpu_mesh(4), jmesh(4)
        sp = shard_csr_packed(A, mesh)
        y = host(spmv_csr_sharded_packed(sp, x, mesh))
        assert spmv_matches(y, A, x, rel_tol=1e-5)
        jsp = jpar.shard_csr_packed(to_jax(A), jm)
        assert sp.bounds == jsp.bounds and sp.sup == jsp.plan_aux[9]
        assert rows_close(
            y, np.asarray(jpar.spmv_csr_sharded_packed(jsp, x, jm)), A, x)
        assert_shards_equal_jax(sp, A)

    def test_pagerank_sharded_packed(self):
        rng = RandomGenerator(42)
        A = csr_from_dense(column_normalised(rng, 96, 0.15))
        mask = find_dangling_mask(A)
        mesh, jm = cpu_mesh(4), jmesh(4)
        dist = pagerank_sharded(shard_csr_packed(A, mesh), mask,
                                PageRankConfig(), mesh)
        single = pagerank(A, PageRankConfig(), device="cpu")
        assert dist.converged
        np.testing.assert_allclose(dist.ranks_host(), single.ranks_host(),
                                   rtol=1e-4, atol=1e-7)
        jdist = jpar.pagerank_sharded(jpar.shard_csr_packed(to_jax(A), jm),
                                      mask, JaxPageRankConfig(), jm)
        assert dist.iterations == jdist.iterations
        np.testing.assert_allclose(dist.ranks_host(), jdist.ranks_host(),
                                   rtol=1e-4, atol=1e-7)


class TestBalancedSharding:
    def test_power_law_imbalance_under_10_percent(self):
        rng = RandomGenerator(42)
        A = rng.power_law_csr(4096, 512, avg_nnz=16, alpha=1.6)
        mesh = cpu_mesh(4)
        sh = shard_csr(A, mesh)
        assert sh.nnz_imbalance < 0.10
        jsh = jpar.shard_csr(to_jax(A), jmesh(4))
        assert sh.bounds == jsh.bounds and sh.shard_nnz == jsh.shard_nnz
        assert sh.nnz_imbalance == jsh.nnz_imbalance
        x = rng.vector(512)
        assert spmv_matches(host(spmv_csr_sharded(sh, x, mesh)), A, x,
                            rel_tol=1e-5)

    def test_packed_sharding_balanced_and_correct(self):
        rng = RandomGenerator(42)
        A = rng.power_law_csr(8192, 1024, avg_nnz=12, alpha=1.6)
        mesh = cpu_mesh(4)
        sp = shard_csr_packed(A, mesh)
        assert sp.nnz_imbalance < 0.10
        x = rng.vector(1024)
        assert spmv_matches(host(spmv_csr_sharded_packed(sp, x, mesh)), A,
                            x, rel_tol=1e-5)

    def test_init_distributed_single_process_noop(self, monkeypatch):
        for name in ("JAX_COORDINATOR_ADDRESS", "COORDINATOR_ADDRESS",
                     "MASTER_ADDR"):
            monkeypatch.delenv(name, raising=False)
        init_distributed()  # must not raise or try to reach a coordinator
        assert not torch.distributed.is_initialized()


class TestRingSharded:
    def test_ring_matches_oracle(self):
        rng = RandomGenerator(42)
        mesh = cpu_mesh(8)
        for _ in range(4):
            rows = rng.uniform_int(16, 300)
            cols = rng.uniform_int(8, 300)
            A = csr_from_dense(rng.dense_matrix(rows, cols, 0.15))
            x = rng.vector(cols)
            rs = shard_csr_ring(A, mesh)
            assert spmv_matches(host(spmv_csr_ring(rs, x, mesh)), A, x,
                                rel_tol=1e-5)

    def test_ring_power_law(self):
        rng = RandomGenerator(42)
        A = rng.power_law_csr(400, 400, avg_nnz=6.0)
        x = rng.vector(400)
        mesh, jm = cpu_mesh(8), jmesh(8)
        rs = shard_csr_ring(A, mesh)
        y = host(spmv_csr_ring(rs, x, mesh))
        assert spmv_matches(y, A, x, rel_tol=1e-5)
        jrs = jpar.shard_csr_ring(to_jax(A), jm)
        assert np.array_equal(
            np.stack([host(p) for p in rs.pack_idx]),
            np.asarray(jrs.pack_idx))
        assert (rs.col_bounds, rs.pack_len, rs.u_max, rs.bounds) \
            == (jrs.col_bounds, jrs.pack_len, jrs.u_max, jrs.bounds)
        assert ring_traffic_report(rs) == jpar.ring_traffic_report(jrs)
        assert rows_close(y, np.asarray(jpar.spmv_csr_ring(jrs, x, jm)),
                          A, x)

    def test_ring_banded_compresses(self):
        rng = RandomGenerator(42)
        n = 2048
        m = np.zeros((n, n), np.float32)
        for off in (-2, -1, 0, 1, 2):
            idx = np.arange(max(0, -off), min(n, n - off))
            m[idx, idx + off] = rng.uniform(0.5, 2.0)
        A = csr_from_dense(m)
        mesh = cpu_mesh(8)
        rs = shard_csr_ring(A, mesh)
        x = rng.vector(n)
        assert spmv_matches(host(spmv_csr_ring(rs, x, mesh)), A, x,
                            rel_tol=1e-5)
        rep = ring_traffic_report(rs)
        assert rep["ring_wins"]
        # a 5-point band's halo crosses at most ~4 columns per boundary
        assert rep["compression"] > 5.0
        assert rep == jpar.ring_traffic_report(
            jpar.shard_csr_ring(to_jax(A), jmesh(8)))

    def test_ring_traffic_fields(self):
        A = RandomGenerator(42).power_law_csr(256, 256, avg_nnz=5.0)
        rep = ring_traffic_report(shard_csr_ring(A, cpu_mesh(8)))
        for k in ("replicate_bytes", "ring_bytes",
                  "ideal_pairwise_bytes", "compression", "ring_wins"):
            assert k in rep
        assert rep["ring_bytes"] > 0

    def test_ring_single_device(self):
        rng = RandomGenerator(42)
        A = csr_from_dense(rng.dense_matrix(60, 50, 0.2))
        x = rng.vector(50)
        mesh = cpu_mesh(1)
        rs = shard_csr_ring(A, mesh)
        assert ring_traffic_report(rs)["n_shards"] == 1
        assert spmv_matches(host(spmv_csr_ring(rs, x, mesh)), A, x)


class TestPackedShardingVariants:
    def test_permuted_shards_match_oracle(self):
        rng = RandomGenerator(42)
        A = rng.power_law_csr(2048, 1500, avg_nnz=9, alpha=1.6)
        x = rng.vector(1500)
        mesh, jm = cpu_mesh(4), jmesh(4)
        sp = shard_csr_packed(A, mesh, permute_rows=True)
        assert sp.has_lam
        y = host(spmv_csr_sharded_packed(sp, x, mesh))
        assert spmv_matches(y, A, x, rel_tol=1e-5)
        jsp = jpar.shard_csr_packed(to_jax(A), jm, permute_rows=True)
        assert rows_close(
            y, np.asarray(jpar.spmv_csr_sharded_packed(jsp, x, jm)), A, x)
        assert_shards_equal_jax(sp, A, permute_rows=True)

    def test_pattern_shards_match_oracle(self):
        A = transition(np.random.default_rng(5), 2048, 14000)
        x = RandomGenerator(42).vector(2048)
        mesh, jm = cpu_mesh(4), jmesh(4)
        sp = shard_csr_packed(A, mesh, pattern=True)
        assert sp.pat and sp.col_scale is not None
        y = host(spmv_csr_sharded_packed(sp, x, mesh))
        assert spmv_matches(y, A, x, rel_tol=1e-5)
        jsp = jpar.shard_csr_packed(to_jax(A), jm, pattern=True)
        assert rows_close(
            y, np.asarray(jpar.spmv_csr_sharded_packed(jsp, x, jm)), A, x)
        assert_shards_equal_jax(sp, A, pattern=True)

    def test_pattern_rejects_non_factorable(self):
        A = RandomGenerator(42).power_law_csr(512, 512, avg_nnz=6, alpha=1.6)
        with pytest.raises(InvalidFormatError):
            shard_csr_packed(A, cpu_mesh(2), pattern=True)

    def test_pagerank_sharded_pattern(self):
        A = transition(np.random.default_rng(8), 1500, 10000)
        mask = find_dangling_mask(A)
        mesh, jm = cpu_mesh(4), jmesh(4)
        sp = shard_csr_packed(A, mesh, pattern=True, permute_rows=True)
        res_d = pagerank_sharded(sp, mask, mesh=mesh)
        res_s = pagerank(A, device="cpu")
        assert res_d.converged
        assert res_d.iterations == res_s.iterations
        assert np.abs(res_d.ranks_host() - res_s.ranks_host()).max() < 1e-6
        jres = jpar.pagerank_sharded(
            jpar.shard_csr_packed(to_jax(A), jm, pattern=True,
                                  permute_rows=True), mask, mesh=jm)
        assert res_d.iterations == jres.iterations
        assert np.abs(res_d.ranks_host() - jres.ranks_host()).max() < 1e-6

    def test_bf16_shards_match_jax(self):
        rng = RandomGenerator(42)
        A = rng.power_law_csr(2048, 1500, avg_nnz=9, alpha=1.6)
        x = rng.vector(1500)
        mesh, jm = cpu_mesh(4), jmesh(4)
        sp = shard_csr_packed(A, mesh, values_dtype="bfloat16")
        y = host(spmv_csr_sharded_packed(sp, x, mesh))
        assert spmv_matches(y, A, x, rel_tol=BF16_TOL)
        import jax.numpy as jnp

        jsp = jpar.shard_csr_packed(to_jax(A), jm, values_dtype=jnp.bfloat16)
        assert rows_close(
            y, np.asarray(jpar.spmv_csr_sharded_packed(jsp, x, jm)), A, x)
        assert_shards_equal_jax(sp, A, values_dtype=jnp.bfloat16)

    def test_shard_sup_takes_the_split_f1(self, monkeypatch):
        """F1: JAX's ``shard_csr_packed`` chooses the superblock without
        the row split it builds with (``distributed.py:504``).  On this
        matrix the choice differs: the port's shards take the height a
        single-device build at ``split_rows=128`` takes.  Both planners
        choose at their card step widths (JAX's as off interpret mode,
        where it would resolve 8)."""
        A = RandomGenerator(42).power_law_csr(16384, 8192, avg_nnz=13,
                                              alpha=1.2)
        monkeypatch.setattr(jwe.WindowEllPlan, "build", JAX_BUILD)
        monkeypatch.setattr(jwe, "_use_interpret", lambda: False)
        monkeypatch.setattr(tdist, "build", tplan.build)
        single = tplan.build(A, split_rows=128)
        assert jwe._choose_sup(to_jax(A), split_rows=128) == single.sup
        assert jwe._choose_sup(to_jax(A)) != single.sup
        sp = shard_csr_packed(A, cpu_mesh(2))
        assert sp.sup == single.sup
        assert all(p.sup == single.sup for p in sp.plans)
        x = RandomGenerator(7).vector(A.num_cols)
        assert spmv_matches(host(spmv_csr_sharded_packed(sp, x)), A, x,
                            rel_tol=1e-5)


class TestRingCap:
    def test_ring_mesh_cap_overflows(self, monkeypatch):
        monkeypatch.setenv("TPU_SPMV_RING_MAX", "7")
        A = RandomGenerator(42).power_law_csr(256, 256, avg_nnz=6.0)
        with pytest.raises(tplan.WindowEllOverflow):
            shard_csr_ring(A, cpu_mesh(8))
        with pytest.raises(jwe.WindowEllOverflow):
            jpar.shard_csr_ring(to_jax(A), jmesh(8))

    def test_ring_cap_env_override(self, monkeypatch):
        monkeypatch.setenv("TPU_SPMV_RING_MAX", "8")
        rng = RandomGenerator(42)
        A = rng.power_law_csr(256, 256, avg_nnz=6.0)
        x = rng.vector(256)
        mesh = cpu_mesh(8)
        rs = shard_csr_ring(A, mesh)
        assert spmv_matches(host(spmv_csr_ring(rs, x, mesh)), A, x,
                            rel_tol=1e-5)


class TestRowMesh:
    def test_devices_and_errors(self, monkeypatch):
        mesh = make_row_mesh(2, devices=["cpu"] * 8)
        assert mesh.n_shards == 2 and mesh.local == (0, 1)
        assert mesh.home == torch.device("cpu")
        with pytest.raises(InvalidArgumentError):
            make_row_mesh(9, devices=["cpu"] * 8)
        sh = shard_csr(csr_from_dense(np.eye(4, dtype=np.float32)), mesh)
        with pytest.raises(InvalidArgumentError):
            spmv_csr_sharded(sh, np.ones(4), cpu_mesh(4))
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(DeviceAllocError):
            make_row_mesh()
        with pytest.raises(DeviceAllocError):
            make_row_mesh(2, devices=["cuda:0", "cuda:0"])


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _gloo_rank(rank: int, world: int, port: int) -> None:
    """One rank of the gloo test: every sharded path through the process
    group, held bit for bit to a local mesh of ``world`` CPU shards and to
    the oracle."""
    import torch.distributed as dist

    tdist.build = functools.partial(tplan.build, step_groups=STEP)
    init_distributed(f"127.0.0.1:{port}", world, rank)
    try:
        mesh, local = make_row_mesh(), cpu_mesh(world)
        assert mesh.group is not None and mesh.local == (rank,)
        rng = RandomGenerator(42)
        A = rng.power_law_csr(1024, 700, avg_nnz=8, alpha=1.6)
        x = rng.vector(700)
        for shard, spmv in ((shard_csr, spmv_csr_sharded),
                            (shard_csr_packed, spmv_csr_sharded_packed),
                            (shard_csr_ring, spmv_csr_ring)):
            y = spmv(shard(A, mesh), x)
            assert torch.equal(y, spmv(shard(A, local), x)), shard.__name__
            assert spmv_matches(host(y), A, x, rel_tol=1e-5), shard.__name__
        T = transition(np.random.default_rng(5), 512, 3000)
        mask = find_dangling_mask(T)
        res = pagerank_sharded(shard_csr_packed(T, mesh, pattern=True), mask)
        ref = pagerank_sharded(shard_csr_packed(T, local, pattern=True), mask)
        assert res.iterations == ref.iterations
        assert torch.equal(res.ranks, ref.ranks)
    finally:
        dist.destroy_process_group()


def test_process_group_collectives_gloo_two_ranks():
    """The process-group collectives in two gloo ranks (spawned, joined
    within 120 s): each path bit for bit against a local mesh of two
    shards.  No group is left in this process."""
    import torch.multiprocessing as mp

    ctx = mp.start_processes(_gloo_rank, args=(2, _free_port()), nprocs=2,
                             join=False, start_method="spawn")
    deadline = time.monotonic() + GLOO_TIMEOUT
    while not ctx.join(timeout=max(deadline - time.monotonic(), 0.1)):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"the gloo ranks did not finish in {GLOO_TIMEOUT} s")
    assert not torch.distributed.is_initialized()
