"""The port's device benchmarks (``tpu_spmv_torch/benchmarks/``) against
the JAX repo's scripts (``benchmarks/``), on the CPU at small sizes.

Generators, plans, shards and the selector's choice must equal the JAX
package's: ``perf_properties``'s matrices, ``mtx_bench``'s R-MAT graph and
a Matrix Market file read back by both packages, one ``model_grid`` case,
``fallback_bench``'s composite, naive and strip plans, ``scaling``'s shard
imbalance and ring traffic on a 2-shard mesh.  Each module's functions
also run on the CPU (the kernels' plain versions) and report ``correct``.
The JAX planner's missing helper (F0) is bound into its module for the
JAX builds, and its default step widths are those it takes for a compiled
kernel, the port's.
"""

import importlib.util
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import tpu_spmv.kernels.strips as jst  # noqa: E402
import tpu_spmv.kernels.window_ell as jwe  # noqa: E402
import tpu_spmv.parallel as jpar  # noqa: E402
from tpu_spmv.csr import CSRMatrix as JaxCSRMatrix  # noqa: E402
from tpu_spmv.io import matrix_market as jmm  # noqa: E402
from tpu_spmv.utils.testing import \
    RandomGenerator as JaxRandomGenerator  # noqa: E402

from tpu_spmv_torch import benchmarks  # noqa: E402
from tpu_spmv_torch.bench import BenchFailure, Clock  # noqa: E402
from tpu_spmv_torch.benchmarks import ab_device  # noqa: E402
from tpu_spmv_torch.benchmarks import ab_device_wide  # noqa: E402
from tpu_spmv_torch.benchmarks import ab_pattern  # noqa: E402
from tpu_spmv_torch.benchmarks import ab_reorder  # noqa: E402
from tpu_spmv_torch.benchmarks import ab_tbase  # noqa: E402
from tpu_spmv_torch.benchmarks import fallback_bench as fb  # noqa: E402
from tpu_spmv_torch.benchmarks import model_grid as mg  # noqa: E402
from tpu_spmv_torch.benchmarks import mtx_bench as mb  # noqa: E402
from tpu_spmv_torch.benchmarks import perf_properties as pp  # noqa: E402
from tpu_spmv_torch.benchmarks import ring_build  # noqa: E402
from tpu_spmv_torch.benchmarks import scaling as sc  # noqa: E402
from tpu_spmv_torch.benchmarks import tune  # noqa: E402
from tpu_spmv_torch.errors import DeviceAllocError  # noqa: E402
from tpu_spmv_torch.io import (load_matrix_market,  # noqa: E402
                               save_matrix_market)
from tpu_spmv_torch.kernels import plan as tplan  # noqa: E402
from tpu_spmv_torch.parallel import make_row_mesh  # noqa: E402
from tpu_spmv_torch.utils.testing import (RandomGenerator,  # noqa: E402
                                          scrambled_banded_csr,
                                          web_graph_csr)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = Clock(torch.device("cpu"), None)
FEW = 2                 # timed calls a sample on the CPU


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """These flows run many small torch ops on the CPU: one intra-op thread
    keeps them from waiting on each other where test workers share the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def jax_planner_as_on_the_card(monkeypatch):
    """F0's helper bound into the JAX module, and the JAX planner's default
    step widths those of a compiled kernel (``window_ell.py:538-551``), as
    the port's are; no test here runs a JAX kernel."""
    monkeypatch.setattr(jwe, "_absorb_run_padding",
                        tplan._absorb_run_padding, raising=False)
    monkeypatch.setattr(jwe, "_use_interpret", lambda: False)


def jax_script(name):
    """``benchmarks/<name>.py`` of the JAX repo, imported from its file."""
    spec = importlib.util.spec_from_file_location(
        f"jax_bench_{name}", os.path.join(REPO, "benchmarks", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def to_jax(A):
    return JaxCSRMatrix(A.num_rows, A.num_cols, A.values, A.col_indices,
                        A.row_ptrs)


def assert_csr_equal(a, b):
    assert (a.num_rows, a.num_cols, a.nnz) == (b.num_rows, b.num_cols, b.nnz)
    for name in ("row_ptrs", "col_indices", "values"):
        x, y = np.asarray(getattr(a, name)), np.asarray(getattr(b, name))
        assert np.array_equal(x.astype(np.int64) if name != "values" else x,
                              y.astype(np.int64) if name != "values" else y
                              ), name


def assert_plan_equal(jp, hp):
    """A JAX plan against a port host plan, leaf for leaf."""
    for name in tplan.LEAVES:
        a, b = getattr(jp, name), getattr(hp, name)
        assert (a is None) == (b is None), name
        if a is not None:
            a = np.asarray(a)
            assert a.dtype == b.dtype and np.array_equal(a, b), name
    for name in tplan.AUX:
        assert getattr(jp, name) == getattr(hp, name), name
    assert jp.occupancy == hp.occupancy


# ---- perf_properties ----

def test_property_generators_equal_jax():
    jmod = jax_script("perf_properties")
    for fn in ("_uniform_csr", "_varying_csr"):
        A = getattr(pp, fn)(RandomGenerator(42), 2048, 1024, 16)
        B = getattr(jmod, fn)(JaxRandomGenerator(42), 2048, 1024, 16)
        assert_csr_equal(A, B)


def test_properties_run_on_cpu_and_fail_on_a_wrong_plan(monkeypatch):
    rng = RandomGenerator(42)
    uni = pp._uniform_csr(rng, 2048, 1024, 16)
    var = pp._varying_csr(rng, 2048, 1024, 16)
    vec = pp.vector_csr_property(uni, var, rng, CPU, iters=FEW)
    skew = rng.power_law_csr(2048, 1024, avg_nnz=16.0, alpha=1.2)
    mp = pp.merge_path_property(skew, uni, rng, CPU, iters=FEW)
    assert vec["vector_csr_varying_over_uniform"] > 0
    assert mp["merge_path_skew_over_uniform"] > 0
    monkeypatch.setattr(benchmarks, "spmv_matches", lambda *a, **k: False)
    with pytest.raises(BenchFailure, match="failed the oracle"):
        pp.vector_csr_property(uni, var, rng, CPU, iters=FEW)


# ---- mtx_bench ----

def test_rmat_equals_jax_and_files_read_back_in_both_packages(tmp_path):
    jmod = jax_script("mtx_bench")
    A = mb.rmat_csr(RandomGenerator(42).rng, scale=10, avg_nnz=8)
    assert_csr_equal(A, jmod.rmat_csr(JaxRandomGenerator(42).rng, scale=10,
                                      avg_nnz=8))
    path = str(tmp_path / "m.mtx")
    m, same, _, _ = mb.round_trip(A, path)
    assert same
    assert_csr_equal(m, jmm.load_matrix_market(path))
    jpath = str(tmp_path / "j.mtx")
    jmm.save_matrix_market(to_jax(A), jpath)
    assert_csr_equal(load_matrix_market(jpath), A)
    save_matrix_market(A, path)
    assert_csr_equal(jmm.load_matrix_market(path), A)


def test_mtx_serve_on_cpu():
    rng = RandomGenerator(42)
    A = mb.rmat_csr(rng.rng, scale=10, avg_nnz=8)
    rec = mb.serve(A, rng.vector(A.num_cols), CPU)
    assert rec["correct"] and rec["t_ms"] > 0


# ---- model_grid ----

def test_model_grid_case_equals_jax():
    """One grid case: the selector's pick and each height's full-build
    groups, against the JAX script's ``ground_truth`` and ``_choose_sup``."""
    jmod = jax_script("model_grid")
    A = RandomGenerator(42).power_law_csr(8192, 4096, avg_nnz=8.0,
                                          alpha=1.5)
    row = mg.grid_row("power_law", A, 128)
    assert row["model_pick"] == jwe._choose_sup(to_jax(A), split_rows=128)
    truth = jmod.ground_truth(to_jax(A), 128)
    assert {str(s): None if v is None else v["groups"]
            for s, v in truth.items()} \
        == {s: None if v is None else v["groups"]
            for s, v in row["truth"].items()}
    assert row["within_10pct"]


# ---- fallback_bench ----

def test_fallback_plans_equal_jax():
    """The composite and naive plans on a matrix of the headline's law, and
    the strips of a matrix past ``PACKED_MAX_COLS`` (4M columns, 256 rows),
    against the JAX planner's, leaf for leaf."""
    rng = RandomGenerator(42)
    A = rng.power_law_csr(4096, 1024, avg_nnz=10.0, alpha=1.6)
    hc = fb.composite_plan(A)
    jcp = jwe.build_composite(to_jax(A), split_rows=128)
    assert len(hc.plans) == len(jcp.plans) >= 1
    assert (hc.tail is None) == (jcp.tail is None)
    for jp, hp in zip(jcp.plans, hc.plans):
        assert_plan_equal(jp, hp)
    assert_plan_equal(jwe.WindowEllPlan.build(
        to_jax(A), split_rows=None, spill_beta=0.0, cap_margin=1e9),
        fb.naive_plan(A))
    W = fb.wide_csr(rng, 256, 1 << 22, 8)
    hs = fb.build_strips_host(W)
    _, jsp = jst.build_strips(to_jax(W))
    assert len(hs.plans) == len(jsp.plans) == 4
    assert tuple(hs.bounds) == tuple(jsp.bounds)
    for jp, hp in zip(jsp.plans, hs.plans):
        assert_plan_equal(jp, hp)


def test_fallback_rows_on_cpu():
    rng = RandomGenerator(42)
    A = rng.power_law_csr(4096, 1024, avg_nnz=10.0, alpha=1.6)
    x = rng.vector(1024)
    assert fb.composite_headline(A, x, CPU, iters=FEW)["correct"]
    assert fb.naive_scalar(A, x, CPU, iters=FEW)["correct"]
    E = fb.wide_ell(rng, 256, 1 << 21, 4)
    row = fb.ell_wide(E, rng.vector(1 << 21), CPU, iters=FEW)
    assert row["correct"] and row["error_code"] == 0
    assert fb.flat(A, x, CPU, 1.0)["correct"]


# ---- scaling ----

def test_scaling_two_cpu_shards_equal_jax():
    """``scaling``'s rows on 1- and 2-shard CPU meshes at 4,096 rows: every
    check true, no wall efficiency on a CPU mesh, and the shards' imbalance
    and the ring's byte model equal the JAX package's on the conftest's CPU
    devices."""
    rng = RandomGenerator(42)
    A = rng.power_law_csr(4096, 4096, avg_nnz=16.0, alpha=1.6)
    x = rng.vector(4096)
    rows = sc.sweep(A, x, [1, 2],
                    lambda d: make_row_mesh(d, devices=["cpu"] * d), rng,
                    CPU, iters=FEW)
    assert [r["devices"] for r in rows] == [1, 2]
    for r in rows:
        assert r["route"] == "packed"
        assert all(r[k] is True for k in r if k.endswith("correct"))
        assert r["efficiency_wall"] is None
        jm = jpar.make_row_mesh(r["devices"])
        jA = to_jax(A)
        assert r["nnz_imbalance"] \
            == jpar.shard_csr_packed(jA, jm).nnz_imbalance
        assert r["ring_traffic"] \
            == jpar.ring_traffic_report(jpar.shard_csr_ring(jA, jm))
    assert rows[1]["nnz_imbalance"] > 0


def test_scaling_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(DeviceAllocError):
        sc.main([])


# ---- tune ----

def test_tune_rows_on_cpu(capsys):
    rng = RandomGenerator(42)
    A = rng.power_law_csr(2048, 1024, avg_nnz=12.0, alpha=1.6)
    rows = tune.sweep_matrix("powerlaw", A, rng.vector(1024), CPU,
                             iters=FEW, splits=(None, 128),
                             margins=(0.15, 0.5))
    assert len(rows) == 4 and all(r["correct"] for r in rows)
    assert len(capsys.readouterr().out.splitlines()) == 4


# ---- the A/B scripts and ring_build ----

def timed_rows(rows):
    timed = [r for r in rows if "t_us" in r or "t_ms" in r]
    assert timed and all(r["correct"] for r in timed)
    return timed


def test_headline_ab_scripts_on_cpu():
    """The lever, run-length and pattern A/Bs on a small matrix of the
    headline's law; every setting is either timed and correct or reported
    as a duplicate or a no-op of its lever."""
    rng = RandomGenerator(42)
    A = rng.power_law_csr(4096, 1024, avg_nnz=12.0, alpha=1.6)
    x = rng.vector(1024)
    rows = ab_device.ab(A, x, CPU, iters=FEW)
    assert [r["label"] for r in rows] == [c[0] for c in ab_device.CONFIGS]
    timed_rows(rows)
    rows = ab_tbase.ab(A, x, CPU, iters=FEW)
    assert len(rows) == len(ab_tbase.CONFIGS)
    timed_rows(rows)
    assert len(timed_rows(ab_pattern.plans_leg(A, x, CPU, iters=FEW))) == 3
    pr = ab_pattern.pagerank_leg(ab_pattern.random_transition(4096),
                                 torch.device("cpu"))
    assert [r["plan"] for r in pr] == ["WindowEllPlan", "PatternPlan"]
    assert all(r["correct"] and r["converged"] for r in pr)


def test_reorder_and_wide_ab_on_cpu():
    rng = RandomGenerator(42)
    row = ab_reorder.permute_row(rng.vector(10000), CPU, iters=FEW)
    assert row["t_us"] > 0
    B = scrambled_banded_csr(rng, 16384, bandwidth=512, avg_nnz=8.0)
    rows = ab_reorder.reorder_case("banded", B, rng.vector(B.num_cols), CPU,
                                   iters=FEW)
    assert len(timed_rows(rows)) == 2 and rows[0]["probe"]
    W = web_graph_csr(rng, 8192, 8192, avg_nnz=15)
    rows = ab_device_wide.ab(W, rng.vector(8192), CPU, iters=FEW)
    assert len(timed_rows(rows)) == len(ab_device_wide.CONFIGS)


def test_ring_build_on_cpu(capsys):
    assert ring_build.main(["--rows", "4096", "--sizes", "2", "4",
                            "--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["device"] == "cpu"
    assert [r["n"] for r in out["rows"]] == [2, 4]
    assert all(r["correct"] and r["tensor_bytes"] > 0 for r in out["rows"])
