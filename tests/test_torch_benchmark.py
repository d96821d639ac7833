"""The port's benchmark harness, autotune, CSR host API, Matrix Market IO and
demo against the JAX package's (``tpu_spmv/benchmark.py``,
``WindowEllPlan.autotune``, ``tpu_spmv/csr.py``,
``tpu_spmv/io/matrix_market.py``, ``tpu_spmv/cli.py``), on the CPU device.

The harness times with the host clock here only because the tests name
the CPU; on the card it times with CUDA events.  The JSON text is held to
the JAX package's field for field, the device key aside (``"gpu"``, as the
CUDA reference writes it, where the JAX package writes ``"tpu"``).
"""

import dataclasses
import io
import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import tpu_spmv  # noqa: E402
import tpu_spmv.benchmark as jbench  # noqa: E402
from tpu_spmv.io import load_matrix_market as jax_load_mtx  # noqa: E402
from tpu_spmv.io import save_matrix_market as jax_save_mtx  # noqa: E402

import tpu_spmv_torch  # noqa: E402
from tpu_spmv_torch import (BenchmarkConfig, BenchmarkResult,  # noqa: E402
                            CSRMatrix, ELLMatrix, KernelType, SpMVConfig)
from tpu_spmv_torch import benchmark as tbench  # noqa: E402
from tpu_spmv_torch import timing  # noqa: E402
import tpu_spmv_torch.spmv as tspmv  # noqa: E402
from tpu_spmv_torch.cli import main as cli_main  # noqa: E402
from tpu_spmv_torch.errors import DeviceAllocError  # noqa: E402
from tpu_spmv_torch.io import (load_matrix_market,  # noqa: E402
                               save_matrix_market)
from tpu_spmv_torch.kernels import plan as tplan  # noqa: E402
from tpu_spmv_torch.kernels import window_ell as twe  # noqa: E402
from tpu_spmv_torch.utils.testing import (RandomGenerator,  # noqa: E402
                                          stencil_csr)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = "cpu"
FAST = BenchmarkConfig(num_warmup_runs=1, num_runs=3, iters_per_run=2)


def power_law():
    return RandomGenerator(42).power_law_csr(1500, 900, 10.0, 1.6)


# ---- statistics and JSON ----

@pytest.mark.parametrize("times", [[], [2.5], [1.0, 2.0, 4.0],
                                   [3.0, 3.0, 3.0, 3.0]])
def test_compute_stddev_is_the_sample_deviation(times):
    avg = sum(times) / len(times) if times else 0.0
    got = tbench.compute_stddev(times, avg)
    assert got == jbench.compute_stddev(times, avg)
    want = float(np.std(times, ddof=1)) if len(times) > 1 else 0.0
    assert math.isclose(got, want, rel_tol=1e-12, abs_tol=1e-15)


def sample_result(rng, name="t"):
    return dict(name=name, execution_time_ms=rng.uniform(0, 100),
                gflops=rng.uniform(0, 1000),
                bandwidth_gb_s=rng.uniform(0, 1000),
                avg_time_ms=rng.uniform(0, 100),
                min_time_ms=rng.uniform(0, 100),
                max_time_ms=rng.uniform(0, 100),
                stddev_time_ms=rng.uniform(0, 10),
                num_runs=rng.uniform_int(1, 100),
                correct=bool(rng.uniform_int(0, 1)),
                plan_build_ms=rng.uniform(0, 1e4))


def test_json_text_matches_jax_field_for_field():
    rng = RandomGenerator(3)
    for _ in range(10):
        fields = sample_result(rng)
        assert tbench.benchmark_to_json(BenchmarkResult(**fields)) \
            == jbench.benchmark_to_json(jbench.BenchmarkResult(**fields))


def test_comparison_json_matches_jax_but_the_device_key():
    rng = RandomGenerator(4)
    dev, cpu = sample_result(rng, "gpu_csr"), sample_result(rng, "cpu_csr")
    mine = tbench.comparison_to_json(tbench.ComparisonResult(
        BenchmarkResult(**dev), BenchmarkResult(**cpu), 12.5))
    theirs = jbench.comparison_to_json(jbench.ComparisonResult(
        jbench.BenchmarkResult(**dev), jbench.BenchmarkResult(**cpu), 12.5))
    assert mine == theirs.replace('"tpu":', '"gpu":', 1)
    data = json.loads(mine)
    assert set(data) == {"gpu", "cpu", "speedup"}


def test_benchmark_from_json_round_trips():
    rng = RandomGenerator(5)
    for _ in range(10):
        r = BenchmarkResult(**sample_result(rng))
        back = tbench.benchmark_from_json(tbench.benchmark_to_json(r))
        assert (back.name, back.num_runs, back.correct) \
            == (r.name, r.num_runs, r.correct)
        for f in ("execution_time_ms", "gflops", "bandwidth_gb_s",
                  "avg_time_ms", "min_time_ms", "max_time_ms",
                  "stddev_time_ms", "plan_build_ms"):
            assert abs(getattr(back, f) - getattr(r, f)) < 1e-5, f
        j = jbench.benchmark_from_json(tbench.benchmark_to_json(r))
        assert dataclasses.asdict(j) == dataclasses.asdict(back)


# ---- the harness on the CPU device ----

@pytest.mark.parametrize("kt", ["SCALAR_CSR", "VECTOR_CSR", "MERGE_PATH"])
def test_benchmark_csr_times_the_dispatch_plan(kt):
    A = power_law()
    x = RandomGenerator(7).vector(A.num_cols)
    cfg = SpMVConfig(kernel_type=KernelType[kt])
    r = tpu_spmv_torch.benchmark_csr(A, x, cfg, FAST, name=kt.lower(),
                                     device=CPU)
    assert r.correct and r.num_runs == 3 and r.name == kt.lower()
    assert 0 < r.min_time_ms <= r.avg_time_ms <= r.max_time_ms
    assert r.gflops == pytest.approx(2 * A.nnz / (r.avg_time_ms * 1e-3)
                                     / 1e9)
    # the plan the harness timed is the one spmv_csr serves (cached on A)
    res = tpu_spmv_torch.spmv_csr(A, x, cfg, device=CPU)
    assert res.plan is tspmv.resolve_csr(A, KernelType[kt], cfg,
                                         torch.device(CPU))


def test_benchmark_csr_bf16_checks_at_its_rounding():
    A = power_law()
    x = RandomGenerator(7).vector(A.num_cols)
    r = tpu_spmv_torch.benchmark_csr(
        A, x, SpMVConfig(kernel_type=KernelType.VECTOR_CSR,
                         bf16_values=True), FAST, device=CPU)
    assert r.correct


@pytest.mark.parametrize("pattern", [False, True])
def test_benchmark_ell(pattern):
    A = stencil_csr(40)
    if pattern:
        scale = RandomGenerator(7).rng.uniform(0.5, 2.0, A.num_cols) \
            .astype(np.float32)
        A = CSRMatrix(A.num_rows, A.num_cols, scale[A.col_indices],
                      A.col_indices, A.row_ptrs)
    E = ELLMatrix.from_csr(A)
    x = RandomGenerator(7).vector(A.num_cols)
    r = tpu_spmv_torch.benchmark_ell(E, x, SpMVConfig(pattern=pattern),
                                     FAST, device=CPU)
    assert r.correct and r.num_runs == 3 and r.avg_time_ms > 0
    plan = tpu_spmv_torch.spmv_ell(E, x, SpMVConfig(pattern=pattern),
                                   device=CPU).plan
    from tpu_spmv_torch.spmv import PatternPlan

    assert isinstance(plan, PatternPlan) == pattern


def test_correct_reports_a_wrong_plan(monkeypatch):
    A = power_law()
    x = RandomGenerator(7).vector(A.num_cols)
    real = tbench.run_plan
    monkeypatch.setattr(tbench, "run_plan", lambda p, v: real(p, v) * 1.001)
    assert not tpu_spmv_torch.benchmark_csr(A, x, bench_config=FAST,
                                            device=CPU).correct


def test_compare_gpu_cpu_csr():
    A = power_law()
    x = RandomGenerator(7).vector(A.num_cols)
    comp = tpu_spmv_torch.compare_gpu_cpu_csr(A, x, bench_config=FAST,
                                              device=CPU)
    assert comp.device_result.name == "gpu_csr" and comp.device_result.correct
    assert comp.cpu_result.name == "cpu_csr" and comp.cpu_result.num_runs == 3
    assert comp.speedup == pytest.approx(comp.cpu_result.avg_time_ms
                                         / comp.device_result.avg_time_ms)


def test_harness_without_a_card_raises(monkeypatch):
    A = power_law()
    x = RandomGenerator(7).vector(A.num_cols)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(DeviceAllocError):
        tpu_spmv_torch.benchmark_csr(A, x, bench_config=FAST)
    with pytest.raises(DeviceAllocError):
        tpu_spmv_torch.benchmark_ell(ELLMatrix.from_csr(A), x,
                                     bench_config=FAST)
    with pytest.raises(RuntimeError):
        timing.time_runs(lambda: None, "cuda", num_runs=1)


def test_time_runs_calibrates_and_counts_calls():
    calls = []
    times = timing.time_runs(lambda: calls.append(1), CPU, num_runs=4,
                             iters_per_run=3, warmup_runs=1)
    assert len(times) == 4 and all(t > 0 for t in times)
    assert len(calls) == 1 + 3 + 4 * 3     # first call, warm-up, runs
    calls.clear()
    timing.time_runs(lambda: calls.append(1), CPU, num_runs=1)
    assert len(calls) > 4 + 4              # calibrated past the probe


# ---- autotune ----

def test_autotune_returns_the_fastest_candidate(monkeypatch):
    """The candidates are the plans built at the widths (split rows 128);
    with the timer patched, the width timed fastest wins."""
    A = power_law()
    for fastest in (128, 384):
        seen = []

        def fake(fn, device, num_runs=20, iters_per_run=None,
                 warmup_runs=1):
            fn()
            seen.append(len(seen))
            width = (128, 384)[len(seen) - 1]
            return [1.0 if width == fastest else 2.0] * num_runs

        monkeypatch.setattr(timing, "time_runs", fake)
        report = {}
        plan = twe.WindowEllPlan.autotune(A, device=CPU, report=report)
        assert report == {128: 1.0 if fastest == 128 else 2.0,
                          384: 1.0 if fastest == 384 else 2.0}
        want = tplan.build(A, split_rows=128, step_groups=fastest)
        assert plan.step_groups == fastest
        for k in tplan.LEAVES:
            a, b = getattr(plan, k), getattr(want, k)
            assert (a is None and b is None) or np.array_equal(a.numpy(), b)
        assert {k: getattr(plan, k) for k in tplan.AUX} == want.aux()


def test_autotune_times_on_the_named_device():
    A = power_law()
    report = {}
    x = RandomGenerator(7).vector(A.num_cols)
    plan = twe.WindowEllPlan.autotune(A, x, widths=(8, 16), iters=2,
                                      device=CPU, report=report)
    assert set(report) == {8, 16} and plan.step_groups \
        == min(report, key=report.get)
    y = twe.spmv_window_ell(plan, torch.from_numpy(x)).numpy()
    from tpu_spmv_torch.utils.testing import spmv_matches

    assert spmv_matches(y, A, x, rel_tol=1e-5)


# ---- the CSR host API ----

def test_csr_host_api_matches_jax():
    rng = RandomGenerator(8)
    dense = rng.dense_matrix(40, 30, 0.2)
    A = tpu_spmv_torch.csr_from_dense(dense.reshape(-1), 40, 30)
    J = tpu_spmv.csr_from_dense(dense)
    for f in ("values", "col_indices", "row_ptrs"):
        assert np.array_equal(getattr(A, f), getattr(J, f))
    assert np.array_equal(tpu_spmv_torch.csr_to_dense(A), dense)
    for r in range(-1, 41, 3):
        for c in range(-1, 31, 2):
            assert tpu_spmv_torch.csr_get_element(A, r, c) \
                == tpu_spmv.csr_get_element(J, r, c)
    assert tpu_spmv_torch.csr_compute_stats(A) \
        .__dict__ == tpu_spmv.csr_compute_stats(J).__dict__
    E = tpu_spmv_torch.csr_create(3, 4, 5)
    F = tpu_spmv.csr_create(3, 4, 5)
    assert np.array_equal(E.row_ptrs, F.row_ptrs) and E.nnz == F.nnz == 5
    B = CSRMatrix.from_arrays(40, 30, J.values, J.col_indices, J.row_ptrs)
    assert np.array_equal(B.values, A.values)


def test_csr_files_cross_packages(tmp_path):
    A = power_law()
    J = tpu_spmv.CSRMatrix(A.num_rows, A.num_cols, A.values, A.col_indices,
                           A.row_ptrs)
    mine, theirs = io.BytesIO(), io.BytesIO()
    A.serialize(mine)
    J.serialize(theirs)
    assert mine.getvalue() == theirs.getvalue()
    jpath, ppath = str(tmp_path / "j.csr"), str(tmp_path / "p.csr")
    tpu_spmv.csr_serialize(J, jpath)
    B = tpu_spmv_torch.csr_deserialize(jpath)
    tpu_spmv_torch.csr_serialize(B, ppath)
    C = tpu_spmv.csr_deserialize(ppath)
    for f in ("values", "col_indices", "row_ptrs"):
        assert np.array_equal(getattr(C, f), getattr(A, f))
    with open(str(tmp_path / "short.csr"), "wb") as f:
        f.write(mine.getvalue()[:30])
    with pytest.raises(tpu_spmv_torch.FileIOError):
        CSRMatrix.deserialize(str(tmp_path / "short.csr"))


def test_csr_device_round_trip_and_free():
    A = power_law()
    d = tpu_spmv_torch.csr_to_device(A, CPU)
    B = CSRMatrix.create(A.num_rows, A.num_cols, 0)
    B.from_device(d)
    for f in ("values", "col_indices", "row_ptrs"):
        assert np.array_equal(getattr(B, f), getattr(A, f))
    tpu_spmv_torch.spmv_csr(A, RandomGenerator(7).vector(A.num_cols),
                            device=CPU)
    assert A._plan_cache
    A.free_device()
    assert not A._plan_cache
    with pytest.raises(tpu_spmv_torch.InvalidDimensionError):
        CSRMatrix.create(2, 2, 0).from_device(d)


# ---- Matrix Market ----

def test_matrix_market_files_cross_packages(tmp_path):
    rng = np.random.default_rng(7)
    dense = (rng.random((50, 40)) < 0.15).astype(np.float32)
    dense *= rng.standard_normal((50, 40)).astype(np.float32)
    A = tpu_spmv_torch.csr_from_dense(dense)
    ppath, jpath = str(tmp_path / "port.mtx"), str(tmp_path / "jax.mtx")
    save_matrix_market(A, ppath)
    jax_save_mtx(tpu_spmv.csr_from_dense(dense), jpath)
    with open(ppath) as f, open(jpath) as g:
        assert f.read().replace("tpu_spmv", "") == g.read().replace(
            "tpu_spmv", "")
    for path in (ppath, jpath):
        B, J = load_matrix_market(path), jax_load_mtx(path)
        for f in ("values", "col_indices", "row_ptrs"):
            assert np.array_equal(getattr(B, f), getattr(J, f)), f
            assert np.array_equal(getattr(B, f), getattr(A, f)), f


@pytest.mark.parametrize("native", [True, False])
def test_matrix_market_symmetric_pattern_and_duplicates(tmp_path,
                                                        monkeypatch, native):
    """Symmetric entries expanded, a pattern file's values 1, duplicate
    coordinates summed, as the JAX loader reads them; with the planner
    library and with its Python fallback."""
    path = str(tmp_path / "sym.mtx")
    with open(path, "w") as f:
        f.write("%%MatrixMarket matrix coordinate real symmetric\n% c\n"
                "4 4 5\n1 1 2.0\n3 1 1.5\n4 2 -1.0\n3 1 0.5\n4 4 3.0\n")
    pat = str(tmp_path / "pat.mtx")
    with open(pat, "w") as f:
        f.write("%%MatrixMarket matrix coordinate pattern general\n"
                "3 5 3\n1 5\n3 2\n2 1\n")
    if not native:
        from tpu_spmv_torch import native as tn

        monkeypatch.setattr(tn, "_library", lambda: None)
    for p in (path, pat):
        B, J = load_matrix_market(p), jax_load_mtx(p)
        assert (B.num_rows, B.num_cols) == (J.num_rows, J.num_cols)
        assert np.array_equal(B.to_dense(), J.to_dense())
    assert load_matrix_market(path).get_element(0, 2) == 2.0
    with pytest.raises(tpu_spmv_torch.SpMVException):
        load_matrix_market(str(tmp_path / "missing.mtx"))


# ---- the demo ----

def test_cli_runs_on_the_named_cpu(capsys):
    rc = cli_main(["--rows", "200", "--cols", "200", "--runs", "2",
                   "--pagerank-nodes", "60", "--device", "cpu", "--json"])
    assert rc == 0
    out = capsys.readouterr().out
    for kt in ("SCALAR_CSR", "VECTOR_CSR", "MERGE_PATH"):
        assert kt in out
    assert "auto-selector picks:" in out and "GPU vs CPU speedup:" in out
    assert "correct=True" in out and "correct=False" not in out
    assert '"gpu": {' in out and '"correct": false' not in out
    assert out.count('"correct": true') == 5   # comparison's two + three
    assert "PageRank: 60 nodes" in out and "top-10 nodes" in out
    pr = json.loads("{" + out.rsplit("\n{", 1)[1])
    assert pr["iterations"] >= 1 and len(pr["top_k"]) == 10


def test_cli_reads_a_matrix_market_file(tmp_path, capsys):
    rng = np.random.default_rng(7)
    dense = (rng.random((50, 40)) < 0.15).astype(np.float32)
    A = tpu_spmv_torch.csr_from_dense(dense)
    path = str(tmp_path / "input.mtx")
    save_matrix_market(A, path)
    rc = cli_main(["--matrix", path, "--runs", "2", "--skip-pagerank",
                   "--device", "cpu", "--pattern"])
    assert rc == 0
    out = capsys.readouterr().out
    assert f"50x40 ({path})" in out and f"nnz {A.nnz}" in out
    assert "correct=True" in out and "correct=False" not in out


def test_cli_without_a_card_exits_nonzero():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the demo would run")
    proc = subprocess.run([sys.executable, "-m", "tpu_spmv_torch.cli",
                           "--runs", "2"], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 2
    assert "no CUDA device" in proc.stderr and "Device" not in proc.stdout
