"""The port's headline benchmark (``tpu_spmv_torch/bench.py``) against the
JAX ``bench.py``, on the CPU.

The smoke flow runs end to end on the CPU (``--device cpu --smoke``): its
line has exactly ``bench.py``'s keys plus ``device`` and ``plan_build_s``,
STREAM and ``vs_baseline`` null ("not measured"), and each candidate's
fingerprint equals the JAX planner's at the same step width and leveling
(F0's helper bound into the JAX module for the test).  Every failure the
JAX bench would pass over (a candidate that fails to build or fails the
oracle, a secondary that raises or fails its check, a guard broken three
times) ends the port's run non-zero with no line printed.
"""

import contextlib
import io
import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import tpu_spmv.kernels.window_ell as jwe  # noqa: E402
from tpu_spmv.csr import CSRMatrix as JaxCSRMatrix  # noqa: E402

from tpu_spmv_torch import bench  # noqa: E402
from tpu_spmv_torch.errors import DeviceAllocError  # noqa: E402
from tpu_spmv_torch.kernels import plan as tplan  # noqa: E402
from tpu_spmv_torch.utils.testing import RandomGenerator  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE_ARGS = ["--device", "cpu", "--smoke"]
# bench.py:398-422, in its order
JAX_TOP_KEYS = ["metric", "value", "unit", "vs_baseline", "detail"]
JAX_DETAIL_KEYS = [
    "spmv_over_stream", "stream_gb_s", "gflops", "gnnz_per_s", "nnz",
    "skewness", "occupancy", "winning_plan", "plan_fingerprints",
    "native_planner", "ell_stencil_gb_s", "web_graph_1m_gb_s",
    "pagerank_262k_ms_per_iter", "bf16_spmv_gb_s", "bf16_exact",
    "pattern_spmv_gb_s", "correct"]
PORT_DETAIL_KEYS = ["device", "plan_build_s"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """These flows run many small torch ops on the CPU: one intra-op thread
    keeps them from waiting on each other where test workers share the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def run_main(argv):
    """``bench.main(argv)`` with stdout captured: ``(rc, stdout)``."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = bench.main(argv)
    return rc, out.getvalue()


@pytest.fixture(scope="module")
def smoke():
    rc, out = run_main(SMOKE_ARGS)
    return rc, out


def test_smoke_on_cpu_prints_the_jax_line(smoke):
    rc, out = smoke
    assert rc == 0
    lines = out.strip().splitlines()
    assert len(lines) == 1                   # the one line on stdout
    line = json.loads(lines[-1])
    assert list(line) == JAX_TOP_KEYS
    assert list(line["detail"]) == JAX_DETAIL_KEYS + PORT_DETAIL_KEYS
    d = line["detail"]
    assert line["metric"] == "merge_path_csr_spmv_bandwidth"
    assert line["unit"] == "GB/s" and line["value"] > 0
    assert d["correct"] is True and d["native_planner"] is True
    assert line["vs_baseline"] is None and d["stream_gb_s"] is None \
        and d["spmv_over_stream"] is None
    assert d["device"] == "cpu" and d["plan_build_s"] > 0
    assert d["winning_plan"] in d["plan_fingerprints"]
    assert set(d["plan_fingerprints"]) == {"S=8", "S=16", "S=8+perm",
                                           "S=16+perm"}
    for key in ("ell_stencil_gb_s", "web_graph_1m_gb_s",
                "pagerank_262k_ms_per_iter", "bf16_spmv_gb_s",
                "pattern_spmv_gb_s", "gflops", "gnnz_per_s"):
        assert d[key] > 0, key
    assert d["bf16_exact"] is False


def test_smoke_fingerprints_equal_the_jax_planners(smoke, monkeypatch):
    """Each smoke candidate's fingerprint against ``WindowEllPlan.build``
    of the JAX package at the same step width and leveling, on the same
    matrix."""
    monkeypatch.setattr(jwe, "_absorb_run_padding",
                        tplan._absorb_run_padding, raising=False)
    rows, cols, avg = bench.SMOKE
    A = RandomGenerator(bench.SEED).power_law_csr(rows, cols, avg_nnz=avg,
                                                  alpha=bench.ALPHA)
    jA = JaxCSRMatrix(A.num_rows, A.num_cols, A.values, A.col_indices,
                      A.row_ptrs)
    fps = json.loads(smoke[1])["detail"]["plan_fingerprints"]
    assert json.loads(smoke[1])["detail"]["nnz"] == A.nnz
    for tag, fp in fps.items():
        S, perm = int(tag.split("+")[0][2:]), tag.endswith("+perm")
        jp = jwe.WindowEllPlan.build(jA, split_rows=128, step_groups=S,
                                     permute_rows=perm)
        assert bench.fingerprint(jp) == fp, tag


def test_rates_are_bench_py_arithmetic():
    """The byte model, GB/s, GFLOP/s, Gnnz/s and ``vs_baseline`` of given
    numbers, as ``bench.py:199-201`` and ``:393-394`` compute them."""
    rows, cols, nnz, secs, stream = 262144, 4096, 10_267_402, 117.45e-6, \
        2829.4
    model_bytes = nnz * 8 + (rows + 1) * 4 + cols * 4 + rows * 4
    assert model_bytes == 84_252_756
    assert bench.model_bytes(rows, cols, nnz) == model_bytes
    spmv_gbs = model_bytes / secs / 1e9
    r = bench.headline_rates(rows, cols, nnz, secs, stream)
    assert r["gb_s"] == spmv_gbs
    assert r["gflops"] == 2.0 * nnz / secs / 1e9
    assert r["gnnz_per_s"] == nnz / secs / 1e9
    frac = spmv_gbs / stream if stream > 0 else 0.0
    assert r["spmv_over_stream"] == frac
    assert r["vs_baseline"] == frac / 0.80
    assert r["vs_baseline"] == pytest.approx(0.317, abs=1e-3)
    assert bench.headline_rates(rows, cols, nnz, secs, 0.0)["vs_baseline"] \
        == 0.0
    off_card = bench.headline_rates(rows, cols, nnz, secs, None)
    assert off_card["vs_baseline"] is None \
        and off_card["spmv_over_stream"] is None


def test_a_candidate_that_fails_to_build_ends_the_run(monkeypatch, capsys):
    def broken(*a, **k):
        raise RuntimeError("injected planner failure")

    monkeypatch.setattr(bench, "build", broken)
    with pytest.raises(RuntimeError, match="injected planner failure"):
        bench.main(SMOKE_ARGS)
    assert capsys.readouterr().out == ""


def test_a_candidate_that_fails_the_oracle_ends_the_run(monkeypatch):
    monkeypatch.setattr(bench, "spmv_matches", lambda *a, **k: False)
    rc, out = run_main(SMOKE_ARGS)
    assert rc == 1 and out == ""


@pytest.mark.parametrize("where", ["stencil_raises", "pagerank_check"])
def test_a_failing_secondary_ends_the_run(monkeypatch, where):
    """A secondary that raises (the stencil's matrix), or whose check fails
    (PageRank's ranks), ends the run: no zero metric is reported."""
    if where == "stencil_raises":
        def broken(g):
            raise RuntimeError("injected stencil failure")

        monkeypatch.setattr(bench, "stencil_csr", broken)
        with pytest.raises(RuntimeError, match="injected stencil failure"):
            run_main(SMOKE_ARGS)
        return
    real = bench.pagerank

    def nan_ranks(*a, **k):
        r = real(*a, **k)
        r.ranks = torch.full_like(r.ranks, float("nan"))
        return r

    monkeypatch.setattr(bench, "pagerank", nan_ranks)
    rc, out = run_main(SMOKE_ARGS)
    assert rc == 1 and out == ""


def test_a_guard_broken_three_times_ends_the_run(monkeypatch):
    """With a STREAM no reading can stay under, each guarded timing is
    taken three times and the run fails: no raw median is reported."""
    calls = []
    seconds = bench.Clock.seconds

    def counted(self, fn, iters):
        calls.append(iters)
        return seconds(self, fn, iters)

    monkeypatch.setattr(bench.Clock, "on", staticmethod(
        lambda device: bench.Clock(device, 1e-12)))
    monkeypatch.setattr(bench.Clock, "seconds", counted)
    rc, out = run_main(SMOKE_ARGS)
    assert rc == 1 and out == ""
    assert calls == [bench.SMOKE_ITERS] * bench.GUARD_TRIES


def test_without_a_card_and_without_cpu_it_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(DeviceAllocError):
        bench.main(["--smoke"])


def test_bench_as_a_module_imports_no_jax():
    """``python -m tpu_spmv_torch.bench --device cpu --smoke`` runs, prints
    its line and imports nothing of JAX nor of the JAX package (every
    import listed by ``-X importtime``); without ``--device cpu`` and
    without a card it exits non-zero."""
    proc = subprocess.run(
        [sys.executable, "-X", "importtime", "-m", "tpu_spmv_torch.bench",
         *SMOKE_ARGS], cwd=ROOT, capture_output=True, text=True,
        timeout=300, env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert json.loads(proc.stdout.strip().splitlines()[-1])["detail"][
        "correct"] is True
    imported = [line.rsplit("|", 1)[1].strip()
                for line in proc.stderr.splitlines()
                if line.startswith("import time:") and "|" in line]
    assert {"tpu_spmv_torch", "tpu_spmv_torch.kernels.window_ell",
            "tpu_spmv_torch.pagerank"} <= set(imported)
    bad = [m for m in imported if m in ("jax", "tpu_spmv")
           or m.startswith(("jax.", "tpu_spmv."))]
    assert not bad, bad
    if not torch.cuda.is_available():
        proc = subprocess.run(
            [sys.executable, "-m", "tpu_spmv_torch.bench", "--smoke"],
            cwd=ROOT, capture_output=True, text=True, timeout=300)
        assert proc.returncode != 0 and proc.stdout == ""
        assert "DeviceAllocError" in proc.stderr
