"""The ``hpcg`` law under the ``ell_solve`` mix: a tiny HPCG cell through
``loops/spmv_ell.py`` on the CPU, its control, the loop's ELL arrays, and
the readers of the program's ``spmv.plan`` and ``spmv.strips`` spans (on
runs whose slice and spans are built by hand, as
``test_spmvbench_spans.py`` builds them)."""

import json
import os
import time

import numpy as np
import pytest
import torch

from conftest import REPO, make_root
from spmvbench import run as harness
from test_spmvbench_spans import program, reader, recorded, traced  # noqa: F401

TINY_HPCG = {"generator": "hpcg", "nx": 12, "ny": 10, "nz": 9,
             "structure_seed": 42}
CELL = "tinyhpcg.ell_solve"
REAL = "hpcg104.ell_solve"
NEW = ("plan_builds.spmv", "strips_host_us.spmv")


@pytest.fixture
def hpcg_root(tmp_path):
    """A checkout root with the tiny cells and ``tinyhpcg.ell_solve``: the
    law at 12 × 10 × 9 under the ``ell_solve`` mix, reporting
    ``hpcg104.ell_solve``'s metrics."""
    root = make_root(tmp_path)
    rel = "spmvbench/configs/tinyhpcg.json"
    with open(os.path.join(root, rel), "w") as f:
        json.dump(TINY_HPCG, f)
    path = os.path.join(root, "BENCHMARK.json")
    with open(path) as f:
        bench = json.load(f)
    bench["configs"].append({"name": "tinyhpcg", "source": "tests",
                             "file": rel, "reduced": [], "why": "tests"})
    bench["workloads"].append({"name": CELL, "config": "tinyhpcg",
                               "traffic": "ell_solve", "chips": 1,
                               "why": "tests"})
    for group in ("end_to_end", "per_layer"):
        for m in bench[group]:
            if REAL in m.get("workloads", ()):
                m["workloads"].append(CELL)
    with open(path, "w") as f:
        json.dump(bench, f)
    return root


def run(root, control=False, traced=False, device="cpu"):
    return harness.run_cell(root, CELL, 2**33 + 29, 0.3, traced,
                            torch.device(device), time.perf_counter(),
                            control=control)


def test_the_cell_is_found_from_files_alone():
    bench, entry, conf, config, traffic = harness.resolve(REPO, REAL)
    assert entry["chips"] == 1 and conf["file"] == \
        "spmvbench/configs/hpcg104.json"
    assert (config["nx"], config["ny"], config["nz"]) == (104, 104, 104)
    assert traffic["loop"] == "spmv_ell"
    solve = harness.read_json(harness.find(REPO, "traffic", "solve",
                                           ".json"))
    assert {k: v for k, v in traffic.items() if k not in ("loop", "why")} \
        == {k: v for k, v in solve.items() if k not in ("loop", "why")}
    e2e = {m["name"] for m in harness.metrics_of(bench, REAL, False)}
    assert e2e == {"setup_s", "spmv_us", "spmv_p95_us"}
    layer = {m["name"] for m in harness.metrics_of(bench, REAL, True)}
    assert set(NEW) <= layer and "graph_replays.spmv" not in layer


def test_a_tiny_hpcg_run_is_correct_and_its_control_is_not(hpcg_root):
    result, checks = run(hpcg_root)
    assert result["correct"], checks
    assert result["failed"] == 0 and result["attempted"] > 0
    assert set(result["metrics"]) == {"setup_s", "spmv_us", "spmv_p95_us"}
    result, checks = run(hpcg_root, control=True)
    assert not result["correct"]
    assert checks["y_gap"][0] > checks["y_gap"][1]


def test_a_tiny_hpcg_run_with_rows_left_out_is_not_correct(hpcg_root,
                                                           monkeypatch):
    import tpu_spmv_torch

    real = tpu_spmv_torch.spmv_ell

    def broken(A, x, cfg=None, **kw):
        res = real(A, x, cfg, **kw)
        res.y = res.y.clone()
        res.y[res.y.shape[0] // 2:] = 0.0
        return res

    monkeypatch.setattr(tpu_spmv_torch, "spmv_ell", broken)
    result, checks = run(hpcg_root)
    assert not result["correct"], checks


def test_the_loops_ell_arrays_are_the_programs_layout():
    """The harness's slot-major arrays equal the program's own conversion
    of the same CSR (which the loop does not call)."""
    import tpu_spmv_torch
    from spmvbench.generators import hpcg

    loop = harness.load_module(harness.find(REPO, "loops", "spmv_ell",
                                            ".py"), "test_loop_spmv_ell")
    m = hpcg.generate(TINY_HPCG)
    k, values, cols = loop.ell_arrays(m)
    E = tpu_spmv_torch.ELLMatrix.from_csr(tpu_spmv_torch.CSRMatrix(
        m.num_rows, m.num_cols, m.values, m.col_indices, m.row_ptrs))
    assert k == E.max_nnz_per_row == 27
    assert np.array_equal(values, E.values)
    assert np.array_equal(cols, E.col_indices)
    assert (cols == -1).sum() == 27 * m.num_rows - m.nnz


def calls(*pairs):
    """One SpMV call a ``(plan count, strips µs)`` pair; ``None`` for a
    span the call does not record."""
    out = []
    for plan, strips in pairs:
        children = [("spmv.resolve", 2.0, 700)]
        if plan is not None:
            children.append(("spmv.plan", 1.5, plan))
        children.append(("spmv.launch", 90.0, 14))
        if strips is not None:
            children.append(("spmv.strips", strips, 2))
        out.append(("spmv.call", children))
    return out


@pytest.mark.parametrize("pairs, builds, strips_us", [
    (((0, 80.0), (0, 60.0)), 0.0, 70.0),
    (((1, 80.0), (0, 60.0)), 0.5, 70.0),
    (((0, None), (0, 60.0)), 0.0, 30.0)])
def test_the_readers_of_the_plan_and_strips_spans(program,  # noqa: F811
                                                  pairs, builds, strips_us):
    program["spans"] = recorded(calls(*pairs))
    run_ = traced("spmv", 2)
    assert reader("plan_builds.spmv").read(run_) == pytest.approx(builds)
    assert reader("strips_host_us.spmv").read(run_) \
        == pytest.approx(strips_us)


@pytest.mark.parametrize("name", NEW)
def test_without_the_spans_the_readers_read_nothing(program,  # noqa: F811
                                                    monkeypatch, name):
    """A program that records neither span (the parent's), a PageRank
    slice, a slice the program did not cover whole, or no recorder:
    ``None``."""
    from tpu_spmv_torch import profiling

    program["spans"] = recorded(calls((None, None), (None, None)))
    assert reader(name).read(traced("spmv", 2)) is None
    program["spans"] = recorded(calls((0, 80.0), (0, 60.0)))
    assert reader(name).read(traced("spmv", 2)) is not None
    assert reader(name).read(traced("pagerank", 2)) is None
    assert reader(name).read(traced("spmv", 3)) is None
    run_ = traced("spmv", 2)
    run_.trace = None
    assert reader(name).read(run_) is None
    monkeypatch.delattr(profiling, "spans")
    assert reader(name).read(traced("spmv", 2)) is None


@pytest.mark.cuda
def test_a_traced_tiny_hpcg_run_on_the_card_builds_no_plan(hpcg_root):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from tpu_spmv_torch import profiling

    profiling.clear()
    result, checks = run(hpcg_root, traced=True, device="cuda")
    profiling.clear()
    assert result["correct"], checks
    metrics = result["metrics"]
    assert metrics["plan_builds.spmv"]["value"] == 0.0
    assert metrics["kernel_launches.spmv"]["value"] > 0
    # a single window-ELL plan at this size (padded far past 104³'s 1.63
    # slots a nonzero), so no strips span
    assert metrics["slots_per_nnz.spmv"]["value"] >= 1.0
    assert "strips_host_us.spmv" not in metrics
    assert 0 < metrics["spmv_roofline"]["value"] <= 100
