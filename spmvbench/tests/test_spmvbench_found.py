"""Everything a cell needs is found by name from ``BENCHMARK.json``; a
configuration, a traffic mix and a metric are added as files and entries
alone."""

import filecmp
import json
import os
import time

import torch

from conftest import REPO, make_root
from spmvbench import run as harness


def test_every_cell_of_the_benchmark_resolves():
    bench, *_ = harness.resolve(REPO, "powerlaw262k.solve")
    assert bench["paths"] == ["spmvbench"]
    for cell in bench["workloads"]:
        _, entry, conf, config, traffic = harness.resolve(REPO, cell["name"])
        assert os.path.exists(harness.find(REPO, "generators",
                                           config["generator"], ".py"))
        assert os.path.exists(harness.find(REPO, "loops", traffic["loop"],
                                           ".py"))
        for traced in (False, True):
            specs = harness.metrics_of(bench, cell["name"], traced)
            assert specs, (cell["name"], traced)
            for spec in specs:
                assert os.path.exists(harness.find(REPO, "metrics",
                                                   spec["name"], ".py"))
        e2e = {m["name"] for m in harness.metrics_of(bench, cell["name"],
                                                     False)}
        assert "setup_s" in e2e and len(e2e) >= 2
        for m in harness.metrics_of(bench, cell["name"], True):
            assert m["moves"] in e2e, (cell["name"], m["name"])


def test_a_cell_a_mix_and_a_metric_added_as_files_only(tmp_path):
    root = make_root(tmp_path)
    before = {p: open(os.path.join(root, p), "rb").read()
              for p in ("spmvbench/run.py", "spmvbench/loops/spmv.py")}
    # the fixture trio: a configuration, a mix and a metric, each a new file
    with open(os.path.join(root, "spmvbench/configs/fixture.json"), "w") as f:
        json.dump({"generator": "power_law", "rows": 1024, "cols": 256,
                   "avg_nnz": 6, "alpha": 2.0, "structure_seed": 7}, f)
    with open(os.path.join(root, "spmvbench/traffic/fixture_mix.json"),
              "w") as f:
        json.dump({"loop": "spmv", "vectors": 3,
                   "warmup_calls": 4, "check_outputs": 2,
                   "trace_warmup": 4, "trace_calls": 8, "trace_closing": 4,
                   "limits": {"y_gap": 1e-5, "failed": 0}}, f)
    with open(os.path.join(root, "spmvbench/metrics/fixture_calls.py"),
              "w") as f:
        f.write("def read(run):\n    return float(run.calls)\n")
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"].append({"name": "fixture", "source": "tests",
                             "file": "spmvbench/configs/fixture.json",
                             "reduced": [], "why": "tests"})
    bench["workloads"].append({"name": "fixture.fixture_mix",
                               "config": "fixture", "traffic": "fixture_mix",
                               "chips": 1, "why": "tests"})
    bench["end_to_end"].append({"name": "fixture_calls", "unit": "calls",
                                "better": "higher", "bound": 0.1,
                                "source": "host_clock",
                                "workloads": ["fixture.fixture_mix"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)

    result, checks = harness.run_cell(root, "fixture.fixture_mix", 5, 0.2,
                                      False, torch.device("cpu"),
                                      time.perf_counter())
    assert result["correct"], checks
    assert result["metrics"]["fixture_calls"]["value"] == result["attempted"]
    assert set(result["metrics"]) == {"setup_s", "fixture_calls"}
    for p, data in before.items():
        assert open(os.path.join(root, p), "rb").read() == data
    # the copied tree is the real one, file for file
    cmp = filecmp.dircmp(os.path.join(REPO, "spmvbench", "loops"),
                         os.path.join(root, "spmvbench", "loops"))
    assert not cmp.diff_files


def test_tiny_cells_run_correct_with_their_metrics(tiny_root):
    for cell, traced in (("tiny.solve", False),
                         ("tinygraph.pagerank", False)):
        result, checks = harness.run_cell(
            tiny_root, cell, 2**31 + 11, 0.3, traced, torch.device("cpu"),
            time.perf_counter())
        assert result["correct"], (cell, checks)
        assert result["failed"] == 0 and result["attempted"] > 0
        bench = json.load(open(os.path.join(tiny_root, "BENCHMARK.json")))
        want = {m["name"] for m in harness.metrics_of(bench, cell, traced)}
        assert set(result["metrics"]) == want, cell
        assert list(checks)[-1] == "failed"
