"""Fixtures of the benchmark's CPU tests: a checkout root in a temporary
directory that holds a copy of ``spmvbench`` and a ``BENCHMARK.json``
whose cells are the real ones plus tiny cells of the same traffic mixes
(``tinygraphx4.pagerank`` on four shards, as ``graph500s20x4.pagerank``)."""

import json
import os
import shutil

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

TINY = {
    "tiny": {"generator": "power_law", "rows": 2048, "cols": 512,
             "avg_nnz": 12, "alpha": 1.6, "structure_seed": 42},
    "tinygraph": {"generator": "graph500", "scale": 11, "edgefactor": 8,
                  "a": 0.57, "b": 0.19, "c": 0.19, "structure_seed": 42},
}
TINY["tinygraphx4"] = {**TINY["tinygraph"], "shards": 4}
# each tiny cell reports the metrics of the real cell of its mix
TINY_CELLS = {"tiny.solve": "powerlaw262k.solve",
              "tinygraph.solve": "graph500s20.solve",
              "tinygraph.pagerank": "graph500s20.pagerank",
              "tinygraphx4.pagerank": "graph500s20x4.pagerank"}


def make_root(path) -> str:
    """A checkout root under ``path`` with the tiny cells added."""
    root = str(path)
    shutil.copytree(os.path.join(REPO, "spmvbench"),
                    os.path.join(root, "spmvbench"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        bench = json.load(f)
    for name, conf in TINY.items():
        rel = f"spmvbench/configs/{name}.json"
        with open(os.path.join(root, rel), "w") as f:
            json.dump(conf, f)
        bench["configs"].append({"name": name, "source": "tests",
                                 "file": rel, "reduced": [], "why": "tests"})
    for cell, real in TINY_CELLS.items():
        config, traffic = cell.split(".")
        bench["workloads"].append({"name": cell, "config": config,
                                   "traffic": traffic,
                                   "chips": TINY[config].get("shards", 1),
                                   "why": "tests"})
        for group in ("end_to_end", "per_layer"):
            for m in bench[group]:
                if real in m.get("workloads", ()):
                    m["workloads"].append(cell)
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return root


@pytest.fixture
def tiny_root(tmp_path):
    return make_root(tmp_path)


@pytest.fixture(autouse=True)
def _one_thread():
    """The CPU flows share the sandbox's cores: one intra-op thread."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
