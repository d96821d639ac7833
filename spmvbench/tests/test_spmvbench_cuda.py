"""On the card: a tiny cell's traced run reads the device (skips without
one)."""

import time

import pytest
import torch

from spmvbench import run as harness


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["tiny.solve", "tinygraph.pagerank"])
def test_traced_run_on_the_card(tiny_root, cell):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    result, checks = harness.run_cell(
        tiny_root, cell, 2**31 + 3, 0.5, True, torch.device("cuda", 0),
        time.perf_counter())
    assert result["correct"], checks
    dev = result["device"]
    assert dev["platform"] == "gpu" and 0 < dev["busy_s"] <= dev["window_s"]
    assert result["breakdown"]["device_ops"]
    for name, m in result["metrics"].items():
        if name.endswith("roofline"):
            assert 0 < m["value"] <= 100, (name, m)
