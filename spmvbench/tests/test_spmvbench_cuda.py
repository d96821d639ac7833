"""On the card: a tiny cell's traced run reads the device (skips without
one).  The sharded cell's four shards go to as many cards as there are,
up to four, taking turns on them."""

import time

import pytest
import torch

from spmvbench import run as harness


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["tiny.solve", "tinygraph.pagerank",
                                  "tinygraphx4.pagerank"])
def test_traced_run_on_the_card(tiny_root, cell):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    _, entry, *_ = harness.resolve(tiny_root, cell)
    count = torch.cuda.device_count()
    devices = [torch.device("cuda", i % count)
               for i in range(entry["chips"])]
    result, checks = harness.run_cell(
        tiny_root, cell, 2**31 + 3, 0.5, True, devices[0],
        time.perf_counter(), devices=devices)
    assert result["correct"], checks
    dev = result["device"]
    assert dev["platform"] == "gpu" and 0 < dev["busy_s"] <= dev["window_s"]
    assert result["breakdown"]["device_ops"]
    for name, m in result["metrics"].items():
        if name.endswith("roofline"):
            assert 0 < m["value"] <= 100, (name, m)
