"""The reader of the dispatch's captured calls, ``graph_replays.spmv``, on
runs whose slice and spans are built by hand (as
``test_spmvbench_spans.py`` builds them); on the card, a traced tiny cell
reads 1.0, every call of its slice a replay."""

import time

import pytest
import torch

from spmvbench import run as harness
from test_spmvbench_spans import program, reader, recorded, traced  # noqa: F401

NAME = "graph_replays.spmv"


def calls(*graph_counts):
    """One SpMV call a count, its ``spmv.graph`` span inside its launch;
    ``None`` for a call that records none."""
    return [("spmv.call", [("spmv.resolve", 2.0, 6), ("spmv.launch", 30.0, 7)]
             + ([] if n is None else [("spmv.graph", 25.0, n)]))
            for n in graph_counts]


@pytest.mark.parametrize("counts, value", [((1, 1), 1.0), ((0, 1), 0.5),
                                           ((0, 0), 0.0), ((None, 1), 0.5)])
def test_the_reader_is_the_share_of_replayed_calls(program,  # noqa: F811
                                                   counts, value):
    program["spans"] = recorded(calls(*counts))
    assert reader(NAME).read(traced("spmv", 2)) == pytest.approx(value)


def test_without_a_graph_span_the_reader_reads_nothing(program,  # noqa: F811
                                                       monkeypatch):
    """A program that records no ``spmv.graph`` (the parent's, or a plan
    it never captures), a PageRank slice, a slice the program did not
    cover whole, or no recorder: ``None``."""
    from tpu_spmv_torch import profiling

    program["spans"] = recorded(calls(None, None))
    assert reader(NAME).read(traced("spmv", 2)) is None
    program["spans"] = recorded(calls(1, 1))
    assert reader(NAME).read(traced("pagerank", 2)) is None
    assert reader(NAME).read(traced("spmv", 3)) is None
    run = traced("spmv", 2)
    run.trace = None
    assert reader(NAME).read(run) is None
    monkeypatch.delattr(profiling, "spans")
    assert reader(NAME).read(traced("spmv", 2)) is None


@pytest.mark.cuda
def test_a_traced_tiny_cell_on_the_card_replays_every_call(tiny_root):
    """Set-up's first and warm-up calls run and capture the plan, so every
    call of the traced slice replays its graph, and the port's launches a
    call read as the plan's."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from tpu_spmv_torch import profiling

    profiling.clear()
    result, checks = harness.run_cell(
        tiny_root, "tiny.solve", 2**31 + 7, 0.5, True,
        torch.device("cuda", 0), time.perf_counter())
    profiling.clear()
    assert result["correct"], checks
    metrics = result["metrics"]
    assert metrics[NAME]["value"] == 1.0
    assert metrics[NAME]["unit"] == "calls/call"
    assert metrics["kernel_launches.spmv"]["value"] > 0
    assert metrics["launches_per_call.spmv"]["value"] \
        >= metrics["kernel_launches.spmv"]["value"]
