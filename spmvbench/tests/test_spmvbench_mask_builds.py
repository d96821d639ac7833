"""``mask_builds.pagerank`` on runs whose slice and spans are built by hand
(the helpers of ``test_spmvbench_spans``), and on the card a traced tiny
PageRank cell, whose first call in set-up made the mask."""

import time

import pytest
import torch

from spmvbench import run as harness
from test_spmvbench_spans import (PAGERANK_CALLS, SPMV_CALLS,  # noqa: F401
                                  program, reader, recorded, traced)

NAME = "mask_builds.pagerank"


def with_counts(counts):
    """``PAGERANK_CALLS`` with each call's ``pagerank.mask`` count set."""
    return [(root, [(name, us, counts[k] if name == "pagerank.mask"
                     else count) for name, us, count in children])
            for k, (root, children) in enumerate(PAGERANK_CALLS)]


@pytest.mark.parametrize("counts, value", [((0, 0), 0.0), ((1, 0), 0.5),
                                           ((1, 1), 1.0)])
def test_reads_the_mean_count_a_call(program, counts, value):
    program["spans"] = recorded(with_counts(counts))
    assert reader(NAME).read(traced("pagerank", 2)) == value


def test_reads_nothing_without_a_count_or_on_the_spmv_loop(program):
    # a program whose span carries no count: PAGERANK_CALLS as recorded
    program["spans"] = recorded(PAGERANK_CALLS)
    assert reader(NAME).read(traced("pagerank", 2)) is None
    program["spans"] = recorded(with_counts((None, 0)))
    assert reader(NAME).read(traced("pagerank", 2)) is None
    program["spans"] = recorded(SPMV_CALLS)
    assert reader(NAME).read(traced("spmv", 2)) is None
    # a slice the program did not cover whole
    program["spans"] = recorded(with_counts((0, 0)))
    assert reader(NAME).read(traced("pagerank", 3)) is None


@pytest.mark.cuda
def test_a_traced_pagerank_cell_on_the_card_builds_no_mask(tiny_root):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from tpu_spmv_torch import profiling

    profiling.clear()
    result, checks = harness.run_cell(
        tiny_root, "tinygraph.pagerank", 2**31 + 9, 0.5, True,
        torch.device("cuda", 0), time.perf_counter())
    profiling.clear()
    assert result["correct"], checks
    assert result["metrics"][NAME]["value"] == 0.0
