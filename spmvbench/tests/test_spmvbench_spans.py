"""The readers of the program's own spans, on runs whose slice and spans
are built by hand; on the card, a traced tiny cell reads them all."""

import os
import time

import pytest
import torch

from conftest import REPO
from spmvbench import run as harness
from spmvbench import trace
from spmvbench.run import Run, load_module

SPMV = ("resolve_host_us.spmv", "launch_host_us.spmv", "kernel_launches.spmv")
PAGERANK = ("mask_ms.pagerank", "readback_ms.pagerank",
            "step_host_us.pagerank")


def reader(name):
    return load_module(os.path.join(REPO, "spmvbench", "metrics",
                                    name + ".py"), "test_" + name)


def recorded(calls):
    """Spans as ``profiling.spans()`` gives them, from one list a call of
    ``(name, µs, count)`` children under the root ``calls`` names first."""
    from tpu_spmv_torch.profiling import Span

    spans, t = [], 1_000_000
    for call, (root, children) in enumerate(calls, 1):
        k = len(spans)
        spans.append(None)
        start = t
        for name, us, count in children:
            spans.append(Span(name, t, t + int(us * 1e3), k, call, count))
            t += int(us * 1e3) + 500
        spans[k] = Span(root, start - 100, t, -1, call, None)
        t += 10_000
    return spans


@pytest.fixture
def program(monkeypatch):
    """Hands the readers the spans a test sets."""
    from tpu_spmv_torch import profiling

    held = {"spans": [], "dropped": 0}
    monkeypatch.setattr(profiling, "spans", lambda: list(held["spans"]))
    monkeypatch.setattr(profiling, "dropped", lambda: held["dropped"])
    return held


def traced(loop, calls):
    s = trace.Slice([("fold_chunk", 0.0, 1.0)], [("x", 0.0, 2.0)],
                    (0.0, 2.0), calls=calls, spmvs=calls)
    return Run(loop, 100, 100, 1000, "cpu", trace=s)


SPMV_CALLS = [("spmv.call", [("spmv.resolve", 2.0, None),
                             ("spmv.launch", 60.0, 7)]),
              ("spmv.call", [("spmv.resolve", 4.0, None),
                             ("spmv.launch", 80.0, 7)])]
PAGERANK_CALLS = [("pagerank.call",
                   [("pagerank.mask", 150_000.0, None)]
                   + [("pagerank.step", 400.0, None),
                      ("pagerank.readback", 600.0, None)] * 3),
                  ("pagerank.call",
                   [("pagerank.mask", 170_000.0, None)]
                   + [("pagerank.step", 500.0, None),
                      ("pagerank.readback", 800.0, None)] * 2)]


def test_the_spmv_readers(program):
    program["spans"] = recorded(SPMV_CALLS)
    run = traced("spmv", 2)
    assert reader("resolve_host_us.spmv").read(run) == pytest.approx(3.0)
    assert reader("launch_host_us.spmv").read(run) == pytest.approx(70.0)
    assert reader("kernel_launches.spmv").read(run) == 7.0
    for name in PAGERANK:
        assert reader(name).read(run) is None, name


def test_the_pagerank_readers(program):
    program["spans"] = recorded(PAGERANK_CALLS)
    run = traced("pagerank", 2)
    assert reader("mask_ms.pagerank").read(run) == pytest.approx(160.0)
    assert reader("readback_ms.pagerank").read(run) == pytest.approx(
        (3 * 0.6 + 2 * 0.8) / 2)
    # a mean over the slice's 5 iterations, not over its calls
    assert reader("step_host_us.pagerank").read(run) == pytest.approx(
        (3 * 400 + 2 * 500) / 5)
    for name in SPMV:
        assert reader(name).read(run) is None, name


@pytest.mark.parametrize("name", SPMV + PAGERANK)
def test_a_slice_the_program_did_not_cover_reads_nothing(program,
                                                         monkeypatch, name):
    """Roots that do not number the slice's calls, spans dropped, no
    slice, or a program without the recorder: ``None``."""
    from tpu_spmv_torch import profiling

    loop = "spmv" if name.endswith(".spmv") else "pagerank"
    calls = SPMV_CALLS if loop == "spmv" else PAGERANK_CALLS
    program["spans"] = recorded(calls)
    assert reader(name).read(traced(loop, 2)) is not None
    assert reader(name).read(traced(loop, 3)) is None
    program["spans"] = recorded(calls[:1])
    assert reader(name).read(traced(loop, 2)) is None
    program["spans"] = recorded(calls)
    program["dropped"] = 1
    assert reader(name).read(traced(loop, 2)) is None
    program["dropped"] = 0
    run = traced(loop, 2)
    run.trace = None
    assert reader(name).read(run) is None
    monkeypatch.delattr(profiling, "spans")
    assert reader(name).read(traced(loop, 2)) is None


@pytest.mark.cuda
@pytest.mark.parametrize("cell, names", [("tiny.solve", SPMV),
                                         ("tinygraph.pagerank", PAGERANK)])
def test_a_traced_run_on_the_card_reads_the_programs_spans(tiny_root, cell,
                                                           names):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from tpu_spmv_torch import profiling

    profiling.clear()
    result, checks = harness.run_cell(
        tiny_root, cell, 2**31 + 5, 0.5, True, torch.device("cuda", 0),
        time.perf_counter())
    assert result["correct"], checks
    _, _, _, _, traffic = harness.resolve(tiny_root, cell)
    roots = [s for s in profiling.spans() if s.parent == -1]
    profiling.clear()
    assert len(roots) == traffic["trace_calls"]
    for name in names:
        assert result["metrics"][name]["value"] > 0, name
