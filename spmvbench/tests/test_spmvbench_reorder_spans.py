"""The readers of the reordered path's spans, ``slots_per_nnz.spmv`` and
``reorder_host_us.spmv``, on runs whose slice and spans are built by hand
(as ``test_spmvbench_spans.py`` builds them)."""

import pytest

from test_spmvbench_spans import program, reader, recorded, traced  # noqa: F401

NEW = ("slots_per_nnz.spmv", "reorder_host_us.spmv")

# two calls of a reordered banded plan of 6 groups; the run has 1000
# nonzeros, so 6 * 1024 / 1000 slots a nonzero
REORDERED = [("spmv.call", [("spmv.resolve", 2.0, 6),
                            ("spmv.launch", 60.0, 9),
                            ("spmv.reorder", 50.0, 2)]),
             ("spmv.call", [("spmv.resolve", 4.0, 6),
                            ("spmv.launch", 80.0, 9),
                            ("spmv.reorder", 70.0, 2)])]
# a program before the counts: the resolve span counts nothing, and no
# call records a reorder
BEFORE = [("spmv.call", [("spmv.resolve", 2.0, None),
                         ("spmv.launch", 60.0, 7)])] * 2


def test_the_readers_of_a_reordered_slice(program):  # noqa: F811
    program["spans"] = recorded(REORDERED)
    run = traced("spmv", 2)
    assert reader("slots_per_nnz.spmv").read(run) == pytest.approx(6.144)
    assert reader("reorder_host_us.spmv").read(run) == pytest.approx(60.0)


def test_a_natural_plan_reads_its_slots_and_no_reorder(program):  # noqa: F811
    program["spans"] = recorded([("spmv.call", [("spmv.resolve", 2.0, 3),
                                                ("spmv.launch", 60.0, 7)])]
                                * 2)
    run = traced("spmv", 2)
    assert reader("slots_per_nnz.spmv").read(run) == pytest.approx(3.072)
    assert reader("reorder_host_us.spmv").read(run) is None


@pytest.mark.parametrize("name", NEW)
def test_without_the_spans_the_readers_read_nothing(program,  # noqa: F811
                                                     monkeypatch, name):
    """A program whose resolve span carries no count and which records no
    reorder (the parent's), a flat path's call, a PageRank slice, a slice
    the program did not cover whole, or no recorder: ``None``."""
    from tpu_spmv_torch import profiling

    program["spans"] = recorded(BEFORE)
    assert reader(name).read(traced("spmv", 2)) is None
    program["spans"] = recorded(REORDERED)
    assert reader(name).read(traced("spmv", 2)) is not None
    assert reader(name).read(traced("pagerank", 2)) is None
    assert reader(name).read(traced("spmv", 3)) is None
    run = traced("spmv", 2)
    run.trace = None
    assert reader(name).read(run) is None
    monkeypatch.delattr(profiling, "spans")
    assert reader(name).read(traced("spmv", 2)) is None


def test_a_flat_path_call_reads_no_slots(program):  # noqa: F811
    program["spans"] = recorded([("spmv.call", [("spmv.resolve", 2.0, None),
                                                ("spmv.launch", 9.0, 0)])]
                                + REORDERED[:1])
    assert reader("slots_per_nnz.spmv").read(traced("spmv", 2)) is None
