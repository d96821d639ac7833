"""``correct`` comes out false for the control and for each fault a cell
can have, planted under the timed path of a tiny run on the CPU (the look
for a card skipped; the rest of the run as the benchmark drives it)."""

import time

import pytest
import torch

import tpu_spmv_torch
from spmvbench import run as harness


def run(root, cell, control=False):
    result, checks = harness.run_cell(root, cell, 2**31 + 101, 0.3, False,
                                      torch.device("cpu"),
                                      time.perf_counter(), control=control)
    return result["correct"], checks


def spmv_fault(monkeypatch, kind):
    real = tpu_spmv_torch.spmv_csr
    last = {}

    def broken(A, x, cfg=None, **kw):
        res = real(A, x, cfg, **kw)
        y = res.y.clone()
        if kind == "state unchanged":      # the previous call's output
            prev = last.get("y")
            last["y"] = res.y
            if prev is not None:
                y = prev
        elif kind == "half left out":
            y[y.shape[0] // 2:] = 0.0
        elif kind == "answer altered":
            y[y.shape[0] // 3] += 1e-3 * (1.0 + y[y.shape[0] // 3].abs())
        res.y = y
        return res

    monkeypatch.setattr(tpu_spmv_torch, "spmv_csr", broken)


@pytest.mark.parametrize("cell", ["tiny.solve", "tinygraph.solve"])
def test_spmv_control_fails(tiny_root, cell):
    ok, checks = run(tiny_root, cell)
    assert ok, checks
    ok, checks = run(tiny_root, cell, control=True)
    assert not ok
    assert checks["y_gap"][0] > checks["y_gap"][1]


@pytest.mark.parametrize("kind", ["state unchanged", "half left out",
                                  "answer altered"])
def test_spmv_faults_fail(tiny_root, monkeypatch, kind):
    spmv_fault(monkeypatch, kind)
    ok, checks = run(tiny_root, "tiny.solve")
    assert not ok, checks


def test_a_failed_call_fails(tiny_root, monkeypatch):
    real = tpu_spmv_torch.spmv_csr
    n = {"calls": 0}

    def failing(A, x, cfg=None, **kw):
        n["calls"] += 1
        res = real(A, x, cfg, **kw)
        if n["calls"] == 60:               # one call of the window
            res.error_code, res.y = 6, None
        return res

    monkeypatch.setattr(tpu_spmv_torch, "spmv_csr", failing)
    ok, checks = run(tiny_root, "tiny.solve")
    assert not ok and checks["failed"][0] == 1


def test_pagerank_control_fails(tiny_root):
    ok, checks = run(tiny_root, "tinygraph.pagerank")
    assert ok, checks
    ok, checks = run(tiny_root, "tinygraph.pagerank", control=True)
    assert not ok
    assert checks["rank_gap"][0] > checks["rank_gap"][1]


@pytest.mark.parametrize("kind", ["state unchanged", "answer altered",
                                  "stopped early"])
def test_pagerank_faults_fail(tiny_root, monkeypatch, kind):
    real = tpu_spmv_torch.pagerank

    def broken(P, cfg, **kw):
        if kind == "state unchanged":      # a step that returns r: the
            cfg = type(cfg)(**{**cfg.__dict__, "max_iterations": 1})
            res = real(P, cfg, **kw)       # stop test passes at once
            res.ranks = torch.full_like(res.ranks, 1.0 / P.num_rows)
            return res
        if kind == "stopped early":
            cfg = type(cfg)(**{**cfg.__dict__, "tolerance": 1e-3})
            return real(P, cfg, **kw)
        res = real(P, cfg, **kw)
        res.ranks = res.ranks.clone()
        res.ranks[P.num_rows // 2] *= 1.5
        return res

    monkeypatch.setattr(tpu_spmv_torch, "pagerank", broken)
    ok, checks = run(tiny_root, "tinygraph.pagerank")
    assert not ok, checks
