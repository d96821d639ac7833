"""A cell across several cards: the configuration's ``shards`` against the
cell's ``chips``, the sharded PageRank loop on ``["cpu"] * 4`` against
the reference with its faults planted, the per-card trace arithmetic on
synthetic events, and the one-card readers unchanged by it."""

import importlib
import json
import os
import random
import time

import pytest
import torch

import tpu_spmv_torch
from conftest import REPO, TINY
from spmvbench import run as harness
from spmvbench import trace
from spmvbench.reference import models
from spmvbench.run import Run, load_module

CELL = "graph500s20x4.pagerank"
TINY_CELL = "tinygraphx4.pagerank"
KIND = "NVIDIA H100 80GB HBM3"
PER_CARD = ("exchange_pct.pagerank", "card_imbalance_pct.pagerank")
# the one-card cell's readers of the device trace, which read the sharded
# cell too
SHARED = ("pagerank_spmv_roofline", "device_idle_pct.pagerank")
parallel = importlib.import_module("tpu_spmv_torch.parallel")
distributed = importlib.import_module("tpu_spmv_torch.parallel.distributed")


def reader(name):
    return load_module(os.path.join(REPO, "spmvbench", "metrics",
                                    name + ".py"), "test_sharded_" + name)


def run(root, cell=TINY_CELL, control=False, traced=False):
    result, checks = harness.run_cell(root, cell, 2**31 + 57, 0.3, traced,
                                      torch.device("cpu"),
                                      time.perf_counter(), control=control)
    return result, checks


# ---- the benchmark's files ----

def test_every_cell_takes_as_many_chips_as_its_configuration_has_shards():
    bench = json.load(open(os.path.join(REPO, "BENCHMARK.json")))
    for cell in bench["workloads"]:
        _, entry, _, config, _ = harness.resolve(REPO, cell["name"])
        assert entry["chips"] == config.get("shards", 1), cell["name"]
    fours = [w for w in bench["workloads"] if w["chips"] == 4]
    assert [w["name"] for w in fours] == [CELL]


def test_the_sharded_cell_is_found_from_files_alone():
    bench, entry, conf, config, traffic = harness.resolve(REPO, CELL)
    assert conf["file"] == "spmvbench/configs/graph500s20x4.json"
    assert conf["reduced"] == ["scale"]
    one = harness.read_json(os.path.join(REPO, "spmvbench", "configs",
                                         "graph500s20.json"))
    law = ("generator", "scale", "edgefactor", "a", "b", "c",
           "structure_seed", "values")
    assert {k: config[k] for k in law} == {k: one[k] for k in law}
    assert config["shards"] == 4 and traffic["loop"] == "pagerank"
    assert traffic == harness.read_json(harness.find(
        REPO, "traffic", "pagerank", ".json"))
    e2e = {m["name"] for m in harness.metrics_of(bench, CELL, False)}
    assert e2e == {"setup_s", "pagerank_ms"}
    layer = {m["name"] for m in harness.metrics_of(bench, CELL, True)}
    assert layer == {"pagerank_iters", "plan_s", *SHARED, *PER_CARD}
    for name in layer:
        assert os.path.exists(harness.find(REPO, "metrics", name, ".py"))


def test_the_run_devices():
    cpu = torch.device("cpu")
    assert harness.run_devices(cpu, 4) == (cpu,) * 4
    assert harness.run_devices(torch.device("cuda", 0), 4) == tuple(
        torch.device("cuda", i) for i in range(4))
    assert harness.run_devices(torch.device("cuda", 0), 1) == (
        torch.device("cuda", 0),)


# ---- the sharded loop on four CPU shards ----

def test_the_sharded_loop_runs_correct_on_four_shards(tiny_root,
                                                      monkeypatch):
    calls = {"sharded": 0}
    real = parallel.pagerank_sharded

    def counted(*a, **kw):
        calls["sharded"] += 1
        return real(*a, **kw)

    monkeypatch.setattr(parallel, "pagerank_sharded", counted)
    monkeypatch.setattr(tpu_spmv_torch, "pagerank", None)  # never called
    result, checks = run(tiny_root)
    assert result["correct"], checks
    assert result["failed"] == 0 and result["attempted"] > 0
    assert calls["sharded"] == result["attempted"] + 2  # first, warm-up
    assert set(result["metrics"]) == {"setup_s", "pagerank_ms"}
    assert result["device"]["count"] == 4
    assert list(checks) == ["rank_gap", "iter_gap", "failed"]


def shard_rows_left_out(monkeypatch):
    real = distributed._gather_rows

    def broken(mesh, ys, bounds, rps):
        y = real(mesh, ys, bounds, rps).clone()
        y[bounds[1]:bounds[2]] = 0.0           # shard 1's rows
        return y

    monkeypatch.setattr(distributed, "_gather_rows", broken)


def exchange_left_out(monkeypatch):
    real = distributed.spmv_window_ell
    first = {}

    def broken(plan, x):                       # every shard but the first
        if plan is not first.setdefault("home", plan):   # keeps its x
            x = first.setdefault(id(plan), x)
        return real(plan, x)

    monkeypatch.setattr(distributed, "spmv_window_ell", broken)


def state_unchanged(monkeypatch):
    pr = importlib.import_module("tpu_spmv_torch.pagerank")

    def broken(spmv, mask, r, n, damping, tolerance, max_iterations):
        return 1, r, 0.0                       # a step that returns r

    monkeypatch.setattr(pr, "_iterate", broken)


def answer_altered(monkeypatch):
    real = parallel.pagerank_sharded

    def broken(*a, **kw):
        res = real(*a, **kw)
        res.ranks = res.ranks.clone()
        res.ranks[res.ranks.shape[0] // 2] *= 1.5
        return res

    monkeypatch.setattr(parallel, "pagerank_sharded", broken)


@pytest.mark.parametrize("fault", [shard_rows_left_out, exchange_left_out,
                                   state_unchanged, answer_altered])
def test_each_fault_of_the_sharded_path_fails(tiny_root, monkeypatch,
                                              fault):
    fault(monkeypatch)
    result, checks = run(tiny_root)
    assert not result["correct"], checks


def test_the_sharded_cells_control_fails(tiny_root):
    result, checks = run(tiny_root, control=True)
    assert not result["correct"]
    assert checks["rank_gap"][0] > checks["rank_gap"][1]


def test_the_tiny_sharded_configuration_is_the_tiny_graph():
    one, four = TINY["tinygraph"], TINY["tinygraphx4"]
    assert {k: v for k, v in four.items() if k != "shards"} == one


# ---- the per-card trace arithmetic ----

# µs; card 0: the column scale, its shard's fold, the gathers landing, the
# update; cards 1-3: the ranks arriving, their folds, the rows leaving;
# card 3 lags by 10 µs
EVENTS = [
    (0, "scale_kernel", 0.0, 5.0), (0, "fold_chunk", 20.0, 60.0),
    (0, "update_kernel", 90.0, 100.0),
    (1, "Memcpy PtoP (Device -> Device)", 5.0, 15.0),
    (1, "fold_chunk", 15.0, 55.0),
    (1, "Memcpy PtoP (Device -> Device)", 60.0, 70.0),
    (2, "Memcpy PtoP (Device -> Device)", 10.0, 20.0),
    (2, "fold_chunk", 20.0, 60.0),
    (2, "Memcpy PtoP (Device -> Device)", 65.0, 75.0),
    (3, "Memcpy PtoP (Device -> Device)", 10.0, 20.0),
    (3, "fold_chunk", 20.0, 70.0),
    (3, "Memcpy PtoP (Device -> Device)", 70.0, 90.0),
]
SPAN = (0.0, 120.0)


def four_card_run(events=EVENTS, span=SPAN, spmvs=1, rows=4096,
                  nnz=40000, cards=(0, 1, 2, 3)):
    s = trace.Slice([e[1:] for e in events], [("pagerank.call", *span)],
                    span, calls=1, spmvs=spmvs, card=[e[0] for e in events],
                    cards=cards)
    return Run("pagerank", rows, rows, nnz, KIND, trace=s,
               cards=len(cards))


def test_per_card_busy_idle_exchange_and_imbalance():
    run = four_card_run()
    s = run.trace
    busy = {0: 55.0, 1: 60.0, 2: 60.0, 3: 80.0}
    assert s.card_busy_us == pytest.approx(busy)
    assert s.busy_s == pytest.approx(100e-6)          # [0, 100]
    assert s.card_busy_s == pytest.approx(63.75e-6)
    mean = sum(busy.values()) / 4
    assert reader("device_idle_pct.pagerank").read(run) == pytest.approx(
        100 * (1 - mean / 120))
    # copies: [5, 20] and [60, 90]
    assert reader("exchange_pct.pagerank").read(run) == pytest.approx(
        100 * 45 / 100)
    assert reader("card_imbalance_pct.pagerank").read(run) == \
        pytest.approx(100 * (80 / mean - 1))
    least = models.pattern_bytes(4096, 40000) / (4 * 3.35e12)
    assert reader("pagerank_spmv_roofline").read(run) == pytest.approx(
        100 * least / 100e-6)


def test_a_card_with_nothing_traced_counts_as_idle():
    run = four_card_run(events=[e for e in EVENTS if e[0] != 2])
    assert run.trace.card_busy_us[2] == 0.0
    assert reader("card_imbalance_pct.pagerank").read(run) == \
        pytest.approx(100 * (80 / ((55 + 60 + 80) / 4) - 1))


def test_the_per_card_readers_are_silent_off_their_cells():
    one = four_card_run(events=[e for e in EVENTS if e[0] == 0],
                        cards=(0,))
    assert reader("exchange_pct.pagerank").read(one) is None
    assert reader("card_imbalance_pct.pagerank").read(one) is None
    spmv = four_card_run()
    spmv.loop = "spmv"
    untraced = four_card_run()
    untraced.trace = None
    other = four_card_run()
    other.device_kind = "some other card"
    for name in PER_CARD + SHARED:
        assert reader(name).read(spmv) is None, name
        assert reader(name).read(untraced) is None, name
    assert reader("pagerank_spmv_roofline").read(other) is None


def test_the_sharded_roofline_never_passes_100():
    """On random slices in which each card is busy at least as long as its
    shard's share of the byte model takes at the peak (what a card cannot
    beat), with copies and other work anywhere."""
    rng = random.Random(7)
    roof = reader("pagerank_spmv_roofline")
    for _ in range(300):
        cards = rng.choice([2, 3, 4])
        rows, nnz = rng.randrange(64, 1 << 20), rng.randrange(64, 1 << 25)
        spmvs = rng.randrange(1, 40)
        total = models.pattern_bytes(rows, nnz)
        weights = [rng.random() + 1e-3 for _ in range(cards)]
        # each card reads x whole and its share of the rest
        x = rows * 4
        share = [x + (total - x) * w / sum(weights) for w in weights]
        events, t = [], 0.0
        for c in range(cards):
            start = rng.uniform(0.0, 50.0)
            need = share[c] * spmvs / 3.35e12 * 1e6      # µs
            for k in range(rng.randrange(1, 5)):   # the first piece: all
                piece = need if k == 0 else rng.uniform(0.0, need)
                events.append((c, "fold_chunk", start, start + piece))
                start += piece + rng.uniform(0.0, 5.0)
            if rng.random() < 0.5:
                events.append((c, "Memcpy PtoP (Device -> Device)",
                               rng.uniform(0, 10), rng.uniform(10, 20)))
            t = max(t, start)
        run = four_card_run(events, (0.0, t + 1.0), spmvs, rows, nnz,
                            tuple(range(cards)))
        assert 0 < roof.read(run) <= 100.0


# ---- one card: every existing reader reads what it read before ----

ONE_CARD = [("fold_chunk", 10.0, 30.0), ("Memset (Device)", 25.0, 35.0),
            ("unpermute_kernel", 40.0, 50.0), ("fold_chunk", 70.0, 90.0),
            ("Memcpy HtoD (Pageable -> Device)", 88.0, 93.0),
            ("unpermute_kernel", 95.0, 100.0),
            ("dot_kernel", 104.0, 107.5)]
ONE_HOST = [("pagerank.call", 0.0, 12.0), ("pagerank.wait", 12.0, 62.0),
            ("pagerank.call", 62.0, 72.0), ("pagerank.wait", 72.0, 110.0)]
# each reader's value on the two runs below, as the readers and the slice
# read them before a slice kept each event's card
BEFORE = {
    "spmv": {"setup_s": 36.75, "plan_s": 25.8, "spmv_us": 7275.0,
             "spmv_p95_us": 7385.0, "dispatch_host_us.spmv": 7037.5,
             "launches_per_call.spmv": 2.5,
             "spmv_roofline": 0.3314160026933004,
             "device_idle_pct.spmv": 39.54545454545454},
    "pagerank": {"setup_s": 36.75, "plan_s": 25.8, "pagerank_ms": 7.275,
                 "pagerank_iters": 9.0,
                 "pagerank_spmv_roofline": 1.8223409269442263,
                 "device_idle_pct.pagerank": 39.54545454545454},
}
EXISTING = sorted({n for v in BEFORE.values() for n in v})


@pytest.mark.parametrize("loop", ["spmv", "pagerank"])
def test_a_recorded_one_card_run_reads_as_before(loop):
    s = trace.Slice(list(ONE_CARD), ONE_HOST, (0.0, 110.0), calls=2,
                    spmvs=2 if loop == "spmv" else 18,
                    card=[0] * len(ONE_CARD), cards=(0,))
    run = Run(loop, rows=4096, cols=4096, nnz=40000, device_kind=KIND,
              setup_s=36.75, plan_s=25.8, calls=4, window_s=0.0291,
              latency_ns=[7_100_000, 7_300_000, 7_250_000, 7_400_000],
              dispatch_ns=[6_900_000, 7_000_000, 7_050_000, 7_200_000],
              iterations=[9, 9, 9, 9], trace=s)
    assert run.cards == 1
    for name in EXISTING:
        assert reader(name).read(run) == BEFORE[loop].get(name), name
    # the device's numbers and the breakdown of the result's line
    assert s.card_busy_s == s.busy_s == pytest.approx(66.5e-6)
    assert trace.top_ops(s.device)[0] == ("fold_chunk", 40.0)
    assert trace.idle_gaps(s.device, s.host, *s.span)[:2] == [
        ("pagerank.wait", 20.0), ("pagerank.call", 10.0)]
