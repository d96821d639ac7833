"""K1's chunk schedule (``FoldSection``) and the plain fold that runs
through it, against the JAX package's kernel.

The schedule cuts each output superblock's runs, in plan order, into chunks
of at most R runs; a superblock of more than R runs writes partial tiles
that the ordered reduce sums.  The invariants are checked on the plans of
the port's test matrices at R = 1, 2 and the module value.  The plain fold
through a forced cut is held to JAX ``spmv_window_ell`` / ``spmv_pattern``
(Pallas interpret mode) under the backward-error row bound
``|y_port - y_jax|_i <= 1e-5 * max((|A||x|)_i, 1)``
(``tpu_spmv/utils/testing.py:221-248``): a run lost or counted twice, or a
chunk that straddles two superblocks, fails here on the CPU.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import tpu_spmv.kernels.window_ell as jwe  # noqa: E402

from tpu_spmv_torch.kernels import plan as tplan  # noqa: E402
from tpu_spmv_torch.kernels import window_ell as twe  # noqa: E402
from tpu_spmv_torch.utils.testing import (RandomGenerator,  # noqa: E402
                                          abs_row_scale,
                                          scrambled_banded_csr, spmv_matches,
                                          web_graph_csr)

ROW_TOL = 1e-5
CAPS = (1, 2, twe.CHUNK_RUNS)


@pytest.fixture
def absorb_helper(monkeypatch):
    monkeypatch.setattr(jwe, "_absorb_run_padding",
                        tplan._absorb_run_padding, raising=False)


def matrices():
    """The port tests' matrices: (name, CSR)."""
    return (("power_law", RandomGenerator(42).power_law_csr(8192, 2048, 12.0,
                                                           1.6)),
            ("web_graph", web_graph_csr(RandomGenerator(42), 16384, 16384,
                                        avg_nnz=15)),
            ("banded", scrambled_banded_csr(RandomGenerator(42), 16384, 1024,
                                            6.0)))


@pytest.fixture(scope="module")
def host_plans():
    """Host plans of each test matrix: f32 and pattern at sup 1024 and
    4096, and f32 at sup 16384 with runs of two groups (many runs per
    superblock)."""
    out = []
    for name, A in matrices():
        for sup, tb, pat in ((1024, 8, False), (4096, 8, True),
                             (4096, 8, False), (16384, 2, False)):
            out.append((f"{name}-{sup}-tb{tb}-{'pat' if pat else 'f32'}",
                        tplan.build(A, split_rows=128, step_groups=16,
                                    sup=sup, t_base=tb, pattern=pat,
                                    permute_rows=True)))
    return out


def expected_superblocks(hp: tplan.HostPlan) -> list:
    """Per section, ``{base: [runs in plan order]}`` from the plan's step
    arrays: the runs of the section's blocks in step order, those holding
    a slot that adds anything."""
    rpb = hp.step_groups // hp.tb
    if hp.pat:
        sbu = twe._unpack_sb(hp.sb, hp.sbn)
        live = np.any((sbu != twe.sentinel(hp.sbn))
                      .reshape(-1, hp.tb * 1024), axis=1)
    else:
        live = np.any(hp.vals.reshape(-1, hp.tb * 1024) != 0, axis=1)
    cuts = [0] + [i for i in np.flatnonzero(hp.fin_step == 1) if i > 0] \
        + [len(hp.blk_step)]
    sections = []
    for a, b in zip(cuts[:-1], cuts[1:]):
        sup = {}
        for blk in hp.blk_step[a:b]:
            for r in range(blk * rpb, (blk + 1) * rpb) if blk >= 0 else ():
                if live[r]:
                    sup.setdefault(int(hp.base[r]), []).append(r)
        if sup:
            sections.append(sup)
    return sections


@pytest.mark.parametrize("cap", CAPS)
def test_schedule_invariants(host_plans, cap):
    for label, hp in host_plans:
        plan = twe.plan_from_host(hp, "cpu")
        sections = twe._fold_schedule(plan, cap)
        expected = expected_superblocks(hp)
        assert len(sections) == len(expected), label
        for sec, want in zip(sections, expected):
            ro = sec.run_order.numpy()
            ptr = sec.chunk_ptr.numpy()
            slot = sec.chunk_slot.numpy()
            assert sec.n_chunks == len(slot) == len(ptr) - 1
            assert ptr[0] == 0 and ptr[-1] == len(ro) and np.all(np.diff(ptr)
                                                                 > 0)
            assert sec.max_runs == np.diff(ptr).max() <= cap, label
            # every live run exactly once
            assert np.array_equal(np.sort(ro),
                                  np.sort(np.concatenate(
                                      [np.asarray(v) for v in want.values()])))
            # a chunk never spans two superblocks; chunks of a superblock
            # are consecutive and keep its runs in plan order
            bases = [hp.base[ro[ptr[c]:ptr[c + 1]]] for c in range(len(slot))]
            assert all(np.all(b == b[0]) for b in bases), label
            chunk_base = np.array([b[0] for b in bases])
            starts = np.flatnonzero(np.r_[True, chunk_base[1:]
                                          != chunk_base[:-1]])
            assert len(starts) == len(want) == sec.n_sup
            sizes = []
            split_slots, split_base = [], []
            for s, e in zip(starts, np.r_[starts[1:], len(slot)]):
                base = int(chunk_base[s])
                runs = ro[ptr[s]:ptr[e]]
                assert runs.tolist() == want[base], label
                n_ch = -(-len(runs) // cap)
                assert e - s == n_ch
                if n_ch == 1:          # superblocks of <= R runs: unsplit
                    assert slot[s] == -1
                else:
                    assert np.all(slot[s:e] >= 0)
                    split_slots.append(slot[s:e].tolist())
                    split_base.append(base)
                sizes.append(len(runs))
            # heaviest superblock first
            assert sizes == sorted(sizes, reverse=True)
            # partial slots distinct, in chunk order per split superblock
            flat = [v for s in split_slots for v in s]
            assert flat == list(range(sec.n_slots))
            sp = sec.split_ptr.numpy()
            assert sec.n_split == len(split_base) == len(sp) - 1
            assert [list(range(sp[j], sp[j + 1])) for j in range(len(sp) - 1)
                    ] == split_slots
            assert sec.split_base.numpy().tolist() == split_base
            assert sec.max_split == max((len(s) for s in split_slots),
                                        default=0)


def test_plans_carry_the_module_cap(host_plans):
    _, hp = host_plans[0]
    plan = twe.plan_from_host(hp, "cpu")
    for a, b in zip(plan.sections, twe._fold_schedule(plan, twe.CHUNK_RUNS)):
        for f in dataclasses.fields(a):
            va, vb = getattr(a, f.name), getattr(b, f.name)
            assert torch.equal(va, vb) if isinstance(va, torch.Tensor) \
                else va == vb, f.name
    with pytest.raises(ValueError):
        twe._fold_schedule(plan, 0)


def test_chunk_reduce_sums_in_chunk_order():
    """The CPU section epilogue writes each split superblock's tiles as the
    sum of its workspace rows in chunk order, from zero, and touches
    nothing else of the output; it publishes the extras region (tiles 24
    on) into the table's tail, and nothing else of the table."""
    rng = np.random.default_rng(5)
    width = 8 * 128
    split_base = np.array([16, 0], np.int32)
    sec = twe.FoldSection(
        run_order=torch.zeros(1, dtype=torch.int32),
        chunk_ptr=torch.zeros(1, dtype=torch.int32),
        chunk_slot=torch.zeros(0, dtype=torch.int32),
        split_ptr=torch.tensor([0, 3, 5], dtype=torch.int32),
        split_base=torch.from_numpy(split_base),
        split_of_tile=torch.from_numpy(twe._split_of_tile(split_base, 8, 32)),
        n_sup=2, n_chunks=0, n_split=2, n_slots=5, max_runs=1, max_split=3)
    partial = torch.from_numpy(rng.standard_normal((5, width))
                               .astype(np.float32))
    out = torch.full((32 * 128,), 7.0)
    want = out.clone()
    want[16 * 128:24 * 128] = (partial[0] + partial[1]) + partial[2]
    want[0:width] = partial[3] + partial[4]
    table = torch.zeros(2048 + 8 * 128)
    got = twe.section_epilogue(partial, sec, out.clone(), table, 24 * 128)
    assert torch.equal(got, want)
    assert torch.equal(table[2048:], want[24 * 128:])
    assert not table[:2048].any()


def assert_row_bound(y, y_ref, A, x):
    diff = np.abs(np.asarray(y, np.float32) - np.asarray(y_ref, np.float32))
    bound = ROW_TOL * np.maximum(abs_row_scale(A, x), 1.0)
    assert np.all(diff <= bound), float(np.max(diff - bound))


def jax_plan(hp: tplan.HostPlan) -> jwe.WindowEllPlan:
    leaves = {k: None if v is None else jnp.asarray(v)
              for k, v in hp.leaves().items()}
    return jwe.WindowEllPlan(**leaves, **hp.aux(), occupancy=hp.occupancy)


def test_pattern_fold_through_forced_cuts_matches_jax(absorb_helper):
    """A small web graph on a pattern plan at sup 4096 (superblocks of
    dozens of two-group runs), column-scaled as the pattern path serves
    it: the plain fold at R = 1 and 2 against JAX ``spmv_pattern``."""
    A = web_graph_csr(RandomGenerator(42), 16384, 16384, avg_nnz=15)
    s = RandomGenerator(3).rng.uniform(0.5, 2.0, A.num_cols) \
        .astype(np.float32)
    B = type(A)(A.num_rows, A.num_cols, s[A.col_indices], A.col_indices,
                A.row_ptrs)
    x = RandomGenerator(7).vector(A.num_cols)
    hp = tplan.build(B, split_rows=128, sup=4096, t_base=2, pattern=True,
                     permute_rows=True)
    y_jax = np.asarray(jwe.spmv_pattern(jax_plan(hp), jnp.asarray(s),
                                        jnp.asarray(x)))
    plan = twe.plan_from_host(hp, "cpu")
    for cap in (1, 2):
        forced = dataclasses.replace(plan,
                                     sections=twe._fold_schedule(plan, cap))
        assert max(sec.max_split for sec in forced.sections) > 2 * cap
        y = twe.spmv_pattern(forced, torch.from_numpy(s),
                             torch.from_numpy(x)).numpy()
        assert_row_bound(y, y_jax, B, x)
        assert spmv_matches(y, B, x, rel_tol=ROW_TOL)


def test_banded_fold_through_forced_cuts_matches_jax(absorb_helper):
    """A small scrambled banded matrix, f32 values, merge-path at sup 1024
    with extras sections that publish: the plain fold at R = 1 and 2
    against JAX ``spmv_window_ell``."""
    A = scrambled_banded_csr(RandomGenerator(42), 16384, 1024, 6.0)
    x = RandomGenerator(7).vector(A.num_cols)
    hp = tplan.build(A, split_rows=128, sup=1024, permute_rows=True)
    y_jax = np.asarray(jwe.spmv_window_ell(jax_plan(hp), jnp.asarray(x)))
    plan = twe.plan_from_host(hp, "cpu")
    assert len(plan.sections) > 1
    for cap in (1, 2):
        forced = dataclasses.replace(plan,
                                     sections=twe._fold_schedule(plan, cap))
        assert sum(sec.n_split for sec in forced.sections) > 0
        y = twe.spmv_window_ell(forced, torch.from_numpy(x)).numpy()
        assert_row_bound(y, y_jax, A, x)
        assert spmv_matches(y, A, x, rel_tol=ROW_TOL)
