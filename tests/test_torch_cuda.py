"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips where no CUDA device is
present (a CUDA kernel has no CPU mode).  The file imports nothing of JAX,
so it runs on a machine that has only the port installed:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest

The fold's outputs are held to the backward-error row bound
``|y - y_plain|_i <= 1e-5 * max((|A||x|)_i, 1)``: the kernel and the plain
version (``index_add_``) sum each row in different orders.  The fold is
bit-identical from call to call, and so is the SpMV.  Its two epilogues,
the section epilogue (the ordered reduce and the publish of the extras
totals) and K2 (the unpermute, which sums the last section's split tiles),
match their plain versions exactly (the same additions in the same order),
with and without K2's tile map; the chunk permute and the gather table's
set-up (K3) move values without arithmetic and must match exactly, and a
reordered SpMV must equal the old composition of two permutes around the
inner SpMV bit for bit.
The benchmark probes' kernels are held to ``rtol=1e-5`` with
``atol = 1e-5 * max|ref|``: fp32 sums in another order, and in P1 and P2
atomic adds in no fixed order.  P3's modes and P2's ``w128`` add each
output element's runs in run order, as the CPU plain version
(``index_add_``) does, so they equal it bit for bit, at every tiling, and
two calls are bit-identical.  PageRank on the card is held to a float64
power iteration at ``rtol=1e-4, atol=1e-7``.  The multi-device layer runs
on 4 shards of one card (``["cuda:0"] * 4``), each path against the
oracle and the flat path at the row bound; a process group of one (NCCL)
equals the local mesh bit for bit; an out-of-memory error ends the call
with ``EXECUTION`` and no other route serves it; ``DeviceBuffer`` and
``profiling.trace`` run on the card, and the recorder's ``spmv.launch``
span counts the plan's launches; K1 launches on its tensors'
device while another is current (fault F9); one plan per lever group of
the fuzz slice (``tpu_spmv_torch.soak.LEVER_CASES``) runs K1-K3 held to the
plain versions on the CPU under the row bound and to the oracle; and
PageRank's loop at tolerance 0 reads nothing back inside the loop and
stops on a NaN residual (fault F10), and a second call on one matrix
takes the dangling mask the first uploaded.  The dispatch's captured call
(the headline-class matrix, a banded stack, the reordered banded mesh)
equals the eager call bit for bit over 16 ``x``, returns a tensor of its
own each call, counts the plan's launches on its first, second and tenth
call, runs eagerly on another stream, and records ``spmv.graph`` (1 a
replay) and the reordered plan's ``spmv.reorder``.  The headline benchmark's smoke
flow (``tpu_spmv_torch.bench --smoke``) runs on the card with STREAM
measured and its guard held.
"""

import dataclasses
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tpu_spmv_torch import (  # noqa: E402
    CSRMatrix, DeviceCSR, KernelType, PageRankConfig, SpMVConfig, SpMVError,
    pagerank, spmv_auto_config, spmv_csr)
from tpu_spmv_torch import kernels as tk  # noqa: E402
from tpu_spmv_torch import soak  # noqa: E402
from tpu_spmv_torch.probes import profile_dma_share as p5  # noqa: E402
from tpu_spmv_torch.probes import profile_kernel as p4  # noqa: E402
from tpu_spmv_torch.probes import proto_v2 as p1  # noqa: E402
from tpu_spmv_torch.probes import proto_v3 as p2  # noqa: E402
from tpu_spmv_torch.probes import proto_v4 as p3  # noqa: E402
from tpu_spmv_torch.kernels import plan as tplan  # noqa: E402
from tpu_spmv_torch.kernels import reorder as tr  # noqa: E402
from tpu_spmv_torch.kernels import window_ell as twe  # noqa: E402
from tpu_spmv_torch.spmv import PatternPlan, launches_per_call  # noqa: E402
from tpu_spmv_torch.utils.testing import (RandomGenerator,  # noqa: E402
                                          abs_row_scale, scrambled_banded_csr,
                                          spmv_matches, transition_matrix,
                                          web_graph_csr)

ROW_TOL = 1e-5


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def matrix():
    rng = RandomGenerator(42)
    A = rng.power_law_csr(8192, 2048, 12.0, 1.6)
    return A, rng.vector(A.num_cols)


def rows_of(out, plan):
    if plan.lam is None:
        return out[:plan.num_rows].cpu().numpy()
    return twe.unpermute_plain(out, plan.lam, plan.num_rows).cpu().numpy()


@pytest.mark.cuda
@pytest.mark.parametrize("leveled", [False, True])
@pytest.mark.parametrize("tb", [2, 4, 8])
@pytest.mark.parametrize("sup", [1024, 4096, 16384])
def test_fold_kernel_matches_plain(matrix, cuda_device, sup, tb, leveled):
    A, x = matrix
    plan = twe.plan_from_host(
        tplan.build(A, split_rows=128 if sup == 1024 else None,
                    step_groups=16, sup=sup, t_base=tb,
                    permute_rows=leveled), cuda_device)
    table = twe.gather_table(plan, torch.from_numpy(x).to(cuda_device))
    before = twe.window_ell_fold.launches["float32"]
    out = twe.window_ell_fold(plan, table)
    torch.cuda.synchronize()
    assert twe.window_ell_fold.launches["float32"] - before \
        == len(plan.sections)
    y = rows_of(out, plan)
    y_ref = rows_of(twe.window_ell_fold_plain(plan, table), plan)
    bound = ROW_TOL * np.maximum(abs_row_scale(A, x), 1.0)
    assert np.all(np.abs(y - y_ref) <= bound)
    assert spmv_matches(y, A, x, rel_tol=ROW_TOL)


def ones_of(A):
    return type(A)(A.num_rows, A.num_cols, np.ones(A.nnz, np.float32),
                   A.col_indices, A.row_ptrs)


@pytest.mark.cuda
@pytest.mark.parametrize("values", ["bfloat16", "pattern"])
@pytest.mark.parametrize("leveled", [False, True])
@pytest.mark.parametrize("tb", [2, 4, 8])
@pytest.mark.parametrize("sup", [1024, 4096, 16384])
def test_fold_variant_matches_plain(matrix, cuda_device, sup, tb, leveled,
                                    values):
    """K1's bf16 and pattern variants at every superblock height (sup 1024:
    nibble-packed sb, a pattern plan's sentinel nibble 15; 4096 and 16384:
    the int8 stream, sentinel -1), run length and leveling, merge-path with
    extras sections, against the plain version under the row bound; the
    pattern plan against the oracle of the 0/1 matrix."""
    A, x = matrix
    hp = tplan.build(A, split_rows=128, step_groups=16, sup=sup, t_base=tb,
                     permute_rows=leveled, pattern=values == "pattern",
                     values_dtype="bfloat16" if values == "bfloat16"
                     else "float32")
    plan = twe.plan_from_host(hp, cuda_device)
    assert plan.values == values and plan.sbn == (sup == 1024)
    table = twe.gather_table(plan, torch.from_numpy(x).to(cuda_device))
    tk.reset_launch_counts()
    out = twe.window_ell_fold(plan, table)
    torch.cuda.synchronize()
    name = tk.FOLD_VARIANTS[values]
    assert tk.launch_counts()[name] == len(plan.sections) > 1
    y = rows_of(out, plan)
    y_ref = rows_of(twe.window_ell_fold_plain(plan, table), plan)
    M = ones_of(A) if values == "pattern" else A
    bound = ROW_TOL * np.maximum(abs_row_scale(M, x), 1.0)
    assert np.all(np.abs(y - y_ref) <= bound)
    assert spmv_matches(y, M, x, rel_tol=8e-3 if values == "bfloat16"
                        else ROW_TOL)


@pytest.fixture(scope="module")
def web_matrix():
    A = web_graph_csr(RandomGenerator(42), 16384, 16384, avg_nnz=15)
    return A, RandomGenerator(7).vector(A.num_cols)


def web_plan(A, sup, values, dev):
    """A plan of the web graph with runs of two groups: superblocks of
    37-161 runs at every height."""
    hp = tplan.build(A, split_rows=128, sup=sup, t_base=2,
                     pattern=values == "pattern",
                     values_dtype="bfloat16" if values == "bfloat16"
                     else "float32")
    return twe.plan_from_host(hp, dev)


@pytest.mark.cuda
@pytest.mark.parametrize("values", ["float32", "bfloat16", "pattern"])
@pytest.mark.parametrize("sup", [1024, 4096, 16384])
@pytest.mark.parametrize("cap", [1, twe.CHUNK_RUNS, None],
                         ids=["R1", "Rmodule", "unsplit"])
def test_fold_at_forced_caps_matches_plain(web_matrix, cuda_device, cap, sup,
                                           values):
    """The chunked fold at R = 1, the module's R and no cut, on a plan with
    a superblock of more than 2R runs: against the plain version through
    the same schedule under the row bound, bit-identical across two calls,
    and one section epilogue after each section, the last included."""
    A, x = web_matrix
    plan = web_plan(A, sup, values, cuda_device)
    widest = max(s.max_runs for s in twe._fold_schedule(plan, 1 << 30))
    if cap is None:
        cap = widest
    assert widest > 2 * cap or cap == widest
    plan = dataclasses.replace(plan, sections=twe._fold_schedule(plan, cap))
    table = twe.gather_table(plan, torch.from_numpy(x).to(cuda_device))
    tk.reset_launch_counts()
    out = twe.window_ell_fold(plan, table)
    again = twe.window_ell_fold(plan, table)
    torch.cuda.synchronize()
    counts = tk.launch_counts()
    assert counts[tk.FOLD_VARIANTS[values]] == 2 * len(plan.sections)
    assert counts["section_epilogue"] == 2 * len(plan.sections)
    assert torch.equal(out, again)
    y = rows_of(out, plan)
    y_ref = rows_of(twe.window_ell_fold_plain(plan, table), plan)
    M = ones_of(A) if values == "pattern" else A
    bound = ROW_TOL * np.maximum(abs_row_scale(M, x), 1.0)
    assert np.all(np.abs(y - y_ref) <= bound)
    assert spmv_matches(y, M, x, rel_tol=8e-3 if values == "bfloat16"
                        else ROW_TOL)


def small_plan(A, dev, cap, leveled=True):
    """A merge-path plan of the small power-law matrix at sup 1024, runs of
    two groups, recut at ``cap`` runs per chunk: three sections; at R = 1
    each splits, the last included; at the module's R the last does not."""
    hp = tplan.build(A, split_rows=128, sup=1024, t_base=2,
                     permute_rows=leveled)
    plan = twe.plan_from_host(hp, dev)
    return dataclasses.replace(plan, sections=twe._fold_schedule(plan, cap))


@pytest.mark.cuda
@pytest.mark.parametrize("cap", [1, twe.CHUNK_RUNS], ids=["R1", "Rmodule"])
@pytest.mark.parametrize("sup", [1024, 4096, 16384])
def test_chunk_reduce_kernel_matches_plain_exactly(web_matrix, cuda_device,
                                                   sup, cap):
    """The section epilogue on random partial tiles of a real schedule (R =
    1, where every section splits, and the module's R), every section: the
    kernel and the plain version add the same rows in the same order, so
    they agree bit for bit, on the output and on the table's tail; only
    split superblocks' tiles of the output and the table's tail are
    written.  One launch each, split or not."""
    A, _ = web_matrix
    plan = web_plan(A, sup, "float32", cuda_device)
    plan = dataclasses.replace(plan, sections=twe._fold_schedule(plan, cap))
    g = torch.Generator().manual_seed(9)
    n_table = plan.cols_pad + plan.e8 * 128
    for sec in plan.sections:
        partial = torch.randn(max(sec.n_slots, 1), sup,
                              generator=g).to(cuda_device)
        fill = torch.randn(plan.out8 * 128, generator=g).to(cuda_device)
        table = torch.randn(n_table, generator=g).to(cuda_device)
        got_t = table.clone()
        before = twe.section_epilogue.launches
        got = twe.section_epilogue(partial, sec, fill.clone(), got_t,
                                   plan.extras_base)
        torch.cuda.synchronize()
        assert twe.section_epilogue.launches - before == 1
        want_t = table.clone()
        want = twe.section_epilogue_plain(partial, sec, fill.clone(), want_t,
                                          plan.extras_base)
        assert torch.equal(got, want)
        assert int((got != fill).sum()) <= sec.n_split * sup
        assert torch.equal(got_t, want_t)
        assert torch.equal(got_t[:plan.cols_pad], table[:plan.cols_pad])


@pytest.mark.cuda
@pytest.mark.parametrize("leveled", [False, True])
@pytest.mark.parametrize("cap", [1, twe.CHUNK_RUNS], ids=["R1", "Rmodule"])
def test_final_epilogue_matches_plain_exactly(matrix, cuda_device, cap,
                                              leveled):
    """K2 with the last section's tiles (split at R = 1, not at the
    module's R; unleveled plans take the identity map) against its plain
    version, bit for bit, on random partial tiles and output; its input is
    left as it was."""
    A, _ = matrix
    plan = small_plan(A, cuda_device, cap, leveled)
    last = plan.sections[-1]
    assert (last.n_split > 0) == (cap == 1)
    g = torch.Generator().manual_seed(11)
    partial = torch.randn(max(last.n_slots, 1), plan.sup,
                          generator=g).to(cuda_device)
    y = torch.randn(plan.out8 * 128, generator=g).to(cuda_device)
    keep = y.clone()
    before = twe.unpermute.launches
    got = twe.unpermute(y, plan.lam, plan.num_rows, partial=partial,
                        sec=last)
    torch.cuda.synchronize()
    assert twe.unpermute.launches - before == 1
    want = twe.unpermute_plain(y, plan.lam, plan.num_rows, partial=partial,
                               sec=last)
    assert torch.equal(got, want) and torch.equal(y, keep)


@pytest.mark.cuda
@pytest.mark.parametrize("leveled", [False, True])
@pytest.mark.parametrize("cap", [1, twe.CHUNK_RUNS], ids=["R1", "Rmodule"])
def test_spmv_launches_and_is_bit_identical(matrix, cuda_device, cap,
                                            leveled):
    """One SpMV: a fold per section, a section epilogue after each but the
    last, and K2 once wherever the plan is leveled or its last section
    split; no launch of an epilogue otherwise.  Two calls agree bit for
    bit, and the output matches the oracle."""
    A, x = matrix
    plan = small_plan(A, cuda_device, cap, leveled)
    xd = torch.from_numpy(x).to(cuda_device)
    tk.reset_launch_counts()
    y = twe.spmv_window_ell(plan, xd)
    torch.cuda.synchronize()
    n = len(plan.sections)
    assert n == 3 and tk.launch_counts() == {
        "window_ell_fold": n, "window_ell_fold_bf16": 0,
        "window_ell_fold_pattern": 0, "section_epilogue": n - 1,
        "unpermute": int(leveled or cap == 1), "permute_chunks": 1}
    again = twe.spmv_window_ell(plan, xd)
    torch.cuda.synchronize()
    assert torch.equal(y, again)
    assert spmv_matches(y.cpu().numpy(), A, x, rel_tol=ROW_TOL)


@pytest.mark.cuda
def test_raw_stream_is_the_current_stream(cuda_device):
    """The wrappers' raw stream (PyTorch's private accessor) is the one
    ``torch.cuda.current_stream`` names, on the default stream and on a side
    stream."""
    index = torch.cuda.current_device()
    assert twe._current_stream(index) \
        == torch.cuda.current_stream(index).cuda_stream
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        assert twe._current_stream(index) == side.cuda_stream


@pytest.mark.cuda
def test_epilogue_wrappers_refuse_wrong_device_or_dtype(matrix,
                                                        cuda_device):
    """A tensor on the CPU beside CUDA ones, of the wrong dtype, or a map
    too short for the output, raises ``ValueError`` before any launch
    (the epilogues, K2's tile map, the gather table's set-up)."""
    A, _ = matrix
    plan = small_plan(A, cuda_device, 1)
    sec = plan.sections[0]
    partial = torch.zeros(max(s.n_slots for s in plan.sections), plan.sup,
                          device=cuda_device)
    out = torch.zeros(plan.out8 * 128, device=cuda_device)
    table = torch.zeros(plan.cols_pad + plan.e8 * 128, device=cuda_device)
    tiles = torch.arange(plan.out8, dtype=torch.int32, device=cuda_device)
    x = torch.zeros(plan.num_cols, device=cuda_device)
    before = tk.launch_counts()
    eb = plan.extras_base
    bad = [lambda: twe.section_epilogue(partial.cpu(), sec, out, table, eb),
           lambda: twe.section_epilogue(partial.double(), sec, out, table,
                                        eb),
           lambda: twe.section_epilogue(partial, sec, out.double(), table,
                                        eb),
           lambda: twe.section_epilogue(partial, sec, out, table.cpu(),
                                        plan.extras_base),
           lambda: twe.section_epilogue(partial, sec, out, table.double(),
                                        plan.extras_base),
           lambda: twe.unpermute(out.double(), plan.lam, plan.num_rows),
           lambda: twe.unpermute(out, plan.lam.cpu(), plan.num_rows),
           lambda: twe.unpermute(out, plan.lam.long(), plan.num_rows),
           lambda: twe.unpermute(out, plan.lam, plan.num_rows,
                                 partial=partial.cpu(),
                                 sec=plan.sections[-1]),
           lambda: twe.unpermute(out, plan.lam, plan.num_rows,
                                 tile_src=tiles.cpu()),
           lambda: twe.unpermute(out, plan.lam, plan.num_rows,
                                 tile_src=tiles.long()),
           lambda: twe.unpermute(out, plan.lam, plan.num_rows,
                                 tile_src=tiles[:2]),
           lambda: twe.gather_table(plan, x.cpu().double()),
           lambda: twe.gather_table(plan, x.double()),
           lambda: twe.gather_table(plan, x, tiles.cpu()),
           lambda: twe.gather_table(plan, x, tiles.long()),
           lambda: twe.gather_table(plan, x, tiles[:2])]
    for call in bad:
        with pytest.raises(ValueError):
            call()
    assert tk.launch_counts() == before


@pytest.mark.cuda
@pytest.mark.parametrize("values", ["float32", "bfloat16", "pattern"])
def test_fold_is_bit_identical_across_calls(matrix, cuda_device, values):
    A, x = matrix
    hp = tplan.build(A, split_rows=128, sup=4096, pattern=values == "pattern",
                     values_dtype="bfloat16" if values == "bfloat16"
                     else "float32")
    plan = twe.plan_from_host(hp, cuda_device)
    table = twe.gather_table(plan, torch.from_numpy(x).to(cuda_device))
    outs = [twe.window_ell_fold(plan, table) for _ in range(3)]
    torch.cuda.synchronize()
    assert all(torch.equal(outs[0], o) for o in outs[1:])


@pytest.mark.cuda
def test_unpermute_kernel_matches_plain(cuda_device):
    rng = np.random.default_rng(3)
    lam = torch.from_numpy(np.stack([rng.permutation(128)
                                     for _ in range(64)]).astype(np.int32))
    y = torch.from_numpy(rng.standard_normal(50 * 128).astype(np.float32))
    before = twe.unpermute.launches
    got = twe.unpermute(y.to(cuda_device), lam.to(cuda_device), 6000)
    torch.cuda.synchronize()
    assert twe.unpermute.launches - before == 1
    assert torch.equal(got.cpu(), twe.unpermute_plain(y, lam, 6000))


@pytest.mark.cuda
@pytest.mark.parametrize("kernel_type", [KernelType.MERGE_PATH,
                                         KernelType.VECTOR_CSR])
def test_spmv_csr_on_card_matches_oracle(matrix, cuda_device, kernel_type):
    A, x = matrix
    cfg = spmv_auto_config(A)
    cfg.kernel_type = kernel_type
    tk.reset_launch_counts()
    res = spmv_csr(A, torch.from_numpy(x).to(cuda_device), cfg)
    assert res.error_code == 0 and res.y.device.type == "cuda"
    counts = tk.launch_counts()
    assert counts["window_ell_fold"] == len(res.plan.sections)
    assert counts["section_epilogue"] == len(res.plan.sections) - 1
    assert counts["unpermute"] == 1
    assert counts["permute_chunks"] == 1
    assert spmv_matches(res.y.cpu().numpy(), A, x, rel_tol=ROW_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("n, src, out_len", [
    (1000, [7, 0, 3, 1, 2, 7, 6, 5, 4], 9 * 128),       # x ends mid-chunk
    (1001, [0, 7, 7, 2, 40, -3, 1], 6 * 128 + 3),       # len % 4, past end
    (4096, list(range(31, -1, -1)), 32 * 128),          # whole chunks
    (130, [1, 1, 0, 5], 3 * 128 + 1),                   # tiny, repeats
])
def test_permute_kernel_matches_plain(cuda_device, n, src, out_len):
    x = torch.from_numpy(RandomGenerator(5).vector(n))
    s = torch.tensor(src, dtype=torch.int32)
    before = tr.permute_chunks.launches
    got = tr.permute_chunks(x.to(cuda_device), s.to(cuda_device), out_len)
    torch.cuda.synchronize()
    assert tr.permute_chunks.launches - before == 1
    assert torch.equal(got.cpu(), tr.permute_chunks_plain(x, s, out_len))


@pytest.mark.cuda
def test_permute_kernel_unaligned_pointer_and_round_trip(cuda_device):
    """A view starting one float in (not 16-byte aligned) takes the scalar
    path; ``order`` then its inverse gives x back bit for bit."""
    base = torch.from_numpy(RandomGenerator(6).vector(50 * 128 + 1))
    x = base.to(cuda_device)[1:]
    order = torch.from_numpy(np.random.default_rng(4).permutation(50)
                             .astype(np.int32))
    pos = torch.empty_like(order)
    pos[order.long()] = torch.arange(50, dtype=torch.int32)
    xp = tr.permute_chunks(x, order.to(cuda_device), 50 * 128)
    torch.cuda.synchronize()
    assert torch.equal(xp.cpu(), tr.permute_chunks_plain(base[1:], order,
                                                         50 * 128))
    back = tr.permute_chunks(xp, pos.to(cuda_device), x.numel())
    assert torch.equal(back, x)
    odd = tr.permute_chunks(xp[3:], pos.to(cuda_device), 1000)
    assert torch.equal(odd.cpu(), tr.permute_chunks_plain(
        xp[3:].cpu(), pos, 1000))


@pytest.mark.cuda
def test_reordered_spmv_csr_on_card_matches_oracle(cuda_device):
    A = scrambled_banded_csr(RandomGenerator(42), 16384, 1024, 6.0)
    x = RandomGenerator(7).vector(A.num_cols)
    tk.reset_launch_counts()
    res = spmv_csr(A, torch.from_numpy(x).to(cuda_device),
                   spmv_auto_config(A))
    assert res.error_code == 0 and res.y.device.type == "cuda"
    assert isinstance(res.plan, tr.ReorderedPlan)
    counts = tk.launch_counts()
    assert counts == {
        "window_ell_fold": len(res.plan.inner.sections),
        "window_ell_fold_bf16": 0, "window_ell_fold_pattern": 0,
        "section_epilogue": len(res.plan.inner.sections) - 1,
        "unpermute": 1, "permute_chunks": 1}
    assert spmv_matches(res.y.cpu().numpy(), A, x, rel_tol=ROW_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("cap", [None, 1], ids=["Rmodule", "R1"])
def test_reordered_spmv_equals_the_old_composition(cuda_device, cap):
    """The reordered SpMV through the composed maps (K3 setting up the
    table from x's chunks in ``col_src`` order, K2 writing output tile
    ``b`` from the inner tile ``row_src[b]``) equals, bit for bit, the old
    composition run on the same plan in the same process: ``permute_chunks``
    of x, the inner SpMV, ``permute_chunks`` of its rows (three kernels);
    at the module's R and at R = 1, where K2 sums the last section's split
    tiles through the tile map."""
    A = scrambled_banded_csr(RandomGenerator(42), 16384, 1024, 6.0)
    xd = torch.from_numpy(RandomGenerator(7).vector(A.num_cols)).to(
        cuda_device)
    rp = spmv_csr(A, xd, spmv_auto_config(A)).plan
    assert isinstance(rp, tr.ReorderedPlan)
    if cap is not None:
        rp = dataclasses.replace(rp, inner=dataclasses.replace(
            rp.inner, sections=twe._fold_schedule(rp.inner, cap)))
        assert rp.inner.sections[-1].n_split > 0
    tk.reset_launch_counts()
    got = tr.spmv_reordered(rp, xd)
    torch.cuda.synchronize()
    assert tk.launch_counts()["permute_chunks"] == 1
    assert tk.launch_counts()["unpermute"] == 1
    xp = tr.permute_chunks(xd, rp.col_src, rp.inner.num_cols)
    old = tr.permute_chunks(twe.spmv_window_ell(rp.inner, xp), rp.row_src,
                            rp.num_rows)
    torch.cuda.synchronize()
    assert torch.equal(got, old)


def nan_reused(n: int, dev) -> int:
    """Leave a NaN-filled block of ``n`` floats free in the caching
    allocator, where the next allocation of that size takes it; returns its
    address."""
    buf = torch.full((n,), float("nan"), device=dev)
    ptr = buf.data_ptr()
    del buf
    return ptr


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["in order", "reordered", "unaligned x",
                                  "ragged end", "src past the end"])
def test_gather_table_kernel_matches_plain(matrix, cuda_device, case):
    """The gather table's set-up (K3, one launch) against its plain version,
    bit for bit, written over a block that held NaN: every element of the
    table, the padding columns and the extras tail included, is written.
    In order (``src=None``) and through a chunk permutation; an x view one
    float in (the per-element path); x ending three floats short of the
    plan's columns (a ragged end); ``src`` with chunks past x's end and a
    negative one, over an x that ends mid-chunk."""
    A, x = matrix
    plan = small_plan(A, cuda_device, twe.CHUNK_RUNS)
    nb = -(-plan.num_cols // 128)
    g = np.random.default_rng(8)
    base = torch.from_numpy(RandomGenerator(6).vector(plan.num_cols + 1)) \
        .to(cuda_device)
    xv, src = base[:plan.num_cols], None
    if case != "in order" and case != "ragged end":
        src = torch.from_numpy(g.permutation(nb).astype(np.int32))
    if case == "unaligned x":
        xv = base[1:]
    elif case == "ragged end":
        xv = base[:plan.num_cols - 3]
    elif case == "src past the end":
        xv = base[:plan.num_cols - 50]
        src[[0, 3, 7]] = torch.tensor([nb, nb + 9, -3], dtype=torch.int32)
    if src is not None:
        src = src.to(cuda_device)
    n_table = plan.cols_pad + plan.e8 * 128
    ptr = nan_reused(n_table, cuda_device)
    before = tr.permute_chunks.launches
    got = twe.gather_table(plan, xv, src)
    torch.cuda.synchronize()
    assert tr.permute_chunks.launches - before == 1
    assert got.data_ptr() == ptr and got.shape == (n_table,)
    want = twe.gather_table_plain(plan, xv, src)
    assert not torch.isnan(got).any() and torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("leveled", [False, True])
@pytest.mark.parametrize("cap", [1, twe.CHUNK_RUNS], ids=["R1", "Rmodule"])
def test_final_epilogue_tile_map_matches_plain_exactly(matrix, cuda_device,
                                                       cap, leveled):
    """K2 with a tile map (a random permutation of the plan's tiles, one
    entry past them in place of its last, which reads as zeros) and the
    last section's tiles (split at R = 1) against its plain version, bit
    for bit, over an output that ends mid-tile; one launch."""
    A, _ = matrix
    plan = small_plan(A, cuda_device, cap, leveled)
    last = plan.sections[-1]
    g = torch.Generator().manual_seed(12)
    partial = torch.randn(max(last.n_slots, 1), plan.sup,
                          generator=g).to(cuda_device)
    y = torch.randn(plan.out8 * 128, generator=g).to(cuda_device)
    n_tiles = plan.out8 if plan.lam is None else plan.lam.shape[0]
    tile_src = torch.from_numpy(np.random.default_rng(5).permutation(
        n_tiles).astype(np.int32))
    tile_src[-1] = n_tiles
    tile_src = tile_src.to(cuda_device)
    n = n_tiles * 128 - 77
    before = twe.unpermute.launches
    got = twe.unpermute(y, plan.lam, n, partial=partial, sec=last,
                        tile_src=tile_src)
    torch.cuda.synchronize()
    assert twe.unpermute.launches - before == 1
    want = twe.unpermute_plain(y, plan.lam, n, partial=partial, sec=last,
                               tile_src=tile_src)
    assert torch.equal(got, want) and not got[(n_tiles - 1) * 128:].any()


@pytest.mark.cuda
def test_measure_fills_device_metrics(matrix, cuda_device):
    A, x = matrix
    res = spmv_csr(A, torch.from_numpy(x).to(cuda_device),
                   SpMVConfig(kernel_type=KernelType.MERGE_PATH),
                   measure=True, measure_iters=5, measure_samples=3)
    assert res.error_code == 0
    assert res.elapsed_ms > 0 and res.gflops > 0
    assert res.bandwidth.theoretical_gb_s > 0


@pytest.mark.cuda
@pytest.mark.parametrize("kernel_type", [KernelType.VECTOR_CSR,
                                         KernelType.MERGE_PATH])
def test_pagerank_on_card_matches_float64(cuda_device, kernel_type):
    """PageRank on a small web graph's transition matrix runs on a pattern
    plan on the card (K1's pattern variant and K2 each iteration) and
    matches a float64 power iteration with the same update."""
    A = transition_matrix(web_graph_csr(RandomGenerator(42), 8192, 8192,
                                        avg_nnz=15))
    cfg = PageRankConfig(max_iterations=30, tolerance=0.0,
                         kernel_type=kernel_type)
    tk.reset_launch_counts()
    res = pagerank(A, cfg)
    torch.cuda.synchronize()
    assert res.error_code == 0 and res.ranks.device.type == "cuda"
    assert isinstance(res.plan, PatternPlan) and res.iterations == 30
    plan = res.plan.plan
    counts = tk.launch_counts()
    assert counts["window_ell_fold_pattern"] == 30 * len(plan.sections)
    assert counts["window_ell_fold"] == counts["window_ell_fold_bf16"] == 0
    assert counts["section_epilogue"] == 30 * (len(plan.sections) - 1)
    assert counts["unpermute"] == (30 if plan.lam is not None
                                   or plan.sections[-1].n_split else 0)
    assert counts["permute_chunks"] == 30
    n = A.num_rows
    rows = np.repeat(np.arange(n), np.diff(A.row_ptrs))
    dang = np.bincount(A.col_indices, minlength=n) == 0
    r = np.full(n, 1.0 / n)
    for _ in range(30):
        Ar = np.bincount(rows, A.values.astype(np.float64)
                         * r[A.col_indices], minlength=n)
        r = 0.85 * Ar + 0.85 * r[dang].sum() / n + 0.15 / n
    r /= r.sum()
    ranks = res.ranks_host()
    np.testing.assert_allclose(ranks, r, rtol=1e-4, atol=1e-7)
    assert abs(float(ranks.sum()) - 1.0) < 1e-4


# each probe at a reduced size: (module, make_inputs keywords), every mode
PROBES = ((p1, dict(n_steps=4, S=32, out8=256)),
          (p4, dict(n_steps=8, S=32, n_sup=4)),
          (p2, dict(n_steps=4, S=32, out8=512)),
          (p3, dict(n_steps=4, S=32, out8=1024)),
          (p5, dict(n_blocks=16, S=32, n_out=4)))


@pytest.mark.cuda
@pytest.mark.parametrize("mod, kw, mode", [
    pytest.param(mod, kw, mode, id=f"{mod.__name__.rsplit('.', 1)[1]}-{mode}")
    for mod, kw in PROBES for mode in mod.MODES])
def test_probe_kernel_matches_plain(cuda_device, mod, kw, mode):
    inp = mod.make_inputs(**kw, modes=(mode,), device=cuda_device)[mode]
    before = mod.probe.launches
    got = mod.probe(inp)
    torch.cuda.synchronize()
    assert mod.probe.launches - before == 1
    ref = mod.probe_plain(inp)
    torch.testing.assert_close(got, ref, rtol=1e-5,
                               atol=1e-5 * float(ref.abs().max()))


# the run-ordered probe modes: P3's and P2's w128
TILE_MODES = [pytest.param(p3, mode, id=f"proto_v4-{mode}")
              for mode in p3.MAIN_MODES] + [
    pytest.param(p2, "w128", id="proto_v3-w128")]


@pytest.mark.cuda
@pytest.mark.parametrize("size", ["reduced", "default"])
@pytest.mark.parametrize("mod, mode", TILE_MODES)
def test_probe_tiles_equal_plain_bit_for_bit(cuda_device, mod, mode, size):
    """The owner-computes kernels against the CPU plain version, bit for
    bit, at the reduced and the JAX mains' sizes; two calls bit-identical."""
    kw = dict(PROBES)[mod] if size == "reduced" else {}
    ref = mod.probe_plain(mod.make_inputs(**kw, modes=(mode,))[mode])
    inp = mod.make_inputs(**kw, modes=(mode,), device=cuda_device)[mode]
    got, again = mod.probe(inp), mod.probe(inp)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), ref)
    assert torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("mod", [p1, p2, p3],
                         ids=["proto_v2", "proto_v3", "proto_v4"])
def test_probe_s_not_a_multiple_of_t_raises(cuda_device, mod):
    """The Pallas loop over S // T sub-tiles would drop groups."""
    with pytest.raises(ValueError, match="multiple of T"):
        mod.make_inputs(2, 24, out8=1024, device=cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["gather", "v2s8", "v2s16", "v2b8",
                                  "v2g16"])
def test_proto_v2_table_in_output_matches_v3_twin(cuda_device, mode):
    """P1's v2 forms gather from the output's head rows, seeded with x2d:
    outside them they compute what their v3 twins compute."""
    inputs = p1.make_inputs(4, 32, out8=256, modes=(mode, p1.twin(mode)),
                            device=cuda_device)
    got = p1.probe(inputs[mode])
    twin = p1.probe(inputs[p1.twin(mode)])
    torch.cuda.synchronize()
    assert torch.equal(got[:p1.COLS8], inputs[mode].x2d)
    assert not twin[:p1.COLS8].any()
    torch.testing.assert_close(got[p1.COLS8:], twin[p1.COLS8:], rtol=1e-5,
                               atol=1e-5 * float(twin.abs().max()))


@pytest.mark.cuda
def test_dma_share_unaligned_values_raise(cuda_device):
    inp = p5.make_inputs(4, 16, n_out=2, modes=("reuse1",),
                         device=cuda_device)["reuse1"]
    buf = torch.zeros(inp.vals.numel() + 1, device=cuda_device)
    with pytest.raises(ValueError, match="aligned"):
        p5.Inputs(**{**vars(inp), "vals": buf[1:].view(inp.vals.shape)})


# ---- the stacks of plans and the flat path ----

def stack_case(name: str, monkeypatch):
    """``(upload, A, x)`` of one stacked route at test scale: ``upload(dev)``
    makes the plan on ``dev`` from one host build.  A banded plan (3 bands,
    leveled and split), column strips with a banded strip, a composite of
    two levels, a composite of one level and a flat tail, and a reordered
    plan with a banded inner plan.  The group cap is lowered (the v5e guard
    the planner keeps) where the route needs it at this size."""
    from tpu_spmv_torch.kernels import strips as ts

    rng = RandomGenerator(42)
    if name == "banded":
        A = web_graph_csr(rng, 6000, 2100, avg_nnz=9)
        host = tplan.build_banded(A, sup=1024, n_bands=3, step_groups=16,
                                  split_rows=128, permute_rows=True)
        upload = lambda dev: twe.banded_from_host(host, dev)  # noqa: E731
    elif name == "strips":
        A = web_graph_csr(rng, 8192, 8192, avg_nnz=9)
        hs = ts.build_strips_host(A, strip_cols=4096, step_groups=16)
        monkeypatch.setattr(tplan, "MAX_GROUPS", hs.plans[0].n_groups - 8)
        hs = ts.build_strips_host(A, strip_cols=4096, step_groups=16)
        assert isinstance(hs.plans[0], tplan.HostBanded)
        upload = lambda dev: ts.strips_from_host(hs, dev)  # noqa: E731
    elif name.startswith("composite"):
        A = web_graph_csr(rng, 8192, 8192, avg_nnz=9)
        hc = tplan.build_composite(A, step_groups=16)
        if name == "composite-tail":
            monkeypatch.setattr(tplan, "MAX_GROUPS", hc.plans[0].n_groups)
            hc = tplan.build_composite(A, step_groups=16)
            assert hc.tail is not None
        upload = lambda dev: twe.composite_from_host(hc, dev)  # noqa: E731
    else:
        A = scrambled_banded_csr(rng, 16384, 1024, 6.0)
        order = tr.block_order(A)
        single, _ = tr.build_reordered_host(A, order, step_groups=16)
        monkeypatch.setattr(tplan, "MAX_GROUPS", single.n_groups - 8)
        host, _ = tr.build_reordered_host(A, order, step_groups=16)
        assert isinstance(host, tplan.HostBanded)
        upload = lambda dev: tr.reordered_from_host(  # noqa: E731
            host, order, A.num_rows, A.num_cols, dev)
    return upload, A, RandomGenerator(7).vector(A.num_cols)


STACKS = ["banded", "strips", "composite", "composite-tail",
          "reordered-banded"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", STACKS)
def test_stacked_spmv_on_card_matches_plain_route(cuda_device, monkeypatch,
                                                  name):
    """A stacked plan's SpMV on the card against the same plan's plain
    route on the CPU (under the row bound) and the oracle; two calls on the
    card agree bit for bit; the launches are the plan's
    (``launches_per_call``)."""
    from tpu_spmv_torch.spmv import launches_per_call, run_plan

    upload, A, x = stack_case(name, monkeypatch)
    plan, cpu_plan = upload(cuda_device), upload("cpu")
    xd = torch.from_numpy(x).to(cuda_device)
    tk.reset_launch_counts()
    y = run_plan(plan, xd)
    torch.cuda.synchronize()
    counts = tk.launch_counts()
    want = launches_per_call(plan)
    assert counts["window_ell_fold"] == want["fold"] > 0
    assert {k: counts[k] for k in ("section_epilogue", "unpermute",
                                   "permute_chunks")} \
        == {k: want[k] for k in ("section_epilogue", "unpermute",
                                 "permute_chunks")}
    again = run_plan(plan, xd)
    torch.cuda.synchronize()
    assert torch.equal(y, again)
    y = y.cpu().numpy()
    y_plain = run_plan(cpu_plan, torch.from_numpy(x)).numpy()
    bound = ROW_TOL * np.maximum(abs_row_scale(A, x), 1.0)
    assert np.all(np.abs(y - y_plain) <= bound)
    assert spmv_matches(y, A, x, rel_tol=ROW_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("name", STACKS)
def test_launches_per_call_by_plan_type(cuda_device, monkeypatch, name):
    """The counts ``launches_per_call`` gives for each stack: the bands',
    levels' or strips' own summed, and two chunk permutes around a
    reordered banded stack."""
    from tpu_spmv_torch.spmv import launches_per_call

    plan = stack_case(name, monkeypatch)[0](cuda_device)
    got = launches_per_call(plan)
    inner = plan.inner if name == "reordered-banded" else plan
    parts = [q for p in inner.plans
             for q in (p.plans if isinstance(p, twe.BandedPlan) else (p,))]
    assert got["permute_chunks"] == len(parts) \
        + 2 * (name == "reordered-banded")
    assert got["fold"] == sum(len(p.sections) for p in parts)
    assert got["section_epilogue"] == got["fold"] - len(parts)


@pytest.mark.cuda
def test_flat_path_on_card_is_bit_identical(cuda_device):
    """The flat path (gather, multiply, ``segment_reduce`` over the row
    pointers) on the card: two calls agree bit for bit, and it matches its
    own CPU run under the row bound and the oracle; it launches none of the
    port's kernels."""
    from tpu_spmv_torch.kernels.scalar import spmv_csr_scalar

    A = RandomGenerator(42).power_law_csr(8192, 2048, 12.0, 1.6)
    x = RandomGenerator(7).vector(A.num_cols)
    tk.reset_launch_counts()
    res = spmv_csr(A, torch.from_numpy(x).to(cuda_device),
                   SpMVConfig(kernel_type=KernelType.ELL_KERNEL))
    assert res.error_code == 0 and isinstance(res.plan, DeviceCSR)
    assert sum(tk.launch_counts().values()) == 0
    again = spmv_csr_scalar(res.plan, torch.from_numpy(x).to(cuda_device))
    torch.cuda.synchronize()
    assert torch.equal(res.y, again)
    y = res.y.cpu().numpy()
    y_cpu = spmv_csr_scalar(A.to_device("cpu"), torch.from_numpy(x)).numpy()
    bound = ROW_TOL * np.maximum(abs_row_scale(A, x), 1.0)
    assert np.all(np.abs(y - y_cpu) <= bound)
    assert spmv_matches(y, A, x, rel_tol=ROW_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("name", STACKS)
def test_stacked_call_is_captured_in_a_cuda_graph(cuda_device, monkeypatch,
                                                  name):
    """A stacked call (a banded call's three set-ups, folds, epilogues and
    join; the strips' and levels' adds; the flat tail; the permutes around
    a reordered banded stack) captured in a CUDA graph and replayed gives
    the eager call's output bit for bit: nothing in it syncs with the host
    or allocates from a size read back from the card."""
    from tpu_spmv_torch.spmv import run_plan

    upload, A, x = stack_case(name, monkeypatch)
    plan = upload(cuda_device)
    xd = torch.from_numpy(x).to(cuda_device)
    eager = run_plan(plan, xd)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        run_plan(plan, xd)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = run_plan(plan, xd)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, eager)
    assert spmv_matches(out.cpu().numpy(), A, x, rel_tol=ROW_TOL)



@pytest.mark.cuda
@pytest.mark.parametrize("name", ["single", "banded"])
def test_launch_span_counts_the_plans_launches(cuda_device, matrix,
                                               monkeypatch, name):
    """The recorder's ``spmv.launch`` span carries the port's kernels
    launched in it: ``launches_per_call`` of the plan, for a single plan
    through ``spmv_csr`` and a banded stack through the dispatch's
    launch."""
    from tpu_spmv_torch import profiling
    from tpu_spmv_torch.spmv import _execute, launches_per_call

    profiling.clear()
    if name == "single":
        A, x = matrix
        xd = torch.from_numpy(x).to(cuda_device)
        with profiling.recording():
            plan = spmv_csr(A, xd, SpMVConfig(
                kernel_type=KernelType.VECTOR_CSR)).plan
        assert isinstance(plan, twe.WindowEllPlan)
    else:
        upload, A, x = stack_case(name, monkeypatch)
        plan = upload(cuda_device)
        with profiling.recording(), profiling.annotate("banded"):
            _execute(plan, torch.from_numpy(x).to(cuda_device))
    torch.cuda.synchronize()
    launch = [s for s in profiling.spans() if s.name == "spmv.launch"]
    profiling.clear()
    assert len(launch) == 1
    assert launch[0].count == sum(launches_per_call(plan).values()) > 0

# ---- the dispatch's captured call ----

GRAPH_CASES = ["headline", "banded", "reordered-banded"]


def graph_case(name: str, monkeypatch, dev):
    """``(call, plan, A, xs)``: ``call(x)`` serves ``x`` through the
    dispatch's launch (``_execute``, with a plan cache of its own), each
    call a recorded root where anything records; ``plan`` is served; 16
    different ``x`` on ``dev``.  The headline-class power-law matrix
    through ``spmv_csr`` (one window-ELL plan), a banded stack, and the
    reordered banded mesh."""
    from tpu_spmv_torch import profiling
    from tpu_spmv_torch.spmv import _execute, resolve_csr

    if name == "headline":
        A = RandomGenerator(42).power_law_csr(8192, 2048, 12.0, 1.6)
        cfg = spmv_auto_config(A)
        # the plan the calls will serve, resolved (and cached) without a
        # call, so that the first call is the plan's first
        plan = resolve_csr(A, KernelType(cfg.kernel_type), cfg, dev)

        def call(x):
            res = spmv_csr(A, x, cfg)
            assert res.error_code == 0
            return res.y
    else:
        upload, A, _ = stack_case(name, monkeypatch)
        plan, cache = upload(dev), {}

        def call(x):
            with profiling.annotate("spmv.call"):
                return _execute(plan, x, cache)
    xs = [torch.from_numpy(RandomGenerator(100 + k).vector(A.num_cols)).to(
        dev) for k in range(16)]
    assert isinstance(plan, (twe.WindowEllPlan, twe.BandedPlan,
                             tr.ReorderedPlan))
    return call, plan, A, xs


@pytest.mark.cuda
@pytest.mark.parametrize("name", GRAPH_CASES)
def test_replayed_call_equals_eager_bit_for_bit(cuda_device, monkeypatch,
                                                name):
    """Over 16 different ``x`` the dispatch's calls (the first eager, the
    second captured, the rest replayed) equal the plan's eager run bit for
    bit; each call returns a tensor of its own, and every earlier ``y``
    keeps its values through 16 later calls."""
    from tpu_spmv_torch.spmv import run_plan

    call, plan, A, xs = graph_case(name, monkeypatch, cuda_device)
    ys = [call(x) for x in xs]
    eager = [run_plan(plan, x) for x in xs]
    more = [call(x) for x in reversed(xs)]
    torch.cuda.synchronize()
    assert len({y.data_ptr() for y in ys + more}) == 2 * len(xs)
    for y, e in zip(ys, eager):
        assert torch.equal(y, e)
    for y, e in zip(more, reversed(eager)):
        assert torch.equal(y, e)
    assert spmv_matches(ys[-1].cpu().numpy(), A, xs[-1].cpu().numpy(),
                        rel_tol=ROW_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("name", GRAPH_CASES)
def test_graph_calls_count_the_plans_launches(cuda_device, monkeypatch,
                                              name):
    """``launch_counts()`` moves by the plan's ``launches_per_call`` on
    the first (eager), second (captured) and tenth (replayed) call."""
    call, plan, A, xs = graph_case(name, monkeypatch, cuda_device)
    want = launches_per_call(plan)
    expect = {"window_ell_fold": want["fold"], "window_ell_fold_bf16": 0,
              "window_ell_fold_pattern": 0,
              **{k: want[k] for k in ("section_epilogue", "unpermute",
                                      "permute_chunks")}}
    assert expect["window_ell_fold"] > 0
    for k in range(1, 11):
        before = tk.launch_counts()
        call(xs[k % len(xs)])
        after = tk.launch_counts()
        if k in (1, 2, 10):
            assert {n: after[n] - before[n] for n in after} == expect, k
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("name", GRAPH_CASES)
def test_a_call_on_another_stream_runs_eagerly(cuda_device, monkeypatch,
                                               name):
    """Once captured, a call made on another current stream than the
    capture's runs the plan eagerly there (``spmv.graph`` counts 0) and is
    correct; the next call on the capture's stream replays."""
    from tpu_spmv_torch import profiling
    from tpu_spmv_torch.spmv import run_plan

    call, plan, A, xs = graph_case(name, monkeypatch, cuda_device)
    call(xs[0])
    call(xs[1])
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    profiling.clear()
    with profiling.recording():
        with torch.cuda.stream(side):
            y = call(xs[2])
        torch.cuda.current_stream().wait_stream(side)
        again = call(xs[2])
    torch.cuda.synchronize()
    counts = [s.count for s in profiling.spans() if s.name == "spmv.graph"]
    profiling.clear()
    assert counts == [0, 1]
    assert torch.equal(y, again) and torch.equal(y, run_plan(plan, xs[2]))
    assert spmv_matches(y.cpu().numpy(), A, xs[2].cpu().numpy(),
                        rel_tol=ROW_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("name", GRAPH_CASES)
def test_graph_span_counts_replays(cuda_device, monkeypatch, name):
    """``spmv.graph`` counts 0 on the eager first call and on the
    capture, 1 on each replay, inside ``spmv.launch``, whose count stays
    the plan's launches; a reordered banded plan's ``spmv.reorder`` counts
    its two standalone permutes on every call, replays too."""
    from tpu_spmv_torch import profiling

    call, plan, A, xs = graph_case(name, monkeypatch, cuda_device)
    profiling.clear()
    with profiling.recording():
        for x in xs[:4]:
            call(x)
    torch.cuda.synchronize()
    spans = profiling.spans()
    profiling.clear()
    by = {n: [s for s in spans if s.name == n]
          for n in ("spmv.launch", "spmv.graph", "spmv.reorder")}
    assert [s.count for s in by["spmv.graph"]] == [0, 0, 1, 1]
    assert [s.count for s in by["spmv.launch"]] \
        == [sum(launches_per_call(plan).values())] * 4
    assert all(spans[s.parent].name == "spmv.launch"
               for s in by["spmv.graph"])
    permutes = [s.count for s in by["spmv.reorder"]]
    assert permutes == ([2] * 4 if name == "reordered-banded" else [])


@pytest.mark.cuda
def test_threads_sharing_a_captured_plan_get_their_own_products(
        cuda_device, monkeypatch):
    """Sixteen threads, more than the host's cores, call ``spmv_csr`` on
    one captured plan at once under a short switch interval: every call's
    ``y`` equals the eager product of its own ``x`` (no two calls in
    flight share the graph's static buffers), and some calls replayed."""
    import threading

    from tpu_spmv_torch.spmv import CallGraph, run_plan

    call, plan, A, xs = graph_case("headline", monkeypatch, cuda_device)
    want = [run_plan(plan, x) for x in xs]
    call(xs[0])
    call(xs[1])
    served = []
    replay = CallGraph.__call__

    def counted(self, x):
        y = replay(self, x)
        served.append(y is not None)
        return y

    monkeypatch.setattr(CallGraph, "__call__", counted)
    got = []

    def work(t):
        for k in range(40):
            i = (7 * t + k) % len(xs)
            got.append((i, call(xs[i])))

    threads = [threading.Thread(target=work, args=(t,)) for t in range(16)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    torch.cuda.synchronize()
    assert len(got) == 16 * 40 and any(served)
    for i, y in got:
        assert torch.equal(y, want[i]), i


# ---- the ELL dispatch, plan files and the harness on the card ----

def ell_route_case(route):
    """``(ELL matrix, its CSR form, x, SpMVConfig)`` of each ELL route:
    one window-ELL plan, the pattern plan of a column-scaled stencil,
    column strips (columns past one gather table), the flat ELL path
    (columns past the packed cap)."""
    from tpu_spmv_torch import CSRMatrix, ELLMatrix
    from tpu_spmv_torch.spmv import PACKED_MAX_COLS, VMEM_X_MAX_COLS
    from tpu_spmv_torch.utils.testing import stencil_csr

    rng = RandomGenerator(42)
    if route == "plan":
        A = rng.power_law_csr(8192, 2048, 12.0, 1.6)
    elif route == "pattern":
        S = stencil_csr(96)
        scale = rng.rng.uniform(0.5, 2.0, S.num_cols).astype(np.float32)
        A = CSRMatrix(S.num_rows, S.num_cols, scale[S.col_indices],
                      S.col_indices, S.row_ptrs)
    else:
        cols = VMEM_X_MAX_COLS + (1 << 19) if route == "strips" \
            else PACKED_MAX_COLS + 4096
        rows, k = 2048, 6
        ca = np.stack([np.sort(rng.rng.choice(cols, k, replace=False))
                       for _ in range(rows)]).astype(np.int32)
        va = rng.rng.uniform(-2, 2, (rows, k)).astype(np.float32)
        A = CSRMatrix(rows, cols, va.reshape(-1), ca.reshape(-1),
                      np.arange(rows + 1, dtype=np.int32) * k)
    x = np.zeros(A.num_cols, np.float32)
    x[A.col_indices] = RandomGenerator(7).vector(A.nnz)
    return ELLMatrix.from_csr(A), A, x, SpMVConfig(pattern=route == "pattern")


ELL_ROUTES = {"plan": twe.WindowEllPlan, "pattern": PatternPlan,
              "strips": None, "flat": None}


@pytest.mark.cuda
@pytest.mark.parametrize("route", list(ELL_ROUTES))
def test_spmv_ell_on_card_matches_the_cpu_route(cuda_device, route):
    """``spmv_ell`` on the card against its ``device="cpu"`` result (the
    kernels' plain versions) under the row bound and the oracle, on each
    route; two calls agree bit for bit; the launches are the plan's."""
    from tpu_spmv_torch import DeviceELL, spmv_ell
    from tpu_spmv_torch.kernels.strips import StripPlan
    from tpu_spmv_torch.spmv import launches_per_call

    E, A, x, cfg = ell_route_case(route)
    kind = {"strips": StripPlan, "flat": DeviceELL}.get(route,
                                                        ELL_ROUTES[route])
    tk.reset_launch_counts()
    res = spmv_ell(E, torch.from_numpy(x).to(cuda_device), cfg)
    torch.cuda.synchronize()
    counts = tk.launch_counts()
    assert res.error_code == 0 and isinstance(res.plan, kind)
    want = launches_per_call(res.plan)
    folds = sum(counts[k] for k in tk.FOLD_VARIANTS.values())
    assert folds == want["fold"] and all(
        counts[k] == want[k] for k in ("section_epilogue", "unpermute",
                                       "permute_chunks"))
    assert (folds > 0) == (route != "flat")
    again = spmv_ell(E, torch.from_numpy(x).to(cuda_device), cfg)
    torch.cuda.synchronize()
    assert torch.equal(res.y, again.y)
    y = res.y.cpu().numpy()
    y_cpu = spmv_ell(E, x, cfg, device="cpu").y_host()
    bound = ROW_TOL * np.maximum(abs_row_scale(A, x), 1.0)
    assert np.all(np.abs(y - y_cpu) <= bound)
    assert spmv_matches(y, A, x, rel_tol=ROW_TOL)


@pytest.mark.cuda
def test_flat_ell_path_on_card_is_deterministic_and_graph_captured(
        cuda_device):
    """The flat ELL path on the card: the same bits call after call, the
    same bits replayed from a CUDA graph (nothing reads the card back),
    and its CPU run within the row bound."""
    from tpu_spmv_torch.kernels.ell_kernel import spmv_ell_device
    from tpu_spmv_torch.utils.testing import stencil_csr
    from tpu_spmv_torch import ELLMatrix

    A = stencil_csr(512)
    E = ELLMatrix.from_csr(A)
    x = RandomGenerator(7).vector(A.num_cols)
    dev = E.to_device(cuda_device)
    xd = torch.from_numpy(x).to(cuda_device)
    eager = spmv_ell_device(dev, xd)
    assert torch.equal(eager, spmv_ell_device(dev, xd))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        spmv_ell_device(dev, xd)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = spmv_ell_device(dev, xd)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, eager)
    y_cpu = spmv_ell_device(E.to_device("cpu"), torch.from_numpy(x))
    bound = ROW_TOL * np.maximum(abs_row_scale(A, x), 1.0)
    assert np.all(np.abs(eager.cpu().numpy() - y_cpu.numpy()) <= bound)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["f32", "bf16", "pattern", "banded",
                                  "strips", "reordered"])
def test_plan_saved_and_loaded_on_card_is_bit_identical(cuda_device,
                                                        monkeypatch,
                                                        tmp_path, kind):
    """A plan saved on the card and loaded back onto it (the fold schedule
    and tile maps derived again from the stored arrays) gives the saved
    plan's output bit for bit."""
    from tpu_spmv_torch import load_plan, save_plan
    from tpu_spmv_torch.spmv import run_plan

    if kind in ("banded", "strips"):
        upload, A, x = stack_case(kind, monkeypatch)
        plan = upload(cuda_device)
    elif kind == "reordered":
        A = scrambled_banded_csr(RandomGenerator(42), 16384, 1024, 6.0)
        x = RandomGenerator(7).vector(A.num_cols)
        plan = tr.build_reordered(A, device=cuda_device)
    else:
        A = RandomGenerator(42).power_law_csr(8192, 2048, 12.0, 1.6)
        x = RandomGenerator(7).vector(A.num_cols)
        plan = twe.plan_from_host(tplan.build(
            A, split_rows=128, permute_rows=True, pattern=kind == "pattern",
            values_dtype="bfloat16" if kind == "bf16" else "float32"),
            cuda_device)
    path = str(tmp_path / "plan.npz")
    save_plan(plan, path)
    loaded = load_plan(path)
    assert type(loaded) is type(plan)
    xd = torch.from_numpy(x).to(cuda_device)
    y, y_loaded = run_plan(plan, xd), run_plan(loaded, xd)
    torch.cuda.synchronize()
    assert y_loaded.device.type == "cuda" and torch.equal(y, y_loaded)


@pytest.mark.cuda
def test_harness_and_autotune_on_card(cuda_device):
    """The harness on the card (CUDA events), ``correct`` true, and
    autotune's winner, the fastest of its report, against the oracle."""
    from tpu_spmv_torch import (BenchmarkConfig, ELLMatrix, benchmark_csr,
                                benchmark_ell, compare_gpu_cpu_csr)
    from tpu_spmv_torch.utils.testing import stencil_csr

    A = RandomGenerator(42).power_law_csr(8192, 2048, 12.0, 1.6)
    x = RandomGenerator(7).vector(A.num_cols)
    bc = BenchmarkConfig(num_runs=3)
    r = benchmark_csr(A, x, spmv_auto_config(A), bc)
    assert r.correct and 0 < r.min_time_ms <= r.max_time_ms
    S = stencil_csr(256)
    e = benchmark_ell(ELLMatrix.from_csr(S),
                      RandomGenerator(7).vector(S.num_cols), bench_config=bc)
    assert e.correct and e.bandwidth_gb_s > 0
    comp = compare_gpu_cpu_csr(A, x, bench_config=bc)
    assert comp.device_result.correct and comp.speedup > 0
    report = {}
    plan = twe.WindowEllPlan.autotune(A, x, iters=20, device=cuda_device,
                                      report=report)
    assert plan.step_groups == min(report, key=report.get)
    y = twe.spmv_window_ell(plan, torch.from_numpy(x).to(cuda_device))
    assert spmv_matches(y.cpu().numpy(), A, x, rel_tol=ROW_TOL)


# ---- the multi-device layer, the ladder, DeviceBuffer, profiling ----

def card_mesh(n):
    from tpu_spmv_torch.parallel import make_row_mesh

    return make_row_mesh(n, devices=["cuda:0"] * n)


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["flat", "packed", "bf16", "pattern",
                                  "permuted", "ring"])
def test_sharded_paths_on_card_match_the_flat_path(cuda_device, path):
    """Each sharded path on 4 shards of the card against the oracle and
    the flat path (one DeviceCSR, plain ops) on the unpartitioned matrix;
    every packed shard launches K1, and the output is bit-identical
    across two calls."""
    from tpu_spmv_torch.kernels.scalar import spmv_csr_scalar
    from tpu_spmv_torch.parallel import (shard_csr, shard_csr_packed,
                                         shard_csr_ring, spmv_csr_ring,
                                         spmv_csr_sharded,
                                         spmv_csr_sharded_packed)

    A = RandomGenerator(42).power_law_csr(8192, 2048, 12.0, 1.6)
    if path == "pattern":
        A = transition_matrix(web_graph_csr(RandomGenerator(42), 8192, 8192,
                                            avg_nnz=9))
    x = RandomGenerator(7).vector(A.num_cols)
    mesh = card_mesh(4)
    if path == "flat":
        sh, run = shard_csr(A, mesh), spmv_csr_sharded
    elif path == "ring":
        sh, run = shard_csr_ring(A, mesh), spmv_csr_ring
    else:
        sh = shard_csr_packed(
            A, mesh, pattern=path == "pattern",
            permute_rows=path == "permuted",
            values_dtype="bfloat16" if path == "bf16" else "float32")
        run = spmv_csr_sharded_packed
    xd = torch.from_numpy(x).to(cuda_device)
    tk.reset_launch_counts()
    y = run(sh, xd)
    again = run(sh, xd)
    torch.cuda.synchronize()
    folds = sum(tk.launch_counts()[k] for k in tk.FOLD_VARIANTS.values())
    assert (folds == 0) == (path == "flat")
    assert y.is_cuda
    assert torch.equal(y, again)
    tol = 8e-3 if path == "bf16" else ROW_TOL
    assert spmv_matches(y.cpu().numpy(), A, x, rel_tol=tol)
    flat = spmv_csr_scalar(A.to_device(cuda_device), xd).cpu().numpy()
    bound = tol * np.maximum(abs_row_scale(A, x), 1.0)
    assert np.all(np.abs(y.cpu().numpy() - flat) <= bound)


@pytest.mark.cuda
def test_sharded_pagerank_on_card(cuda_device):
    """``pagerank_sharded`` over packed pattern shards on the card against
    the single-plan ``pagerank``: the same iteration count, ranks within
    1e-6."""
    from tpu_spmv_torch.pagerank import find_dangling_mask
    from tpu_spmv_torch.parallel import pagerank_sharded, shard_csr_packed

    A = transition_matrix(web_graph_csr(RandomGenerator(42), 8192, 8192,
                                        avg_nnz=9))
    res = pagerank_sharded(shard_csr_packed(A, card_mesh(4), pattern=True),
                           find_dangling_mask(A))
    single = pagerank(A)
    assert res.error_code == 0 and res.converged
    assert res.iterations == single.iterations
    assert res.ranks.is_cuda
    assert np.abs(res.ranks_host() - single.ranks_host()).max() < 1e-6


@pytest.mark.cuda
def test_ring_buffer_narrower_than_a_chunk(cuda_device):
    """A ring whose packed buffer is 8 wide (a banded matrix's halo): the
    table's set-up pads it to the plan's columns and reads nothing past
    it (K3's bounds test)."""
    from tpu_spmv_torch.parallel import (ring_traffic_report, shard_csr_ring,
                                         spmv_csr_ring)

    n = 4096
    idx = np.arange(n)
    rows = np.concatenate([idx[1:], idx, idx[:-1]])
    cols = np.concatenate([idx[:-1], idx, idx[1:]])
    order = np.lexsort((cols, rows))
    ptr = np.concatenate([[0], np.cumsum(np.bincount(rows, minlength=n))])
    vals = RandomGenerator(3).rng.uniform(0.5, 2.0, len(rows))
    A = CSRMatrix(n, n, vals.astype(np.float32),
                  cols[order].astype(np.int32), ptr.astype(np.int32))
    rs = shard_csr_ring(A, card_mesh(4))
    assert rs.u_max == 8 and ring_traffic_report(rs)["ring_wins"]
    x = RandomGenerator(7).vector(n)
    y = spmv_csr_ring(rs, torch.from_numpy(x).to(cuda_device))
    assert spmv_matches(y.cpu().numpy(), A, x, rel_tol=ROW_TOL)


@pytest.mark.cuda
def test_process_group_of_one_on_card_equals_the_local_mesh(cuda_device):
    """A NCCL process group of world size 1: the packed SpMV through
    ``all_gather_into_tensor`` equals the local one-shard mesh's bit for
    bit; the group is destroyed after."""
    import socket

    import torch.distributed as dist
    from tpu_spmv_torch.parallel import (init_distributed, make_row_mesh,
                                         shard_csr_packed,
                                         spmv_csr_sharded_packed)

    A = RandomGenerator(42).power_law_csr(8192, 2048, 12.0, 1.6)
    x = torch.from_numpy(RandomGenerator(7).vector(A.num_cols)).to(
        cuda_device)
    local = spmv_csr_sharded_packed(shard_csr_packed(A, card_mesh(1)), x)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    init_distributed(f"127.0.0.1:{port}", 1, 0)
    try:
        mesh = make_row_mesh()
        assert mesh.group is not None and mesh.n_shards == 1
        y = spmv_csr_sharded_packed(shard_csr_packed(A, mesh), x)
        torch.cuda.synchronize()
    finally:
        dist.destroy_process_group()
    assert torch.equal(y, local)


@pytest.mark.cuda
def test_oom_on_card_ends_the_call_with_execution(cuda_device, monkeypatch,
                                                  caplog):
    """An out-of-memory error injected into the packed route's fold on the
    card ends the call with ``EXECUTION``, logged once, and no other route
    (the flat path's torch ops) serves it; a launch error ends it the same
    way; the next call, nothing injected, is served by the packed plan."""
    import logging
    import sys

    from tpu_spmv_torch.errors import DeviceException

    tspmv = sys.modules["tpu_spmv_torch.spmv"]
    A = RandomGenerator(42).power_law_csr(8192, 2048, 12.0, 1.6)
    x = RandomGenerator(7).vector(A.num_cols)
    cfg = SpMVConfig(kernel_type=KernelType.MERGE_PATH)
    spmv_csr(A, x, cfg)                       # plan and kernels built

    def oom(*args, **kw):
        raise torch.OutOfMemoryError("CUDA out of memory (injected)")

    def flat(*args, **kw):
        raise AssertionError("the flat path ran")

    monkeypatch.setattr(tspmv, "spmv_csr_scalar", flat)
    monkeypatch.setattr(twe, "fold_sections", oom)
    with caplog.at_level(logging.WARNING, logger="tpu_spmv_torch"):
        res = spmv_csr(A, x, cfg)
    assert res.error_code == int(SpMVError.EXECUTION)
    assert res.y is None and res.plan is None
    assert sum("ran out of device memory" in r.message
               for r in caplog.records) == 1

    def launch_error(*args, **kw):
        raise DeviceException("window-ELL fold launch: cudaError 700")

    monkeypatch.setattr(twe, "fold_sections", launch_error)
    res = spmv_csr(A, x, cfg)
    assert res.error_code == int(SpMVError.EXECUTION)
    assert res.plan is None

    monkeypatch.undo()
    res = spmv_csr(A, x, cfg)
    assert res.error_code == 0 and not isinstance(res.plan, DeviceCSR)
    assert spmv_matches(res.y_host(), A, x, rel_tol=ROW_TOL)


@pytest.mark.cuda
def test_device_buffer_on_card(cuda_device):
    from tpu_spmv_torch import DeviceBuffer

    buf = DeviceBuffer(64)
    assert buf.get().is_cuda
    data = np.arange(64, dtype=np.float32)
    buf.copy_from_host(data[:16], count=16)
    out = buf.copy_to_host()
    np.testing.assert_array_equal(out[:16], data[:16])
    np.testing.assert_array_equal(out[16:], np.zeros(48, np.float32))
    buf.resize(8)
    assert buf.size == 8 and buf.get().is_cuda
    buf.release()
    assert buf.empty


@pytest.mark.cuda
def test_trace_names_the_fold(cuda_device, tmp_path):
    """``profiling.trace`` around an SpMV on the card writes a Chrome trace
    in which K1's kernel (``fold_chunk``) appears."""
    import json
    import os

    from tpu_spmv_torch import profiling

    A = RandomGenerator(42).power_law_csr(8192, 2048, 12.0, 1.6)
    x = RandomGenerator(7).vector(A.num_cols)
    cfg = SpMVConfig(kernel_type=KernelType.MERGE_PATH)
    spmv_csr(A, x, cfg)
    with profiling.trace(str(tmp_path)):
        with profiling.annotate("spmv"):
            spmv_csr(A, x, cfg)
    (name,) = os.listdir(tmp_path)
    with open(tmp_path / name) as f:
        names = [e.get("name", "") for e in json.load(f)["traceEvents"]]
    assert any("fold_chunk" in n for n in names)
    assert "spmv" in names


@pytest.mark.cuda
def test_fold_launches_on_its_tensors_device(cuda_device):
    """K1 and its epilogues launched on the last card while device 0 is
    current: the wrappers make the tensors' device current, and the
    shared-memory grant is per device (a sup-16384 plan's fold asks for
    more than the default 48 KB).  With one card this runs on device 0,
    which is then both."""
    last = torch.device("cuda", torch.cuda.device_count() - 1)
    A = RandomGenerator(42).power_law_csr(8192, 2048, 12.0, 1.6)
    x = RandomGenerator(7).vector(A.num_cols)
    ys = []
    for dev in (torch.device("cuda", 0), last):
        plan = twe.plan_from_host(tplan.build(A, sup=16384, split_rows=128,
                                              permute_rows=True), dev)
        with torch.cuda.device(0):
            ys.append(twe.spmv_window_ell(
                plan, torch.from_numpy(x).to(dev)).cpu())
    assert torch.equal(ys[0], ys[1])
    assert spmv_matches(ys[1].numpy(), A, x, rel_tol=ROW_TOL)


# ---- the fuzz slice's levers on the card, and F10's loop ----

@pytest.mark.cuda
@pytest.mark.parametrize("name", list(soak.LEVER_CASES))
def test_fuzz_lever_plan_on_card_matches_plain(cuda_device, name):
    """One plan per lever group of the fuzz slice (``t_base``, the step
    widths, ``spill_beta`` and the balancer, bypass and L2 balance,
    leveling, pattern, bf16, bands) through K1-K3 on the card, held to the
    same plan's plain versions on the CPU under the row bound, to the
    oracle, and to itself across two calls."""
    A, x, hp = soak.lever_case(name)
    banded = name == "banded"
    upload = twe.banded_from_host if banded else twe.plan_from_host
    run = twe.spmv_banded if banded else twe.spmv_window_ell
    plan, plan_cpu = upload(hp, cuda_device), upload(hp, "cpu")
    xd = torch.from_numpy(x).to(cuda_device)
    tk.reset_launch_counts()
    y_dev = run(plan, xd)
    torch.cuda.synchronize()
    counts = tk.launch_counts()
    values = (plan.plans[0] if banded else plan).values
    want = launches_per_call(plan)
    fold = tk.FOLD_VARIANTS[values]
    assert counts[fold] == want.pop("fold") > 0
    assert {k: counts[k] for k in want} == want
    assert torch.equal(run(plan, xd), y_dev)
    y = y_dev.cpu().numpy()
    y_ref = run(plan_cpu, torch.from_numpy(x)).numpy()
    bound = ROW_TOL * np.maximum(abs_row_scale(A, x), 1.0)
    assert np.all(np.abs(y - y_ref) <= bound)
    assert spmv_matches(y, A, x, rel_tol=8e-3 if values == "bfloat16"
                        else ROW_TOL)


READ_BACKS = ("item", "tolist", "cpu", "numpy", "__float__", "__int__",
              "__bool__", "__index__")


def count_read_backs(monkeypatch) -> list:
    """Wrap every ``Tensor`` method that brings a value to the host; the
    returned list gets one name per call."""
    calls = []
    for name in READ_BACKS:
        real = getattr(torch.Tensor, name)

        def wrapped(self, *args, _real=real, _name=name, **kw):
            calls.append(_name)
            return _real(self, *args, **kw)

        monkeypatch.setattr(torch.Tensor, name, wrapped)
    return calls


@pytest.mark.cuda
def test_pagerank_loop_on_card_reads_back_once_f10(cuda_device, monkeypatch):
    """At tolerance 0 the stop test stays on the card: one read-back (the
    count and the residual, after the loop) for 5 iterations and for 40,
    none inside the loop; and a NaN in the starting ranks stops the loop
    after its first iteration, as the JAX loop does (F10)."""
    A = transition_matrix(web_graph_csr(RandomGenerator(1), 2048, 2048, 6))
    pagerank(A, PageRankConfig(max_iterations=2, tolerance=0.0))   # plan
    torch.cuda.synchronize()
    calls = count_read_backs(monkeypatch)
    for iters in (5, 40):
        calls.clear()
        res = pagerank(A, PageRankConfig(max_iterations=iters, tolerance=0.0))
        assert calls == ["tolist"], (iters, calls)
        assert res.error_code == 0 and res.iterations == iters
    monkeypatch.undo()
    r0 = np.full(2048, 1.0 / 2048, np.float32)
    r0[5] = np.nan
    for tol in (0.0, -1.0, 1e-6):
        res = pagerank(A, PageRankConfig(max_iterations=50, tolerance=tol),
                       initial_ranks=r0)
        assert res.iterations == 1 and np.isnan(res.final_residual)
        assert np.isnan(res.ranks_host()).all()


@pytest.mark.cuda
def test_pagerank_on_card_uploads_the_mask_once(cuda_device):
    """On a column-normalised graph with dangling nodes, the second call
    takes the mask the first uploaded (its span counts 0, the cached
    tensor is the same) and gives the same ranks bit for bit."""
    from tpu_spmv_torch import profiling

    A = transition_matrix(web_graph_csr(RandomGenerator(3), 4096, 4096, 4))
    cfg = PageRankConfig(tolerance=1e-6)
    key = ("_dangling", str(cuda_device))
    profiling.clear()
    try:
        with profiling.recording():
            first = pagerank(A, cfg)
            mask = A._plan_cache[key]
            second = pagerank(A, cfg)
        counts = [s.count for s in profiling.spans()
                  if s.name == "pagerank.mask"]
    finally:
        profiling.clear()
    torch.cuda.synchronize()
    assert first.error_code == second.error_code == 0
    assert mask.device.type == "cuda" and float(mask.sum()) > 0
    assert counts == [1, 0]
    assert A._plan_cache[key].data_ptr() == mask.data_ptr()
    assert first.iterations == second.iterations
    assert torch.equal(first.ranks, second.ranks)


@pytest.mark.cuda
def test_bench_smoke_on_card(cuda_device, capsys):
    """``python -m tpu_spmv_torch.bench --smoke`` on the card: one line,
    ``correct``, STREAM measured, the winner's streamed bytes within the
    physics guard, and the card named."""
    import json

    from tpu_spmv_torch import bench

    assert bench.main(["--smoke"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    d = line["detail"]
    assert d["correct"] is True and d["stream_gb_s"] > 0
    assert line["vs_baseline"] > 0
    assert d["device"] == torch.cuda.get_device_name(0)
    assert d["winning_plan"] in d["plan_fingerprints"]
    for key in ("ell_stencil_gb_s", "web_graph_1m_gb_s",
                "pagerank_262k_ms_per_iter", "bf16_spmv_gb_s",
                "pattern_spmv_gb_s"):
        assert d[key] > 0, key
