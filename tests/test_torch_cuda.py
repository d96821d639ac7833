"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips where no CUDA device is
present (a CUDA kernel has no CPU mode).  The file imports nothing of JAX,
so it runs on a machine that has only the port installed:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest

The fold's outputs are held to the backward-error row bound
``|y - y_plain|_i <= 1e-5 * max((|A||x|)_i, 1)``: the kernel and the plain
version (``index_add_``) sum each row in different orders.  The unpermute
and the chunk permute move values without arithmetic and must match
exactly.  The benchmark probes' kernels are held to ``rtol=1e-5`` with
``atol = 1e-5 * max|ref|``: fp32 sums in another order, and in P1, P2 and
P3 atomic adds in no fixed order.  PageRank on the card is held to a float64
power iteration at ``rtol=1e-4, atol=1e-7``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tpu_spmv_torch import (  # noqa: E402
    KernelType, PageRankConfig, SpMVConfig, pagerank, spmv_auto_config,
    spmv_csr)
from tpu_spmv_torch import kernels as tk  # noqa: E402
from tpu_spmv_torch.probes import profile_dma_share as p5  # noqa: E402
from tpu_spmv_torch.probes import profile_kernel as p4  # noqa: E402
from tpu_spmv_torch.probes import proto_v2 as p1  # noqa: E402
from tpu_spmv_torch.probes import proto_v3 as p2  # noqa: E402
from tpu_spmv_torch.probes import proto_v4 as p3  # noqa: E402
from tpu_spmv_torch.kernels import plan as tplan  # noqa: E402
from tpu_spmv_torch.kernels import reorder as tr  # noqa: E402
from tpu_spmv_torch.kernels import window_ell as twe  # noqa: E402
from tpu_spmv_torch.spmv import PatternPlan  # noqa: E402
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
    assert counts["unpermute"] == 1
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
        "unpermute": int(res.plan.inner.lam is not None),
        "permute_chunks": 2}
    assert spmv_matches(res.y.cpu().numpy(), A, x, rel_tol=ROW_TOL)


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
    assert counts["unpermute"] == (30 if plan.lam is not None else 0)
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
