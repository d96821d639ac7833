"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips where no CUDA device is
present (a CUDA kernel has no CPU mode).  The file imports nothing of JAX,
so it runs on a machine that has only the port installed:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest

The fold's outputs are held to the backward-error row bound
``|y - y_plain|_i <= 1e-5 * max((|A||x|)_i, 1)``: the kernel and the plain
version (``index_add_``) sum each row in different orders.  The unpermute
and the chunk permute move values without arithmetic and must match
exactly.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tpu_spmv_torch import (KernelType, SpMVConfig, spmv_auto_config,  # noqa: E402
                            spmv_csr)
from tpu_spmv_torch import kernels as tk  # noqa: E402
from tpu_spmv_torch.kernels import plan as tplan  # noqa: E402
from tpu_spmv_torch.kernels import reorder as tr  # noqa: E402
from tpu_spmv_torch.kernels import window_ell as twe  # noqa: E402
from tpu_spmv_torch.utils.testing import (RandomGenerator,  # noqa: E402
                                          abs_row_scale, scrambled_banded_csr,
                                          spmv_matches)

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
    before = twe.window_ell_fold.launches
    out = twe.window_ell_fold(plan, table)
    torch.cuda.synchronize()
    assert twe.window_ell_fold.launches - before == len(plan.sections)
    y = rows_of(out, plan)
    y_ref = rows_of(twe.window_ell_fold_plain(plan, table), plan)
    bound = ROW_TOL * np.maximum(abs_row_scale(A, x), 1.0)
    assert np.all(np.abs(y - y_ref) <= bound)
    assert spmv_matches(y, A, x, rel_tol=ROW_TOL)


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
