"""The port's slice end to end against the JAX package: ``spmv_csr`` with the
auto-selected configuration, error codes, unported routes, the selector, the
stream-byte model, and the port's independence from JAX.

The JAX dispatch builds its plans with the JAX planner, which needs the port's
copy of ``_absorb_run_padding`` bound into its module for the test's
duration.  The two dispatches pick different step widths (the JAX one resolves
8 under interpret mode, the port 256), so their plans differ in padding and
their outputs are compared under the row bound
``|y_port - y_jax|_i <= 1e-5 * max((|A||x|)_i, 1)``.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import tpu_spmv  # noqa: E402
import tpu_spmv.kernels.window_ell as jwe  # noqa: E402
from tpu_spmv.csr import CSRMatrix as JaxCSRMatrix  # noqa: E402

import tpu_spmv_torch  # noqa: E402
from tpu_spmv_torch import KernelType, SpMVConfig, SpMVError  # noqa: E402
from tpu_spmv_torch.kernels import plan as tplan  # noqa: E402
from tpu_spmv_torch.kernels import window_ell as twe  # noqa: E402
from tpu_spmv_torch.utils.testing import (RandomGenerator,  # noqa: E402
                                          abs_row_scale, spmv_matches)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROW_TOL = 1e-5


@pytest.fixture
def absorb_helper(monkeypatch):
    monkeypatch.setattr(jwe, "_absorb_run_padding",
                        tplan._absorb_run_padding, raising=False)


@pytest.fixture(scope="module")
def smoke():
    A = RandomGenerator(42).power_law_csr(8192, 2048, 12.0, 1.6)
    x = RandomGenerator(7).vector(A.num_cols)
    return A, x


def to_jax_csr(A):
    return JaxCSRMatrix(A.num_rows, A.num_cols, A.values, A.col_indices,
                        A.row_ptrs)


@pytest.mark.parametrize("kernel_type", ["auto", "VECTOR_CSR"])
def test_spmv_csr_matches_jax(smoke, absorb_helper, kernel_type):
    A, x = smoke
    cfg = tpu_spmv_torch.spmv_auto_config(A)
    jcfg = tpu_spmv.spmv_auto_config(to_jax_csr(A))
    if kernel_type != "auto":
        cfg.kernel_type = KernelType[kernel_type]
        jcfg.kernel_type = tpu_spmv.KernelType[kernel_type]
    res = tpu_spmv_torch.spmv_csr(A, x, cfg, device="cpu")
    jres = tpu_spmv.spmv_csr(to_jax_csr(A), x, jcfg)
    assert res.error_code == 0 == jres.error_code
    y, y_jax = res.y_host(), np.asarray(jres.y)
    assert y.shape == y_jax.shape == (A.num_rows,)
    bound = ROW_TOL * np.maximum(abs_row_scale(A, x), 1.0)
    assert np.all(np.abs(y - y_jax) <= bound)
    assert spmv_matches(y, A, x, rel_tol=ROW_TOL)
    assert res.plan.sup == 1024 and res.plan.device.type == "cpu"


def test_spmv_csr_accepts_tensors_and_caches_plans(smoke):
    A, x = smoke
    A = tpu_spmv_torch.CSRMatrix(A.num_rows, A.num_cols, A.values,
                                 A.col_indices, A.row_ptrs)  # fresh cache
    cfg = SpMVConfig(kernel_type=KernelType.MERGE_PATH)
    first = tpu_spmv_torch.spmv_csr(A, torch.from_numpy(x), cfg,
                                    device="cpu")
    second = tpu_spmv_torch.spmv_csr(A, x, cfg, device="cpu")
    assert first.plan is second.plan
    assert second.plan_seconds < first.plan_seconds
    assert torch.equal(first.y, second.y)


def test_error_codes_match_jax(smoke):
    A, x = smoke
    jA = to_jax_csr(A)
    cases = [
        (None, x, {}), (A, None, {}),
        (A, x[:-1], {}), (A, np.zeros(A.num_cols + 3, np.float32), {}),
        (A, x.reshape(-1, 2), {}), (A, x, {"vec_size": A.num_cols - 1}),
    ]
    for M, v, kw in cases:
        port = tpu_spmv_torch.spmv_csr(M, v, **kw).error_code
        ref = tpu_spmv.spmv_csr(jA if M is not None else None, v,
                                **kw).error_code
        assert port == ref != 0, (port, ref)
    assert tpu_spmv_torch.spmv_csr(None, x).error_code \
        == SpMVError.INVALID_ARGUMENT
    assert tpu_spmv_torch.spmv_csr(A, x[:-1]).error_code \
        == SpMVError.INVALID_DIMENSION


def test_unported_routes_raise(smoke, absorb_helper):
    """The routes that raised before they were ported are served now, by the
    JAX dispatch's plan types, and match it and the oracle (the test keeps
    its name): SCALAR_CSR's naive plan, the flat path for ELL_KERNEL and
    for ``use_vmem_x=False``, the composite past one gather table and the
    column strips past ``PACKED_MAX_COLS``."""
    from tpu_spmv_torch import DeviceCSR
    from tpu_spmv_torch.kernels.strips import StripPlan

    A, x = smoke
    jA = to_jax_csr(A)
    bound = ROW_TOL * np.maximum(abs_row_scale(A, x), 1.0)
    routes = [
        (dict(kernel_type=KernelType.SCALAR_CSR), twe.WindowEllPlan),
        (dict(kernel_type=KernelType.ELL_KERNEL), DeviceCSR),
        (dict(kernel_type=KernelType.MERGE_PATH, use_vmem_x=False),
         DeviceCSR),
    ]
    for kw, kind in routes:
        res = tpu_spmv_torch.spmv_csr(A, x, SpMVConfig(**kw), device="cpu")
        jres = tpu_spmv.spmv_csr(jA, x, tpu_spmv.SpMVConfig(**{
            k: tpu_spmv.KernelType(int(v)) if k == "kernel_type" else v
            for k, v in kw.items()}))
        assert res.error_code == 0 == jres.error_code
        assert isinstance(res.plan, kind), kw
        assert kind is DeviceCSR or res.plan.n_extra == 0   # naive plan
        assert np.all(np.abs(res.y_host() - np.asarray(jres.y)) <= bound)
        assert spmv_matches(res.y_host(), A, x, rel_tol=ROW_TOL)
    for cols, kind in (((1 << 20) + 1, twe.CompositePlan),
                       ((1 << 21) + 1, StripPlan)):
        wide = tpu_spmv_torch.CSRMatrix(4, cols, np.ones(2, np.float32),
                                        np.array([0, cols - 1], np.int32),
                                        np.array([0, 1, 2, 2, 2], np.int32))
        xw = RandomGenerator(5).vector(cols)
        res = tpu_spmv_torch.spmv_csr(
            wide, xw, SpMVConfig(kernel_type=KernelType.VECTOR_CSR),
            device="cpu")
        jres = tpu_spmv.spmv_csr(
            to_jax_csr(wide), xw,
            tpu_spmv.SpMVConfig(kernel_type=tpu_spmv.KernelType.VECTOR_CSR))
        assert res.error_code == 0 == jres.error_code
        assert isinstance(res.plan, kind)
        wbound = ROW_TOL * np.maximum(abs_row_scale(wide, xw), 1.0)
        assert np.all(np.abs(res.y_host() - np.asarray(jres.y)) <= wbound)
        assert spmv_matches(res.y_host(), wide, xw, rel_tol=ROW_TOL)
    # the pattern fast path and bf16 value streams are served (ROADMAP M7's
    # pattern and bf16 parts are ported): a column-scaled matrix on a pattern
    # plan, the smoke matrix on a bf16 plan, each held against the oracle
    from tpu_spmv_torch.spmv import PatternPlan

    svals = RandomGenerator(3).rng.uniform(0.5, 2.0, A.num_cols) \
        .astype(np.float32)
    scaled = tpu_spmv_torch.CSRMatrix(A.num_rows, A.num_cols,
                                      svals[A.col_indices], A.col_indices,
                                      A.row_ptrs)
    pat = tpu_spmv_torch.spmv_csr(scaled, x, SpMVConfig(
        kernel_type=KernelType.MERGE_PATH, pattern=True), device="cpu")
    assert pat.error_code == 0 and isinstance(pat.plan, PatternPlan)
    assert spmv_matches(pat.y_host(), scaled, x, rel_tol=ROW_TOL)
    bf16 = tpu_spmv_torch.spmv_csr(A, x, SpMVConfig(
        kernel_type=KernelType.VECTOR_CSR, bf16_values=True), device="cpu")
    assert bf16.error_code == 0 and bf16.plan.values == "bfloat16"
    assert spmv_matches(bf16.y_host(), A, x, rel_tol=8e-3)
    # forced block reordering is served (ROADMAP M8 is ported), by the same
    # route as the JAX dispatch
    from tpu_spmv.kernels.reorder import ReorderedPlan as JaxReorderedPlan

    from tpu_spmv_torch.kernels.reorder import ReorderedPlan

    square = RandomGenerator(1).power_law_csr(4096, 4096, 20.0, 1.6)
    xs = RandomGenerator(2).vector(4096)
    res = tpu_spmv_torch.spmv_csr(
        square, xs, SpMVConfig(kernel_type=KernelType.MERGE_PATH,
                               reorder=True), device="cpu")
    jsquare = to_jax_csr(square)
    jres = tpu_spmv.spmv_csr(jsquare, xs, tpu_spmv.SpMVConfig(
        kernel_type=tpu_spmv.KernelType.MERGE_PATH, reorder=True))
    assert res.error_code == 0 == jres.error_code
    _, jplan = jsquare._plan_cache[(int(KernelType.MERGE_PATH), None, False,
                                    True)]
    assert isinstance(res.plan, ReorderedPlan) \
        == isinstance(jplan, JaxReorderedPlan)
    y = res.y_host()
    bound = ROW_TOL * np.maximum(abs_row_scale(square, xs), 1.0)
    assert np.all(np.abs(y - np.asarray(jres.y)) <= bound)
    assert spmv_matches(y, square, xs, rel_tol=ROW_TOL)


@pytest.mark.parametrize("shape", [(8192, 2048, 12.0, 1.6),
                                   (500, 300, 0.02, 1.5),
                                   (600, 600, 30.0, 8.0)])
def test_selector_matches_jax(shape):
    A = RandomGenerator(11).power_law_csr(*shape)
    port, ref = tpu_spmv_torch.spmv_auto_config(A), \
        tpu_spmv.spmv_auto_config(to_jax_csr(A))
    assert (int(port.kernel_type), port.block_size, port.use_vmem_x) \
        == (int(ref.kernel_type), ref.block_size, ref.use_vmem_x)


def test_selector_picks_vector_on_uniform_rows():
    dense = np.ones((64, 64), np.float32)
    A = tpu_spmv_torch.CSRMatrix.from_dense(dense)
    assert tpu_spmv_torch.spmv_auto_config(A).kernel_type \
        == tpu_spmv.spmv_auto_config(to_jax_csr(A)).kernel_type \
        == KernelType.VECTOR_CSR


@pytest.mark.parametrize("leveled", [False, True])
def test_stream_bytes_match_jax(smoke, absorb_helper, leveled):
    A, _ = smoke
    kw = dict(split_rows=128, step_groups=16, permute_rows=leveled)
    jp = jwe.WindowEllPlan.build(A, **kw)
    plan = twe.plan_from_host(tplan.build(A, **kw), "cpu")
    assert plan.stream_bytes == jp.stream_bytes


def test_csr_byte_model_matches_jax():
    from tpu_spmv.bandwidth import compute_bandwidth_csr as jax_bw

    from tpu_spmv_torch.bandwidth import compute_bandwidth_csr

    ref = jax_bw(262144, 4096, 10_300_000, 0.2)
    got = compute_bandwidth_csr(262144, 4096, 10_300_000, 0.2, 819.0)
    assert got.achieved_gb_s == ref.achieved_gb_s


@pytest.mark.parametrize("error, expected", [
    (lambda: torch.cuda.OutOfMemoryError("CUDA out of memory"),
     tpu_spmv_torch.errors.DeviceAllocError),
    (lambda: RuntimeError("CUDA error: an illegal memory access"),
     tpu_spmv_torch.errors.DeviceTransferError),
    (lambda: MemoryError("host"), tpu_spmv_torch.errors.OutOfMemoryError),
])
def test_guarded_upload_maps_copy_errors(monkeypatch, error, expected):
    def failing_to(self, *args, **kwargs):
        raise error()

    monkeypatch.setattr(torch.Tensor, "to", failing_to)
    with pytest.raises(expected):
        tpu_spmv_torch.errors.guarded_upload(np.zeros(4, np.float32), "cpu")


def test_guarded_upload_failure_becomes_error_code(smoke, monkeypatch):
    A, x = smoke

    def oom(self, *args, **kwargs):
        raise torch.cuda.OutOfMemoryError("CUDA out of memory")

    monkeypatch.setattr(torch.Tensor, "to", oom)
    res = tpu_spmv_torch.spmv_csr(A, x, SpMVConfig(
        kernel_type=KernelType.MERGE_PATH), device="cpu")
    assert res.error_code == SpMVError.DEVICE_ALLOC and res.y is None


@pytest.mark.parametrize("x_kind", ["array", "cpu tensor"])
def test_entry_points_default_to_the_card(smoke, monkeypatch, x_kind):
    """With no device named, ``spmv_csr`` and ``pagerank`` run on the card,
    whatever x is: where there is none they return ``DEVICE_ALLOC`` and
    never run on the CPU.  The plan builders default to the card too."""
    import inspect

    from tpu_spmv_torch.kernels import reorder as tr

    A, x = smoke
    A = tpu_spmv_torch.CSRMatrix(A.num_rows, A.num_cols, A.values,
                                 A.col_indices, A.row_ptrs)  # fresh cache
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    xv = x if x_kind == "array" else torch.from_numpy(x)
    cfg = SpMVConfig(kernel_type=KernelType.MERGE_PATH)
    res = tpu_spmv_torch.spmv_csr(A, xv, cfg)
    assert res.error_code == SpMVError.DEVICE_ALLOC and res.y is None
    assert not A._plan_cache            # nothing was planned or uploaded
    square = RandomGenerator(4).power_law_csr(300, 300, 6.0, 1.5)
    pr = tpu_spmv_torch.pagerank(square)
    assert pr.error_code == SpMVError.DEVICE_ALLOC and pr.ranks is None
    assert tpu_spmv_torch.spmv_csr(A, xv, cfg, device="cpu").error_code \
        == 0 == tpu_spmv_torch.pagerank(square, device="cpu").error_code
    for fn in (twe.plan_from_arrays, twe.plan_from_host,
               tr.reordered_from_arrays, tr.reordered_from_host,
               tr.build_reordered):
        assert inspect.signature(fn).parameters["device"].default == "cuda"


def test_import_does_not_load_jax():
    code = ("import sys, tpu_spmv_torch, tpu_spmv_torch.kernels.window_ell, "
            "tpu_spmv_torch.pagerank, tpu_spmv_torch.probes.proto_v2, "
            "tpu_spmv_torch.cli, tpu_spmv_torch.plan_io, tpu_spmv_torch.ell, "
            "tpu_spmv_torch.benchmark, tpu_spmv_torch.io.matrix_market, "
            "tpu_spmv_torch.kernels.ell_kernel, tpu_spmv_torch.bench, "
            "tpu_spmv_torch.benchmarks.scaling; "
            "bad = [m for m in sys.modules if m in ('jax', 'tpu_spmv') or "
            "m.startswith(('jax.', 'tpu_spmv.'))]; "
            "assert not bad, bad")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_no_port_source_names_jax():
    """No module of the port, nor ``chip_smoke.py``, imports JAX or the JAX
    package, not even inside a function."""
    import glob
    import re

    files = [f for f in glob.glob(os.path.join(ROOT, "tpu_spmv_torch", "**",
                                               "*.py"), recursive=True)
             if os.sep + "_build" + os.sep not in f] \
        + [os.path.join(ROOT, "chip_smoke.py"),
           os.path.join(ROOT, "chip_profile.py")]
    pattern = re.compile(r"^\s*(import|from)\s+(jax|tpu_spmv)(\.|\s|$)",
                         re.M)
    bad = [f for f in files if pattern.search(open(f).read())]
    assert len(files) > 20 and not bad, bad


def test_builds_compile_only_the_ports_own_sources(monkeypatch, tmp_path):
    """Every source the port's two builds compile (the planner library and
    the CUDA kernels) lies under ``tpu_spmv_torch/``: the commands are
    captured, not run."""
    from tpu_spmv_torch.kernels import _build
    from tpu_spmv_torch.native import build as nbuild

    cmds = []

    def capture(name, sources, command, compiles=None):
        out = str(tmp_path / name)
        cmds.extend((compiles(out) if compiles else []) + [command(out)])
        cmds.append(list(sources))
        return out

    monkeypatch.setattr(_build, "build_library", capture)
    monkeypatch.setattr(nbuild, "build_library", capture)
    monkeypatch.setattr(_build, "nvcc_path", lambda: "nvcc")
    nbuild.build()
    _build.build_kernels()
    pkg = os.path.join(ROOT, "tpu_spmv_torch") + os.sep
    sources = [a for c in cmds for a in c
               if a.endswith((".cc", ".cu", ".cuh"))]
    assert any(a.endswith("native.cc") for a in sources)
    assert any(a.endswith("window_ell.cu") for a in sources)
    assert sources and all(os.path.abspath(a).startswith(pkg)
                           for a in sources), sources


def test_chip_smoke_refuses_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; chip_smoke.py would run")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    lines = proc.stdout.strip().splitlines()
    assert not lines or '"ok": true' not in lines[-1]
