"""The port's differential soak (``tpu_spmv_torch.soak``) on the CPU, and the
last public names of the JAX package that the port gained, each against
the JAX function on the same inputs.

The soak runs its own paths against the CPU oracle with ``--cpu`` (the
kernels' plain versions); a path made to give a wrong output must fail it,
and without a card and without ``--cpu`` it exits 2.  Its matrices are the
JAX soak's (``benchmarks/soak.py``) and its fuzz structures the JAX fuzz
slice's (``tests/test_fuzz.py``), array for array, from the same seeds.
"""

import importlib.util
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import tpu_spmv  # noqa: E402
import tpu_spmv.utils as jutils  # noqa: E402
from tpu_spmv.bandwidth import get_tpu_peak_bandwidth  # noqa: E402
from tpu_spmv.utils.testing import RandomGenerator as JaxRandom  # noqa: E402

import tpu_spmv_torch  # noqa: E402
import tpu_spmv_torch.utils as tutils  # noqa: E402
from tpu_spmv_torch import (ELLMatrix, KernelType,  # noqa: E402
                            get_gpu_peak_bandwidth, native, soak)
from tpu_spmv_torch.utils.testing import RandomGenerator  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, os.path.join(ROOT,
                                                                     path))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def same_csr(a, b) -> None:
    assert (a.num_rows, a.num_cols) == (b.num_rows, b.num_cols)
    for name in ("values", "col_indices", "row_ptrs"):
        x, y = np.asarray(getattr(a, name)), np.asarray(getattr(b, name))
        assert np.array_equal(x, y), name


# ---- the soak ----

def test_soak_on_cpu_passes(capsys):
    assert soak.main(["--trials", "4", "--seed", "0", "--cpu"]) == 0
    out = capsys.readouterr().out
    assert "FAIL" not in out
    last = out.strip().splitlines()[-1]
    assert last.startswith("soak: 4 trials, ") and " 0 failures" in last


def test_soak_reports_a_wrong_path(monkeypatch, capsys):
    """SCALAR_CSR's output perturbed: the soak prints its ``FAIL`` line with
    the JAX soak's fields and exits 1."""
    real = soak.spmv_csr

    def perturbed(A, x, config=None, **kw):
        res = real(A, x, config, **kw)
        if config.kernel_type == KernelType.SCALAR_CSR and A.nnz:
            res.y = res.y + 1.0
        return res

    monkeypatch.setattr(soak, "spmv_csr", perturbed)
    assert soak.main(["--trials", "1", "--seed", "0", "--cpu"]) == 1
    out = capsys.readouterr().out
    fails = [line for line in out.splitlines() if line.startswith("FAIL")]
    assert len(fails) == 1
    assert fails[0].startswith("FAIL trial=0 kind=") \
        and "kernel=SCALAR_CSR" in fails[0] and " err=0" in fails[0]
    assert "1 failures" in out.strip().splitlines()[-1]


def test_soak_without_a_card_exits_2(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert soak.main(["--trials", "1"]) == 2
    assert "--cpu" in capsys.readouterr().err


def test_soak_restores_the_leveling_setting(monkeypatch):
    monkeypatch.setenv("TPU_SPMV_PERMUTE_ROWS", "keep")
    soak.run(1, 3, "cpu")
    assert os.environ["TPU_SPMV_PERMUTE_ROWS"] == "keep"


@pytest.mark.parametrize("kind", soak.KINDS)
def test_soak_matrices_equal_the_jax_soak(kind):
    jsoak = load("benchmarks/soak.py", "jax_soak")
    rows, cols = 700, 900
    a = soak.make_matrix(np.random.default_rng(11), kind, rows, cols)
    b = jsoak.make_matrix(np.random.default_rng(11), kind, rows, cols)
    same_csr(a, b)


@pytest.mark.parametrize("kind", range(5))
def test_fuzz_matrix_equals_the_jax_fuzz_structure(kind):
    jfuzz = load("tests/test_fuzz.py", "jax_fuzz")
    for rows, cols in ((1, 1), (300, 1100), (2100, 150)):
        a = soak.fuzz_matrix(np.random.default_rng(rows), kind, rows, cols)
        b = jfuzz._matrix(np.random.default_rng(rows), kind, rows, cols)
        same_csr(a, b)


# ---- the last public names ----

def test_version_is_the_jax_packages():
    assert tpu_spmv_torch.__version__ == tpu_spmv.__version__


def test_utils_export_the_jax_names():
    assert set(jutils.__all__) <= set(tutils.__all__)


@pytest.mark.parametrize("seed", [42, 7])
def test_generators_give_the_jax_arrays(seed):
    dense = tutils.generate_random_dense_matrix(RandomGenerator(seed), 40, 30,
                                                0.2)
    jdense = jutils.generate_random_dense_matrix(JaxRandom(seed), 40, 30, 0.2)
    assert dense.dtype == jdense.dtype and np.array_equal(dense, jdense)
    v = tutils.generate_random_vector(RandomGenerator(seed), 50)
    jv = jutils.generate_random_vector(JaxRandom(seed), 50)
    assert v.dtype == jv.dtype and np.array_equal(v, jv)
    same_csr(tutils.generate_random_csr(RandomGenerator(seed), 33, 17, 0.3),
             jutils.generate_random_csr(JaxRandom(seed), 33, 17, 0.3))


COMPARED = [
    ([1.0, 2.0], [1.0, 2.0], {}),
    ([1.0, 2.0], [1.0, 2.0000005], {}),
    ([1.0, 2.0], [1.0, 2.001], {}),
    ([1.0, 2.0], [1.0, 2.001], {"tol": 1e-3}),
    ([1e6], [1e6 + 0.5], {}),
    ([0.0], [5e-7], {}),
    ([1.0, 2.0], [1.0], {}),
    ([np.nan], [np.nan], {}),
]


@pytest.mark.parametrize("a, b, kw", COMPARED)
def test_float_arrays_equal_as_jax(a, b, kw):
    assert tutils.float_arrays_equal(a, b, **kw) \
        == jutils.float_arrays_equal(a, b, **kw)


@pytest.mark.parametrize("a, b", [([1, 2, 3], [1, 2, 3]), ([1, 2, 3],
                                                            [1, 2, 4]),
                                  ([1, 2], [1, 2, 3]), ([], [])])
def test_int_arrays_equal_as_jax(a, b):
    assert tutils.int_arrays_equal(a, b) == jutils.int_arrays_equal(a, b)


def test_available_agrees_with_require(monkeypatch):
    if native.available():
        native.require()
    else:
        with pytest.raises(RuntimeError):
            native.require()
    monkeypatch.setenv("TPU_SPMV_NO_NATIVE", "1")
    assert not native.available()
    with pytest.raises(RuntimeError):
        native.require()


def test_delete_empties_the_device_forms():
    A = RandomGenerator(3).csr(20, 12, 0.3)
    dev = A.to_device("cpu")
    assert not dev.deleted and dev.values.numel() == A.nnz
    dev.delete()
    assert dev.deleted
    assert (dev.values, dev.col_indices, dev.row_ptrs) == (None, None, None)
    again = A.to_device("cpu")
    assert again is not dev and torch.equal(
        again.values, torch.from_numpy(A.values))
    E = ELLMatrix.from_csr(A)
    edev = E.to_device("cpu")
    edev.delete()
    assert edev.deleted and (edev.values, edev.col_indices) == (None, None)
    assert not E.to_device("cpu").deleted


def test_deleted_form_is_uploaded_again_for_the_flat_path():
    """ELL_KERNEL on a CSR runs the flat path on the matrix's cached device
    form: a deleted one is uploaded again, and the SpMV is right."""
    from tpu_spmv_torch import SpMVConfig, spmv_csr
    from tpu_spmv_torch.utils.testing import spmv_matches

    A = RandomGenerator(4).csr(64, 48, 0.2)
    x = RandomGenerator(5).vector(48)
    cfg = SpMVConfig(kernel_type=KernelType.ELL_KERNEL)
    first = spmv_csr(A, x, cfg, device="cpu")
    assert first.error_code == 0 and first.plan is A.to_device("cpu")
    first.plan.delete()
    res = spmv_csr(A, x, cfg, device="cpu")
    assert res.error_code == 0 and not res.plan.deleted
    assert spmv_matches(res.y_host(), A, x, rel_tol=1e-5)


def test_peak_override_wins(monkeypatch):
    """``TPU_SPMV_PEAK_GBS`` is read before the card's attributes, as the
    JAX package reads it before its table; no card is touched."""
    monkeypatch.setattr(torch.cuda, "init", lambda: pytest.fail(
        "the card was asked"))
    monkeypatch.setenv("TPU_SPMV_PEAK_GBS", "2048.5")
    assert get_gpu_peak_bandwidth() == get_tpu_peak_bandwidth() == 2048.5
