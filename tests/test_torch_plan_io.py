"""The port's plan files (``tpu_spmv_torch/plan_io.py``) against the JAX
package's format (``tpu_spmv/plan_io.py``).

Round trips of every plan kind on the CPU device: the loaded plan's arrays
equal the saved plan's (the fold schedule derived again from them) and its
output is the saved plan's bit for bit.  Then files crossing the packages
both ways: a plan the JAX package saves loads in the port with the JAX
plan's arrays, and gives the JAX output within the row bound
``|Δy|_i <= 1e-5 * max((|A||x|)_i, 1)``; a plan the port saves loads in the
JAX package and gives the port's output within that bound.  Then the error
cases of ``tests/test_plan_io.py`` and the legacy ``tb`` default.

The JAX planner calls ``_absorb_run_padding``, which its module does not
define; the tests bind the port's copy into the JAX module for their
duration (``monkeypatch``), so no file of the JAX package changes.
"""

import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import tpu_spmv.kernels.reorder as jr  # noqa: E402
import tpu_spmv.kernels.strips as jst  # noqa: E402
import tpu_spmv.kernels.window_ell as jwe  # noqa: E402
from tpu_spmv import plan_io as jio  # noqa: E402
from tpu_spmv.csr import CSRMatrix as JaxCSRMatrix  # noqa: E402

from tpu_spmv_torch import CSRMatrix, load_plan, save_plan  # noqa: E402
from tpu_spmv_torch.errors import (DeviceAllocError,  # noqa: E402
                                   FileIOError, InvalidFormatError)
from tpu_spmv_torch.kernels import plan as tplan  # noqa: E402
from tpu_spmv_torch.kernels import upload  # noqa: E402
from tpu_spmv_torch.kernels import reorder as tr  # noqa: E402
from tpu_spmv_torch.kernels import strips as tst  # noqa: E402
from tpu_spmv_torch.kernels import window_ell as twe  # noqa: E402
from tpu_spmv_torch.spmv import run_plan  # noqa: E402
from tpu_spmv_torch.utils.testing import (RandomGenerator,  # noqa: E402
                                          abs_row_scale, spmv_matches,
                                          web_graph_csr)

ROW_TOL = 1e-5
CPU = "cpu"
# the step width of the port's plans here: the JAX package's under
# interpret mode, where its kernels run these plans eight times faster
# than at the port's default of 256
S = 8


@pytest.fixture
def absorb_helper(monkeypatch):
    monkeypatch.setattr(jwe, "_absorb_run_padding",
                        tplan._absorb_run_padding, raising=False)


def to_jax(A):
    return JaxCSRMatrix(A.num_rows, A.num_cols, A.values, A.col_indices,
                        A.row_ptrs)


def power_law():
    return RandomGenerator(42).power_law_csr(1500, 900, 10.0, 1.6)


def square():
    return RandomGenerator(43).power_law_csr(2048, 2048, 8.0, 1.6)


def unit(A):
    return CSRMatrix(A.num_rows, A.num_cols, np.ones(A.nnz, np.float32),
                     A.col_indices, A.row_ptrs)


def split_composite(A):
    """A composite with a flat tail: a level plan of every other nonzero
    and the rest as the tail (``y = level(x) + tail(x)``)."""
    keep = np.arange(A.nnz) % 2 == 0
    rows_of = np.repeat(np.arange(A.num_rows), np.diff(A.row_ptrs))
    level, tail = (tplan._subset_csr(A, rows_of, m) for m in (keep, ~keep))
    return tplan.HostComposite((tplan.build(level, split_rows=128,
                                            step_groups=S),), tail,
                               A.num_rows, A.num_cols)


def banded_strips(A):
    """Two column strips of ``A``, the first a banded stack."""
    half = A.num_cols // 2
    s0, s1 = tst._slice_cols(A, 0, half), tst._slice_cols(A, half,
                                                          A.num_cols)
    return tst.HostStrips((tplan.build_banded(s0, sup=1024, n_bands=2,
                                              step_groups=S),
                           tplan.build(s1, step_groups=S)), A.num_rows,
                          A.num_cols,
                          ((0, half), (half, A.num_cols)))


def reordered_banded(A):
    order = tr.block_order(A)
    inner = tplan.build_banded(tr.permute_csr(A, order), sup=1024,
                               n_bands=2, step_groups=S)
    return tr.reordered_from_host(inner, order, A.num_rows, A.num_cols, CPU)


# kind: (matrix, device plan, the matrix its SpMV computes)
KINDS = {
    "f32": (power_law, lambda A: twe.plan_from_host(
        tplan.build(A, split_rows=128, step_groups=S), CPU), None),
    "bf16": (power_law, lambda A: twe.plan_from_host(
        tplan.build(A, split_rows=128, step_groups=S,
                    values_dtype="bfloat16"), CPU), None),
    "pattern": (power_law, lambda A: twe.plan_from_host(
        tplan.build(A, split_rows=128, step_groups=S, pattern=True), CPU),
                unit),
    "leveled": (power_law, lambda A: twe.plan_from_host(
        tplan.build(A, split_rows=128, step_groups=S, permute_rows=True), CPU),
                None),
    "banded": (lambda: web_graph_csr(RandomGenerator(42), 6000, 2100,
                                     avg_nnz=9),
               lambda A: upload(tplan.build_banded(
                   A, sup=1024, n_bands=3, spill_beta=2.6, step_groups=S),
                   CPU), None),
    "composite": (power_law, lambda A: upload(split_composite(A), CPU),
                  None),
    "strips": (lambda: web_graph_csr(RandomGenerator(42), 3000, 4096,
                                     avg_nnz=9),
               lambda A: tst.strips_from_host(banded_strips(A), CPU), None),
    "reordered": (square, lambda A: tr.build_reordered(A, step_groups=S,
                                                       device=CPU), None),
    "reordered banded": (square, reordered_banded, None),
}


def leaves_of(plan) -> list:
    """Every tensor of a device plan, in a fixed order, and its static
    fields."""
    if isinstance(plan, (twe.BandedPlan, twe.CompositePlan, tst.StripPlan)):
        out = [(plan.num_rows, plan.num_cols)]
        for p in plan.plans:
            out += leaves_of(p)
        tail = getattr(plan, "tail", None)
        if tail is not None:
            out += [tail.values, tail.col_indices, tail.row_ptrs]
        return out + [getattr(plan, "band_rows", None),
                      getattr(plan, "bounds", None)]
    if isinstance(plan, tr.ReorderedPlan):
        return [plan.col_src, plan.row_src, plan.num_rows, plan.num_cols] \
            + leaves_of(plan.inner)
    return [getattr(plan, k) for k in tplan.LEAVES] \
        + [getattr(plan, k) for k in tplan.AUX] + [plan.occupancy] \
        + [f for s in plan.sections for f in dataclasses.astuple(s)]


def assert_same(a, b):
    la, lb = leaves_of(a), leaves_of(b)
    assert len(la) == len(lb)
    for u, v in zip(la, lb):
        if isinstance(u, torch.Tensor):
            assert u.dtype == v.dtype and torch.equal(u, v)
        else:
            assert u == v


@pytest.mark.parametrize("kind", list(KINDS))
def test_round_trip_is_bit_identical(kind, tmp_path):
    make, plan_of, computes = KINDS[kind]
    A = make()
    plan = plan_of(A)
    path = str(tmp_path / "plan.npz")
    plan.save(path)
    loaded = type(plan).load(path, CPU)
    assert type(loaded) is type(plan)
    assert_same(plan, loaded)
    x = torch.from_numpy(RandomGenerator(7).vector(A.num_cols))
    y = run_plan(plan, x)
    assert torch.equal(y, run_plan(loaded, x))
    tol = 8e-3 if kind == "bf16" else ROW_TOL
    assert spmv_matches(y.numpy(), (computes or (lambda M: M))(A),
                        x.numpy(), rel_tol=tol)


HOST_KINDS = {
    "HostPlan bf16": (power_law, lambda A: tplan.build(
        A, split_rows=128, values_dtype="bfloat16")),
    "HostBanded": (power_law, lambda A: tplan.build_banded(A, sup=1024,
                                                           n_bands=2)),
    "HostComposite": (power_law, split_composite),
    "HostStrips": (lambda: web_graph_csr(RandomGenerator(42), 3000, 4096,
                                         avg_nnz=9), banded_strips),
}


@pytest.mark.parametrize("kind", list(HOST_KINDS))
def test_host_plan_saves_as_its_upload(kind, tmp_path):
    make, host_of = HOST_KINDS[kind]
    A = make()
    host = host_of(A)
    path = str(tmp_path / "host.npz")
    save_plan(host, path)
    up = tst.strips_from_host(host, CPU) if kind == "HostStrips" \
        else upload(host, CPU)
    loaded = load_plan(path, CPU)
    assert_same(up, loaded)
    x = torch.from_numpy(RandomGenerator(7).vector(A.num_cols))
    assert torch.equal(run_plan(up, x), run_plan(loaded, x))


def assert_row_bound(y, y_ref, A, x):
    diff = np.abs(np.asarray(y, np.float32) - np.asarray(y_ref, np.float32))
    bound = ROW_TOL * np.maximum(abs_row_scale(A, x), 1.0)
    assert np.all(diff <= bound), float(np.max(diff - bound))


def jax_plans():
    """kind: (matrix, JAX plan, its SpMV, the matrix it computes)."""
    A, S = power_law(), square()
    web = web_graph_csr(RandomGenerator(42), 6000, 2100, avg_nnz=9)
    jA, jS = to_jax(A), to_jax(S)
    fn, jrp = jr.build_reordered(jS)
    return {
        "f32": (A, jwe.WindowEllPlan.build(jA, split_rows=128,
                                           permute_rows=True),
                jwe.spmv_window_ell, A),
        "bf16": (A, jwe.WindowEllPlan.build(jA, split_rows=128,
                                            values_dtype=jnp.bfloat16),
                 jwe.spmv_window_ell, A),
        "pattern": (A, jwe.WindowEllPlan.build(jA, pattern=True),
                    jwe.spmv_window_ell, unit(A)),
        "banded": (web, jwe.build_banded(to_jax(web), sup=1024, n_bands=3,
                                         spill_beta=2.6),
                   jwe.spmv_banded, web),
        "composite": (A, jwe.build_composite(jA), jwe.spmv_composite, A),
        "reordered": (S, jrp, fn, S),
    }


@pytest.mark.parametrize("kind", ["f32", "bf16", "pattern", "banded",
                                  "composite", "reordered"])
def test_jax_file_loads_in_the_port(absorb_helper, kind, tmp_path):
    A, jplan, jfn, computes = jax_plans()[kind]
    path = str(tmp_path / "jax.npz")
    jio.save_plan(jplan, path)
    plan = load_plan(path, CPU)
    x = RandomGenerator(7).vector(A.num_cols)
    y = run_plan(plan, torch.from_numpy(x)).numpy()
    y_jax = np.asarray(jfn(jplan, jnp.asarray(x)))[:A.num_rows]
    tol = 8e-3 if kind == "bf16" else ROW_TOL
    if kind == "bf16":
        # the bits carried across: the port's stream is the JAX stream
        assert plan.vals.dtype == torch.bfloat16
        assert np.array_equal(plan.vals.view(torch.int16).numpy(),
                              np.asarray(jplan.vals).view(np.int16))
    assert y.shape == (A.num_rows,)
    assert_row_bound(y, y_jax, computes, x)
    assert spmv_matches(y, computes, x, rel_tol=tol)


PORT_TO_JAX = {
    "f32": jwe.spmv_window_ell, "bf16": jwe.spmv_window_ell,
    "pattern": jwe.spmv_window_ell, "leveled": jwe.spmv_window_ell,
    "banded": jwe.spmv_banded, "composite": jwe.spmv_composite,
    "strips": jst.spmv_strips, "reordered": jr.spmv_reordered,
}


@pytest.mark.parametrize("kind", list(PORT_TO_JAX))
def test_port_file_loads_in_jax(kind, tmp_path):
    make, plan_of, computes = KINDS[kind]
    A = make()
    plan = plan_of(A)
    path = str(tmp_path / "port.npz")
    save_plan(plan, path)
    jplan = jio.load_plan(path)
    x = RandomGenerator(7).vector(A.num_cols)
    y = run_plan(plan, torch.from_numpy(x)).numpy()
    y_jax = np.asarray(PORT_TO_JAX[kind](jplan, jnp.asarray(x)))
    assert_row_bound(y_jax[:A.num_rows], y, (computes or (lambda M: M))(A),
                     x)


# ---- the error cases of tests/test_plan_io.py ----

def small_plan():
    return twe.plan_from_host(tplan.build(
        RandomGenerator(42).power_law_csr(1024, 1024, 6.0, 1.6)), CPU)


def test_load_kind_mismatch(tmp_path):
    path = str(tmp_path / "p.npz")
    small_plan().save(path)
    for cls in (twe.CompositePlan, twe.BandedPlan, tst.StripPlan,
                tr.ReorderedPlan):
        with pytest.raises(InvalidFormatError):
            cls.load(path, CPU)
    assert isinstance(load_plan(path, CPU), twe.WindowEllPlan)


def test_load_rejects_non_plan(tmp_path):
    path = str(tmp_path / "junk.npz")
    np.savez(path, a=np.zeros(3))
    with pytest.raises(InvalidFormatError):
        load_plan(path, CPU)


def test_save_rejects_unknown_type(tmp_path):
    with pytest.raises(InvalidFormatError):
        save_plan(object(), str(tmp_path / "x.npz"))


def test_load_rejects_corrupt_file(tmp_path):
    path = str(tmp_path / "corrupt.npz")
    with open(path, "w") as f:
        f.write("this is not an npz archive")
    with pytest.raises(InvalidFormatError):
        load_plan(path, CPU)


def test_load_missing_file_and_unwritable_path(tmp_path):
    with pytest.raises(FileIOError):
        load_plan(str(tmp_path / "missing.npz"), CPU)
    with pytest.raises(FileIOError):
        save_plan(small_plan(), str(tmp_path / "no" / "dir.npz"))


def rewrite(path, out, edit):
    with np.load(path, allow_pickle=False) as z:
        arrays = {n: z[n] for n in z.files}
    meta = json.loads(bytes(arrays["__meta__"].tobytes()).decode())
    edit(arrays, meta)
    arrays["__meta__"] = np.frombuffer(json.dumps(meta).encode(),
                                       dtype=np.uint8)
    with open(out, "wb") as f:
        np.savez(f, **arrays)


def test_newer_version_and_stripped_vals_are_refused(tmp_path):
    path, out = str(tmp_path / "p.npz"), str(tmp_path / "q.npz")
    small_plan().save(path)
    rewrite(path, out, lambda a, m: m.update(version=2))
    with pytest.raises(InvalidFormatError):
        load_plan(out, CPU)
    rewrite(path, out, lambda a, m: a.pop("p_vals"))
    with pytest.raises(InvalidFormatError):
        load_plan(out, CPU)
    rewrite(path, out, lambda a, m: m.pop("p_aux"))
    with pytest.raises(InvalidFormatError):
        load_plan(out, CPU)


def test_t_base_round_trip_and_legacy_default(tmp_path):
    """``tb`` survives a round trip; a file written before the field loads
    with the default run length (``T_BASE``), in both packages."""
    A = RandomGenerator(42).power_law_csr(1500, 900, 10.0, 1.6)
    plan = twe.plan_from_host(tplan.build(A, split_rows=128, t_base=4), CPU)
    assert plan.tb == 4
    path, legacy = str(tmp_path / "tb4.npz"), str(tmp_path / "legacy.npz")
    plan.save(path)
    assert twe.WindowEllPlan.load(path, CPU).tb == 4
    plan8 = twe.plan_from_host(tplan.build(A, split_rows=128), CPU)
    assert plan8.tb == tplan.T_BASE
    plan8.save(path)
    rewrite(path, legacy, lambda a, m: m["p_aux"].pop("tb"))
    old = twe.WindowEllPlan.load(legacy, CPU)
    assert old.tb == tplan.T_BASE == jio.load_plan(legacy).tb
    x = torch.from_numpy(RandomGenerator(7).vector(A.num_cols))
    assert torch.equal(run_plan(old, x), run_plan(plan8, x))


def test_load_without_a_card_raises(tmp_path, monkeypatch):
    path = str(tmp_path / "p.npz")
    small_plan().save(path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(DeviceAllocError):
        load_plan(path)
    with pytest.raises(DeviceAllocError):
        twe.WindowEllPlan.load(path)
