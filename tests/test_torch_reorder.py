"""The port's block reordering against the JAX package's
(``tpu_spmv/kernels/reorder.py``).

Host part: the planted-locality generators, ``block_order``,
``reorder_gain``, ``permute_csr`` and the probe verdicts must be EQUAL to the
JAX package's on the same matrix, and the reordered plan equal leaf for leaf.
Device part: the chunk permute's plain version, and the gather table's set-up
that takes its place on the reordered path, must be bit-equal to the JAX
Pallas kernel in interpret mode (they move values without arithmetic), and
the reordered SpMV through the composed maps (the permuted table, K2's tile
map) bit-equal to the old composition of two permutes around the inner
SpMV.
Reordered SpMVs are held to the backward-error row bound
``|y - y_ref|_i <= 1e-5 * max((|A||x|)_i, 1)`` against JAX and the oracle:
the two packages sum each row in different orders (and the JAX dispatch picks
another step width under interpret mode).

The JAX planner calls ``_absorb_run_padding``, which its module does not
define; the tests bind the port's copy into the JAX module for their
duration (``monkeypatch``), so no file of the JAX package changes.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import tpu_spmv  # noqa: E402
import tpu_spmv.kernels.reorder as jr  # noqa: E402
import tpu_spmv.kernels.window_ell as jwe  # noqa: E402
import tpu_spmv.utils.testing as jt  # noqa: E402
from tpu_spmv.csr import CSRMatrix as JaxCSRMatrix  # noqa: E402

import tpu_spmv_torch  # noqa: E402
from tpu_spmv_torch import KernelType, SpMVConfig  # noqa: E402
from tpu_spmv_torch import kernels as tk  # noqa: E402
from tpu_spmv_torch.kernels import plan as tplan  # noqa: E402
from tpu_spmv_torch.kernels import reorder as tr  # noqa: E402
from tpu_spmv_torch.kernels import window_ell as twe  # noqa: E402
from tpu_spmv_torch.utils import testing as tt  # noqa: E402

ROW_TOL = 1e-5

# (generator, args): the JAX reorder tests' own matrices
BANDED_65K = ("scrambled_banded_csr", (65536, 2048, 8.0))
CLUSTERED_8K = ("clustered_csr", (8192, 8, 8.0))
BANDED_16K = ("scrambled_banded_csr", (16384, 1024, 6.0))
CLUSTERED_16K = ("clustered_csr", (16384, 16, 8.0))


@pytest.fixture
def absorb_helper(monkeypatch):
    monkeypatch.setattr(jwe, "_absorb_run_padding",
                        tplan._absorb_run_padding, raising=False)


def port_matrix(case, seed=42):
    name, args = case
    return getattr(tt, name)(tt.RandomGenerator(seed), *args)


def to_jax(A):
    return JaxCSRMatrix(A.num_rows, A.num_cols, A.values, A.col_indices,
                        A.row_ptrs)


def to_port(A):
    return tpu_spmv_torch.CSRMatrix(A.num_rows, A.num_cols, A.values,
                                    A.col_indices, A.row_ptrs)


def unaligned_matrix():
    """8000 x 8000 (not a whole number of 128-blocks), as
    ``tests/test_reorder.py:145-153`` builds it."""
    A = tt.clustered_csr(tt.RandomGenerator(42), 8192, n_clusters=8,
                         avg_nnz=8.0, block_shuffle=False)
    end = A.row_ptrs[8000]
    return tpu_spmv_torch.CSRMatrix(
        8000, 8000, A.values[:end], np.minimum(A.col_indices[:end], 7999),
        A.row_ptrs[:8001])


def assert_row_bound(y, y_ref, A, x):
    diff = np.abs(np.asarray(y, np.float32) - np.asarray(y_ref, np.float32))
    bound = ROW_TOL * np.maximum(tt.abs_row_scale(A, x), 1.0)
    assert np.all(diff <= bound), float(np.max(diff - bound))


def assert_csr_equal(a, b):
    assert (a.num_rows, a.num_cols) == (b.num_rows, b.num_cols)
    for name in ("values", "col_indices", "row_ptrs"):
        assert np.array_equal(getattr(a, name), getattr(b, name)), name


# ---- the host part ----

@pytest.mark.parametrize("name, args, kw", [
    ("clustered_csr", (8192, 8, 8.0), {}),
    ("clustered_csr", (3000, 4, 10.0), {"block_shuffle": False}),
    ("scrambled_banded_csr", (16384, 1024, 6.0), {}),
    ("scrambled_banded_csr", (5000, 300, 9.0), {"scramble": False}),
])
def test_generators_match_jax(name, args, kw):
    a = getattr(tt, name)(tt.RandomGenerator(42), *args, **kw)
    b = getattr(jt, name)(jt.RandomGenerator(42), *args, **kw)
    assert_csr_equal(a, b)


@pytest.mark.parametrize("case", [BANDED_65K, CLUSTERED_8K])
def test_block_order_gain_and_permute_equal_jax(case):
    A = port_matrix(case)
    order = tr.block_order(A)
    assert np.array_equal(order, jr.block_order(to_jax(A)))
    assert sorted(order.tolist()) == list(range(-(-A.num_rows // 128)))
    assert tr.reorder_gain(A, order) == jr.reorder_gain(to_jax(A), order)
    shuffled = np.random.default_rng(5).permutation(len(order))
    for o in (order, shuffled):
        assert_csr_equal(tr.permute_csr(A, o), jr.permute_csr(to_jax(A), o))


def test_rcm_fallback_gives_a_permutation(monkeypatch):
    """Without SciPy the BFS fallback still orders every block once."""
    import builtins

    real_import = builtins.__import__

    def no_scipy(name, *args, **kwargs):
        if name.startswith("scipy"):
            raise ImportError(name)
        return real_import(name, *args, **kwargs)

    A = port_matrix(CLUSTERED_8K)
    monkeypatch.setattr(builtins, "__import__", no_scipy)
    order = tr.block_order(A)
    assert sorted(order.tolist()) == list(range(64))


def iid_web_graph(rows, cols):
    return jt.web_graph_csr(jt.RandomGenerator(42), rows, cols, avg_nnz=8.0)


def mesh_matrix(scale, scramble=True):
    """The benchmark's ``mesh1m`` law at ``2**scale`` points: the P1
    stiffness matrix of a Delaunay mesh, numbered along a Morton curve in
    128-vertex patches, the patches numbered at random where ``scramble``
    (``spmvbench/generators/delaunay.py``)."""
    from spmvbench.generators import delaunay

    m = delaunay.generate({"scale": scale, "patch": 128,
                           "structure_seed": 42, "scramble": scramble})
    return tpu_spmv_torch.CSRMatrix(m.num_rows, m.num_cols, m.values,
                                    m.col_indices, m.row_ptrs), m


def graph500_matrix(scale):
    """An undirected Graph500 graph of ``2**scale`` vertices, labels
    permuted (the benchmark's ``graph500`` law, drawn on the CPU)."""
    from spmvbench.generators import graph500

    m = graph500.structure({"scale": scale, "edgefactor": 16, "a": 0.57,
                            "b": 0.19, "c": 0.19}, 42, torch.device("cpu"))
    return tpu_spmv_torch.CSRMatrix(m.num_rows, m.num_cols, m.values,
                                    m.col_indices, m.row_ptrs)


@pytest.mark.parametrize("which", ["banded", "banded_merge", "clustered_tiny",
                                   "iid", "rectangular", "forced",
                                   "narrow_mesh"])
def test_probe_verdict_equals_jax(absorb_helper, which):
    """The port's probe gives the JAX probe's verdict and order, but for
    one stated departure (``narrow_mesh``): the JAX probe turns away every
    matrix whose superblock choice is narrow before its packing model is
    asked, and the port's asks the model.  The scrambled mesh at 2^16
    points, its choice set narrow in JAX (what the selector picks from
    2^18 points up), is admitted by the port alone, with the order JAX
    forces.  The port's probe takes no superblock choice or merge-path
    split (``banded_merge`` gives the split to JAX alone)."""
    if which in ("iid", "rectangular"):
        jA = iid_web_graph(65536, 65536 if which == "iid" else 32768)
        A = to_port(jA)
    elif which == "narrow_mesh":
        A, _ = mesh_matrix(16)
        jA = to_jax(A)
    else:
        A = port_matrix(CLUSTERED_8K if which == "clustered_tiny"
                        else BANDED_65K)
        jA = to_jax(A)
    kw = {"force": True} if which == "forced" else {}
    jkw = {"split_rows": 128} if which == "banded_merge" \
        else {"choice": (tplan.SUP_LEVELS[0], 0)} if which == "narrow_mesh" \
        else kw
    got, ref = tr.maybe_reorder(A, **kw), jr.maybe_reorder(jA, **jkw)
    if which == "narrow_mesh":
        assert got is not None and ref is None
        nat, prm = tr.reorder_gain(A, got)
        assert prm <= 0.75 * nat
        assert np.array_equal(got, jr.maybe_reorder(jA, force=True))
        return
    applies = which in ("banded", "banded_merge", "forced")
    assert (got is not None) == (ref is not None) == applies
    if applies:
        assert np.array_equal(got, ref)


def test_spmv_csr_serves_the_narrow_scrambled_mesh_reordered():
    """At 2^18 points (1,834,952 nonzeros) the selector picks the narrow
    superblock for the scrambled mesh; ``spmv_csr`` under
    ``spmv_auto_config`` still serves it through a ``ReorderedPlan`` (the
    probe comes before the K4 rule), which streams fewer slots than the
    natural window-ELL plan, and its output is within the row bound of the
    benchmark's plain float64 product."""
    from spmvbench.reference import plain

    A, m = mesh_matrix(18)
    assert A.nnz == 1_834_952
    cfg = tpu_spmv_torch.spmv_auto_config(A)
    assert tplan._choose_sup(A, split_rows=128) == tplan.SUP_LEVELS[0]
    x = torch.from_numpy(tt.RandomGenerator(7).vector(A.num_cols))
    res = tpu_spmv_torch.spmv_csr(A, x, cfg, device="cpu")
    assert res.error_code == 0 and isinstance(res.plan, tr.ReorderedPlan)
    natural = tplan.build_auto(A, split_rows=128, choice=tplan._choose_sup(
        A, with_groups=True, split_rows=128))
    assert res.plan.n_groups < natural.n_groups
    op = plain.Operator(m, "cpu")
    y64, scale = op.matvec(x), op.matvec(x, absolute=True)
    diff = (res.y.double() - y64).abs()
    assert bool((diff <= ROW_TOL * torch.clamp(scale, min=1.0)).all())


@pytest.mark.parametrize("which", ["mesh_unscrambled", "graph500"])
def test_probe_turns_down_what_hides_no_locality(which):
    """Without a width gate the packing model alone turns these down, as
    it does the iid and non-square cases above: the mesh in its Morton
    numbering (already local) and a Graph500-law graph (labels
    permuted)."""
    A = mesh_matrix(16, scramble=False)[0] if which == "mesh_unscrambled" \
        else graph500_matrix(13)
    nat, prm = tr.reorder_gain(A, tr.block_order(A))
    assert prm > tr.GAIN_THRESHOLD * nat
    assert tr.maybe_reorder(A) is None


def test_probe_env_disable(monkeypatch):
    A = port_matrix(BANDED_65K)
    monkeypatch.setenv("TPU_SPMV_REORDER", "0")
    assert tr.maybe_reorder(A) is None
    assert tr.maybe_reorder(A, force=True) is None


# ---- K3's plain version ----

@pytest.mark.parametrize("n, nb_out", [(1024, 8), (5000, 64), (128 * 130, 100),
                                       (1001, 13)])
def test_permute_chunks_plain_equals_jax(n, nb_out):
    x = tt.RandomGenerator(42).vector(n)
    n_src = -(-n // 128)
    src = np.random.default_rng(7).integers(0, n_src, nb_out) \
        .astype(np.int32)
    for out_len in (nb_out * 128, nb_out * 128 - 77):
        ref = np.asarray(jr.permute_chunks(jnp.asarray(x), jnp.asarray(src),
                                           out_len))
        got = tr.permute_chunks(torch.from_numpy(x), torch.from_numpy(src),
                                out_len).numpy()
        assert got.dtype == ref.dtype and np.array_equal(got, ref)


def test_permute_chunks_roundtrip_equals_jax():
    x = tt.RandomGenerator(42).vector(4000)      # last chunk partial
    order = np.random.default_rng(3).permutation(32).astype(np.int32)
    pos = np.empty(32, np.int32)
    pos[order] = np.arange(32)
    xp = tr.permute_chunks(torch.from_numpy(x), torch.from_numpy(order),
                           4096)
    ref = jr.permute_chunks(jnp.asarray(x), jnp.asarray(order), 4096)
    assert np.array_equal(xp.numpy(), np.asarray(ref))
    back = tr.permute_chunks(xp, torch.from_numpy(pos), 4000)
    assert torch.equal(back, torch.from_numpy(x))


def test_permute_chunks_plain_reads_outside_x_as_zero():
    x = torch.arange(1, 301, dtype=torch.float32)   # 3 chunks, last partial
    src = torch.tensor([2, 7, -1, 0, 2], dtype=torch.int32)
    out = tr.permute_chunks(x, src, 4 * 128 + 5)
    assert out.shape == (517,)
    assert torch.equal(out[:44], x[256:])
    assert not out[44:384].any()
    assert torch.equal(out[384:512], x[:128])
    assert torch.equal(out[512:], x[256:261])
    with pytest.raises(ValueError):
        tr.permute_chunks(x, src, 5 * 128 + 1)
    with pytest.raises(ValueError):
        tr.permute_chunks(x, src.long(), 10)


@pytest.fixture(scope="module")
def unaligned_plans():
    """The 8000 x 8000 matrix, its natural plan and its reordered plan, on
    the CPU."""
    A = unaligned_matrix()
    natural = twe.plan_from_host(tplan.build(A, split_rows=128,
                                             step_groups=8), "cpu")
    return A, natural, tr.build_reordered(A, device="cpu")


@pytest.mark.parametrize("case", ["reordered", "in order", "past the end"])
def test_gather_table_plain_equals_jax_permute(unaligned_plans, case):
    """The gather table's set-up, plain, is JAX's ``permute_chunks`` of x
    (Pallas interpret mode) over the plan's columns, zero-padded to
    ``cols_pad`` and the ``e8*128`` extras tail: x of 8000 (not whole
    chunks) through the reordered plan's ``col_src``; in order
    (``src=None``, JAX through the identity) on the natural plan; through a
    ``src`` with chunks past x's end (chunk 63, in JAX's zero padding).
    The wrapper takes it on the CPU."""
    A, natural, rp = unaligned_plans
    x = tt.RandomGenerator(7).vector(A.num_cols)
    plan, src = (natural, None) if case == "in order" \
        else (rp.inner, rp.col_src.clone())
    if case == "past the end":
        src[::5] = 63
    jsrc = np.arange(63, dtype=np.int32) if src is None else src.numpy()
    ref = np.zeros(plan.cols_pad + plan.e8 * 128, np.float32)
    ref[:plan.num_cols] = np.asarray(jr.permute_chunks(
        jnp.asarray(x), jnp.asarray(jsrc), plan.num_cols))
    xt = torch.from_numpy(x)
    got = twe.gather_table_plain(plan, xt, src)
    assert got.dtype == torch.float32 and torch.equal(got,
                                                      torch.from_numpy(ref))
    if case == "past the end":
        assert not got[:128].any() and got[128:plan.num_cols].any()
    assert torch.equal(twe.gather_table(plan, xt, src), got)
    with pytest.raises(ValueError):
        twe.gather_table(plan, torch.zeros(plan.cols_pad + 1), None)


@pytest.mark.parametrize("cap", [twe.CHUNK_RUNS, 1], ids=["Rmodule", "R1"])
@pytest.mark.parametrize("which", ["banded", "clustered", "unaligned"])
def test_spmv_reordered_equals_the_old_composition(which, cap):
    """The reordered SpMV through the composed maps (the table set up from
    x's chunks in ``col_src`` order, K2 writing output tile ``b`` from the
    inner tile ``row_src[b]``) equals the old composition, ``permute(
    spmv_window_ell(inner, permute(x, col_src)), row_src)``, bit for bit:
    at the module's R and at R = 1, where the last section splits and K2
    sums its tiles through the tile map."""
    A = {"banded": lambda: port_matrix(BANDED_16K),
         "clustered": lambda: port_matrix(CLUSTERED_16K),
         "unaligned": unaligned_matrix}[which]()
    rp = tr.build_reordered(A, device="cpu")
    inner = dataclasses.replace(rp.inner,
                                sections=twe._fold_schedule(rp.inner, cap))
    rp = dataclasses.replace(rp, inner=inner)
    if cap == 1:
        assert inner.sections[-1].n_split > 0
    xt = torch.from_numpy(tt.RandomGenerator(7).vector(A.num_cols))
    old = tr.permute_chunks_plain(
        twe.spmv_window_ell(inner, tr.permute_chunks_plain(
            xt, rp.col_src, inner.num_cols)), rp.row_src, rp.num_rows)
    got = tr.spmv_reordered(rp, xt)
    assert got.shape == (A.num_rows,) and torch.equal(got, old)


# ---- the reordered plan ----

def assert_reordered_equal(jrp, rp):
    for name in tplan.LEAVES:
        a, b = getattr(jrp.inner, name), getattr(rp.inner, name)
        if a is None or b is None:
            assert a is None and b is None, name
            continue
        a, b = np.asarray(a), b.numpy()
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    for name in tplan.AUX:
        assert getattr(jrp.inner, name) == getattr(rp.inner, name), name
    assert jrp.inner.occupancy == rp.occupancy
    for name in ("col_src", "row_src"):
        assert np.array_equal(np.asarray(getattr(jrp, name)),
                              getattr(rp, name).numpy()), name
    assert (jrp.num_rows, jrp.num_cols) == (rp.num_rows, rp.num_cols)


@pytest.mark.parametrize("case, split_rows", [(BANDED_16K, None),
                                              (CLUSTERED_16K, None),
                                              (BANDED_16K, 128)])
def test_build_reordered_equals_jax_plan(absorb_helper, case, split_rows):
    A = port_matrix(case)
    rp = tr.build_reordered(A, split_rows=split_rows, step_groups=8,
                            device="cpu")
    _, jrp = jr.build_reordered(to_jax(A), split_rows=split_rows,
                                step_groups=8)
    assert isinstance(rp, tr.ReorderedPlan) and rp.inner.sup == 4096
    assert_reordered_equal(jrp, rp)


def test_reordered_from_arrays_gives_port_output(absorb_helper):
    A = port_matrix(BANDED_16K)
    _, jrp = jr.build_reordered(to_jax(A), step_groups=8)
    leaves = {k: None if getattr(jrp.inner, k) is None
              else np.asarray(getattr(jrp.inner, k)) for k in tplan.LEAVES}
    aux = {k: getattr(jrp.inner, k) for k in tplan.AUX}
    from_jax = tr.reordered_from_arrays(
        leaves, aux, np.asarray(jrp.col_src), np.asarray(jrp.row_src),
        jrp.num_rows, jrp.num_cols, device="cpu", occupancy=jrp.occupancy)
    from_port = tr.build_reordered(A, step_groups=8, device="cpu")
    x = torch.from_numpy(tt.RandomGenerator(7).vector(A.num_cols))
    assert torch.equal(tr.spmv_reordered(from_jax, x),
                       tr.spmv_reordered(from_port, x))
    assert from_jax.stream_bytes == from_port.stream_bytes
    bad = np.asarray(jrp.row_src).copy()
    bad[[0, 1]] = bad[[1, 0]]
    with pytest.raises(tplan.InvalidFormatError):
        tr.reordered_from_arrays(leaves, aux, np.asarray(jrp.col_src), bad,
                                 jrp.num_rows, jrp.num_cols)
    with pytest.raises(tplan.InvalidFormatError):
        tr.reordered_from_arrays(leaves, aux, np.asarray(jrp.col_src),
                                 np.asarray(jrp.row_src), jrp.num_rows - 200,
                                 jrp.num_cols)


@pytest.mark.parametrize("which", ["banded", "clustered", "unaligned"])
def test_spmv_reordered_matches_jax_and_oracle(absorb_helper, which):
    A = {"banded": lambda: port_matrix(BANDED_16K),
         "clustered": lambda: port_matrix(CLUSTERED_16K),
         "unaligned": unaligned_matrix}[which]()
    x = tt.RandomGenerator(7).vector(A.num_cols)
    rp = tr.build_reordered(A, device="cpu")
    fn, jrp = jr.build_reordered(to_jax(A))
    y = tr.spmv_reordered(rp, torch.from_numpy(x)).numpy()
    y_jax = np.asarray(fn(jrp, jnp.asarray(x)))
    assert y.shape == y_jax.shape == (A.num_rows,)
    assert_row_bound(y, y_jax, A, x)
    assert tt.spmv_matches(y, A, x, rel_tol=ROW_TOL)


def test_permuted_banded_build_raises_m7(absorb_helper, monkeypatch):
    """Where the permuted matrix needs a row-banded plan (the group cap
    lowered in both planners), the port builds the JAX package's bands and
    maps, and its reordered SpMV (the chunk permute of x, the banded SpMV,
    the chunk permute of its rows) matches the JAX one and the oracle.  The
    route is served; the test keeps its name from before it was."""
    A = port_matrix(BANDED_16K)
    order = tr.block_order(A)
    single, _ = tr.build_reordered_host(A, order, step_groups=8)
    assert isinstance(single, tplan.HostPlan)
    for mod in (tplan, jwe):
        monkeypatch.setattr(mod, "MAX_GROUPS", single.n_groups - 8)
    host, host_order = tr.build_reordered_host(A, order, step_groups=8)
    assert isinstance(host, tplan.HostBanded) and len(host.plans) >= 2
    fn, jrp = jr.build_reordered(to_jax(A), order=order, step_groups=8)
    assert isinstance(jrp.inner, jwe.BandedPlan)
    assert tuple(jrp.inner.band_rows) == host.band_rows
    for jp, hp in zip(jrp.inner.plans, host.plans, strict=True):
        for name in tplan.LEAVES:
            a, b = getattr(jp, name), getattr(hp, name)
            assert (a is None and b is None) \
                or np.array_equal(np.asarray(a), b), name
        assert {k: getattr(jp, k) for k in tplan.AUX} == hp.aux()
    rp = tr.reordered_from_host(host, host_order, A.num_rows, A.num_cols,
                                "cpu")
    assert isinstance(rp.inner, twe.BandedPlan)
    assert np.array_equal(rp.col_src.numpy(), np.asarray(jrp.col_src))
    assert np.array_equal(rp.row_src.numpy(), np.asarray(jrp.row_src))
    x = tt.RandomGenerator(7).vector(A.num_cols)
    y = tr.spmv_reordered(rp, torch.from_numpy(x)).numpy()
    y_jax = np.asarray(fn(jrp, jnp.asarray(x)))
    assert y.shape == y_jax.shape == (A.num_rows,)
    assert_row_bound(y, y_jax, A, x)
    assert tt.spmv_matches(y, A, x, rel_tol=ROW_TOL)
    # the stream bytes: the bands', the table set-ups' and maps', and the
    # two chunk permutes' own writes and reads
    nb = len(order)
    assert rp.stream_bytes == rp.inner.stream_bytes \
        + twe.setup_bytes(A.num_cols, nb) + 4 * nb \
        + 4 * (rp.inner.num_cols + rp.inner.num_rows + A.num_rows)


def test_reordered_stream_bytes_add_the_setup_and_the_tile_map():
    """The inner plan's bytes, x and ``col_src`` read once by the table's
    set-up, and ``row_src`` read by K2, 4 B an output tile."""
    A = unaligned_matrix()
    rp = tr.build_reordered(A, device="cpu")
    assert rp.inner.num_cols == 63 * 128
    assert rp.stream_bytes == rp.inner.stream_bytes \
        + 8000 * 4 + 63 * 4 + 63 * 4
    assert rp.stream_bytes - rp.inner.stream_bytes \
        == twe.setup_bytes(8000, 63) + 63 * 4


# ---- the dispatch ----

@pytest.mark.parametrize("reorder", [None, True, False])
@pytest.mark.parametrize("which", ["banded", "clustered", "unaligned"])
def test_spmv_csr_route_and_output_match_jax(absorb_helper, which, reorder):
    A = {"banded": lambda: port_matrix(BANDED_16K),
         "clustered": lambda: port_matrix(CLUSTERED_16K),
         "unaligned": unaligned_matrix}[which]()
    jA = to_jax(A)
    x = tt.RandomGenerator(7).vector(A.num_cols)
    cfg = tpu_spmv_torch.spmv_auto_config(A)
    jcfg = tpu_spmv.spmv_auto_config(jA)
    cfg.reorder = jcfg.reorder = reorder
    res = tpu_spmv_torch.spmv_csr(A, x, cfg, device="cpu")
    jres = tpu_spmv.spmv_csr(jA, x, jcfg)
    assert res.error_code == 0 == jres.error_code
    _, jplan = jA._plan_cache[(int(jcfg.kernel_type), jcfg.step_groups,
                               False, reorder)]
    reordered = isinstance(res.plan, tr.ReorderedPlan)
    assert reordered == isinstance(jplan, jr.ReorderedPlan)
    if which != "unaligned":   # planted for the probe; the other one is
        assert reordered == (reorder is not False)   # below its size gate
    y = res.y_host()
    assert_row_bound(y, np.asarray(jres.y), A, x)
    assert tt.spmv_matches(y, A, x, rel_tol=ROW_TOL)


def test_dispatch_plan_is_build_reordered():
    """The plan ``spmv_csr`` serves is :func:`build_reordered`'s (held equal
    to the JAX plan above) for the probe's order and the merge-path split."""
    from tpu_spmv_torch.spmv import MERGE_SPLIT_ROWS

    A = port_matrix(BANDED_16K)
    x = tt.RandomGenerator(7).vector(A.num_cols)
    res = tpu_spmv_torch.spmv_csr(A, x, SpMVConfig(
        kernel_type=KernelType.MERGE_PATH, reorder=True), device="cpu")
    order = tr.maybe_reorder(A, force=True)
    assert_reordered_equal(
        tr.build_reordered(A, order, split_rows=MERGE_SPLIT_ROWS,
                           device="cpu"), res.plan)


def test_plan_cache_keys_on_reorder():
    """One matrix asked for with reorder off, then forced: each call gets its
    own plan (the host plan is cached per reorder flag)."""
    A = port_matrix(BANDED_16K)
    x = tt.RandomGenerator(7).vector(A.num_cols)
    cfg = SpMVConfig(kernel_type=KernelType.VECTOR_CSR)
    off = tpu_spmv_torch.spmv_csr(A, x, SpMVConfig(
        kernel_type=KernelType.VECTOR_CSR, reorder=False), device="cpu")
    on = tpu_spmv_torch.spmv_csr(A, x, SpMVConfig(
        kernel_type=KernelType.VECTOR_CSR, reorder=True), device="cpu")
    auto = tpu_spmv_torch.spmv_csr(A, x, cfg, device="cpu")
    assert not isinstance(off.plan, tr.ReorderedPlan)
    assert isinstance(on.plan, tr.ReorderedPlan)
    assert isinstance(auto.plan, tr.ReorderedPlan) and auto.plan is not on.plan
    for res in (off, on, auto):
        assert tt.spmv_matches(res.y_host(), A, x, rel_tol=ROW_TOL)


def test_measure_times_the_plan_that_served(monkeypatch):
    """``measure=True`` times the reordered SpMV, permutes included, not the
    inner plan alone.  The timer is replaced by one that runs the timed
    callable once on the CPU and keeps what it returns."""
    import tpu_spmv_torch.bandwidth as tbw
    import tpu_spmv_torch.timing as ttm

    timed = []

    def fake_time_cuda(fn, **kwargs):
        timed.append(fn())
        return 1e-3

    monkeypatch.setattr(ttm, "time_cuda", fake_time_cuda)
    monkeypatch.setattr(tbw, "get_gpu_peak_bandwidth", lambda index=0: 3e3)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    A = port_matrix(BANDED_16K)
    x = tt.RandomGenerator(7).vector(A.num_cols)
    res = tpu_spmv_torch.spmv_csr(A, x, SpMVConfig(
        kernel_type=KernelType.VECTOR_CSR, reorder=True), measure=True,
        device="cpu")
    assert isinstance(res.plan, tr.ReorderedPlan)
    assert len(timed) == 1 and torch.equal(timed[0], res.y)
    assert res.elapsed_ms == 1.0 and res.bandwidth_gb_s > 0


def test_measure_refuses_the_cpu():
    A = port_matrix(BANDED_16K)
    x = tt.RandomGenerator(7).vector(A.num_cols)
    with pytest.raises(RuntimeError, match="CUDA"):
        tpu_spmv_torch.spmv_csr(A, x, SpMVConfig(
            kernel_type=KernelType.VECTOR_CSR, reorder=False), measure=True,
            device="cpu")


def test_permute_launch_count_does_not_move_on_cpu():
    A = port_matrix(BANDED_16K)
    rp = tr.build_reordered(A, device="cpu")
    tk.reset_launch_counts()
    tr.spmv_reordered(rp, torch.from_numpy(
        tt.RandomGenerator(7).vector(A.num_cols)))
    assert tk.launch_counts()["permute_chunks"] == 0
