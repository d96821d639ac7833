"""The SpMV's two epilogues: K1's section epilogue and K2, on the CPU.

After each section's fold but the last, the section epilogue sums the
section's split superblocks (their partial tiles, from zero in chunk order)
and publishes the extras totals into the gather table; K2 ends the call and
sums the last section's split tiles on its way.  Here:

* ``FoldSection.split_of_tile`` marks exactly the split superblocks' tiles,
  per section, on plans recut to small chunk caps so that every section
  splits, the last included;
* the section epilogue's plain version is the ordered reduce plus the
  publish copy, bit for bit, on the output and on the table's tail;
* the wrappers' argument blocks name the C structs' fields, in order;
* K2's plain version is ``unpermute_plain`` after ``chunk_reduce_plain``,
  bit for bit, leveled and not, with the last section split and not, and
  with a tile map the chunk permute of that;
* the CPU SpMV, which runs the plain versions in the kernels' order, matches
  the JAX package's ``spmv_window_ell`` / ``spmv_pattern`` (Pallas interpret
  mode) under the backward-error row bound, and the CPU oracle under
  ``spmv_matches`` at rel 1e-5 (8e-3 with a bf16 value stream, its value
  rounding), for the f32, bf16 and pattern streams.

The JAX planner calls ``_absorb_run_padding``, which its module does not
define; the tests bind the port's copy into it for their duration.
"""

import dataclasses
import pathlib
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import tpu_spmv.kernels.window_ell as jwe  # noqa: E402

from tpu_spmv_torch.kernels import plan as tplan  # noqa: E402
from tpu_spmv_torch.kernels import window_ell as twe  # noqa: E402
from tpu_spmv_torch.utils.testing import (RandomGenerator,  # noqa: E402
                                          abs_row_scale, spmv_matches,
                                          web_graph_csr)

ROW_TOL = 1e-5
BF16_TOL = 8e-3
CSRC = pathlib.Path(twe.__file__).resolve().parent.parent / "csrc"
# (matrix, sup, run length, pattern), runs of two groups: a skewed
# power-law matrix at sup 1024 and 4096 (three sections, the first two
# feeding extras totals to the next) and a web graph at sup 4096
# (superblocks dozens of runs deep)
PLANS = (("power_law", 1024, 2, False), ("power_law", 4096, 2, False),
         ("web_graph", 4096, 2, True))


def matrix(name):
    if name == "power_law":
        return RandomGenerator(42).power_law_csr(8192, 2048, 12.0, 1.6)
    return web_graph_csr(RandomGenerator(42), 16384, 16384, avg_nnz=15)


@pytest.fixture(scope="module")
def plans():
    """``{(matrix, sup, leveled): CPU plan}`` of every entry of PLANS,
    leveled and not, merge-path (row split at 128)."""
    out = {}
    for name, sup, tb, pat in PLANS:
        A = matrix(name)
        for leveled in (False, True):
            hp = tplan.build(A, split_rows=128, sup=sup, t_base=tb,
                             pattern=pat, permute_rows=leveled)
            out[name, sup, leveled] = twe.plan_from_host(hp, "cpu")
    return out


def recut(plan, cap):
    return dataclasses.replace(plan, sections=twe._fold_schedule(plan, cap))


@pytest.fixture
def absorb_helper(monkeypatch):
    monkeypatch.setattr(jwe, "_absorb_run_padding",
                        tplan._absorb_run_padding, raising=False)


def random_partial(sec, sup, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(sec.n_slots, sup, generator=g)


@pytest.mark.parametrize("cap", [1, 2, twe.CHUNK_RUNS])
@pytest.mark.parametrize("name, sup, tb, pat", PLANS)
def test_split_of_tile_marks_the_split_superblocks(plans, name, sup, tb,
                                                   pat, cap):
    """Per section, tile t maps to the split superblock whose chunks write
    partial tiles for it (found from the chunk schedule: a chunk with a
    workspace row, its superblock's base and the split range holding that
    row), and every other tile to -1; no tile is split in two sections.
    At R = 1 every section splits, the last included."""
    plan = recut(plans[name, sup, True], cap)
    n_tb = sup // 128
    base = plan.base.numpy()
    split_anywhere = np.zeros(plan.out8, bool)
    for sec in plan.sections:
        want = np.full(plan.out8, -1, np.int32)
        ro, ptr = sec.run_order.numpy(), sec.chunk_ptr.numpy()
        slots, sp = sec.chunk_slot.numpy(), sec.split_ptr.numpy()
        for c in np.flatnonzero(slots >= 0):
            b = int(base[ro[ptr[c]]])
            j = int(np.searchsorted(sp, slots[c], side="right")) - 1
            assert want[b] in (-1, j)
            want[b:b + n_tb] = j
        got = sec.split_of_tile.numpy()
        assert got.dtype == np.int32 and got.shape == (plan.out8,)
        assert np.array_equal(got, want)
        assert (got >= 0).sum() == sec.n_split * n_tb
        assert not np.any(split_anywhere & (got >= 0))
        split_anywhere |= got >= 0
    if cap == 1:
        assert all(sec.n_split > 0 for sec in plan.sections)
        assert len(plan.sections) > 1


@pytest.mark.parametrize("leveled", [False, True])
@pytest.mark.parametrize("cap", [1, twe.CHUNK_RUNS])
@pytest.mark.parametrize("name, sup, tb, pat", PLANS)
def test_section_epilogue_is_the_reduce_and_the_publish_copy(
        plans, name, sup, tb, pat, cap, leveled):
    """On every section, on random partial tiles, output and table: the
    section epilogue's output equals ``chunk_reduce_plain``'s and its
    table equals the publish copy's (``table[cols_pad:] =
    out[extras_base:]``), bit for bit.  The partial tiles are not
    modified."""
    plan = recut(plans[name, sup, leveled], cap)
    g = torch.Generator().manual_seed(7)
    n_table = plan.cols_pad + plan.e8 * 128
    for k, sec in enumerate(plan.sections):
        partial = random_partial(sec, sup, k)
        keep = partial.clone()
        out = torch.randn(plan.out8 * 128, generator=g)
        table = torch.randn(n_table, generator=g)
        want_out = twe.chunk_reduce_plain(partial, sec, out.clone())
        got_out, got_table = out.clone(), table.clone()
        res = twe.section_epilogue(partial, sec, got_out, got_table,
                                   plan.extras_base)
        assert res is got_out and torch.equal(got_out, want_out)
        assert torch.equal(partial, keep)
        want_table = table.clone()
        want_table[plan.cols_pad:] = want_out[plan.extras_base:]
        assert torch.equal(got_table, want_table)
        assert torch.equal(
            twe.section_epilogue_plain(partial, sec, out.clone(),
                                       table.clone(), plan.extras_base),
            want_out)


def c_struct_fields(source: str, name: str) -> list:
    """``(type, field)`` of each member of ``struct name`` in a kernel
    source, comments dropped."""
    text = (CSRC / source).read_text()
    body = re.search(r"struct %s \{(.*?)\};" % name, text, re.S)
    assert body, f"no struct {name} in {source}"
    fields = []
    for line in body.group(1).splitlines():
        decl = line.split("//")[0].strip()
        if decl:
            m = re.fullmatch(r"(.+?)\s*\b(\w+);", decl)
            assert m, decl
            fields.append((m.group(1), m.group(2)))
    return fields


@pytest.mark.parametrize("source, block", [
    ("epilogue.cuh", "SplitTiles"),
    ("window_ell.cu", "SectionEpilogueArgs"),
    ("unpermute.cu", "UnpermuteArgs"),
    ("permute.cu", "PermuteArgs")])
def test_argument_blocks_match_the_c_structs(source, block):
    """The wrapper's field names of each argument block (the epilogues',
    the table set-up's) are the C struct's, in order, and every field it packs as 8 bytes is a pointer
    or an ``int64_t`` (a leading ``SplitTiles split`` is packed once per
    section, as its own block)."""
    fields = c_struct_fields(source, block)
    assert tuple(f for _, f in fields) == twe.ARG_BLOCKS[block]
    if fields[0][1] == "split":
        assert fields[0][0] == "SplitTiles"
        fields = fields[1:]
    assert all(t.endswith("*") or t == "int64_t" for t, _ in fields), fields


@pytest.mark.parametrize("split", [False, True], ids=["unsplit", "split"])
@pytest.mark.parametrize("leveled", [False, True])
@pytest.mark.parametrize("name, sup, tb, pat", PLANS)
def test_k2_is_the_unpermute_after_the_reduce(plans, name, sup, tb, pat,
                                              leveled, split):
    """K2 with the last section's partial tiles equals ``unpermute_plain``
    (or the trim, unleveled) after ``chunk_reduce_plain``, bit for bit, and
    leaves its input alone; without a split it is the unpermute alone.
    ``split`` recuts the plan at R = 1, where the last section splits;
    ``unsplit`` drops the tiles (the headline's case: its rows section does
    not split at the module's R)."""
    plan = recut(plans[name, sup, leveled], 1)
    last = plan.sections[-1]
    assert last.n_split > 0
    partial = random_partial(last, sup, 3)
    y = torch.randn(plan.out8 * 128,
                    generator=torch.Generator().manual_seed(4))
    keep = y.clone()
    if split:
        got = twe.unpermute(y, plan.lam, plan.num_rows, partial=partial,
                            sec=last)
        reduced = twe.chunk_reduce_plain(partial, last, y.clone())
    else:
        got = twe.unpermute(y, plan.lam, plan.num_rows)
        reduced = y.clone()
    want = reduced[:plan.num_rows] if plan.lam is None \
        else twe.unpermute_plain(reduced, plan.lam, plan.num_rows)
    assert got.shape == (plan.num_rows,) and torch.equal(got, want)
    assert torch.equal(y, keep)
    if split:
        # the split rows really came from the partial tiles
        assert not torch.equal(got, twe.unpermute_plain(y, plan.lam,
                                                        plan.num_rows))


@pytest.mark.parametrize("num_rows", ["whole", "mid-tile"])
@pytest.mark.parametrize("split", [False, True], ids=["unsplit", "split"])
@pytest.mark.parametrize("leveled", [False, True])
@pytest.mark.parametrize("name, sup, tb, pat", PLANS)
def test_k2_tile_map_is_the_permute_after_the_unpermute(
        plans, name, sup, tb, pat, leveled, split, num_rows):
    """K2 with a tile map (``tile_src``, a reordered plan's ``row_src``)
    equals the chunk permute of its output without one, over every tile,
    trimmed: ``permute_chunks_plain(unpermute(...), tile_src, num_rows)``,
    bit for bit, leveled and not, the last section split (R = 1) and not,
    ``num_rows`` a whole number of tiles and ending mid-tile.  The map is a
    random permutation of the plan's tiles, one entry past them (which
    reads as zeros) in place of its last."""
    plan = recut(plans[name, sup, leveled], 1)
    last = plan.sections[-1]
    kw = {"partial": random_partial(last, sup, 3), "sec": last} \
        if split else {}
    y = torch.randn(plan.out8 * 128,
                    generator=torch.Generator().manual_seed(4))
    keep = y.clone()
    n_tiles = plan.out8 if plan.lam is None else plan.lam.shape[0]
    tile_src = torch.from_numpy(np.random.default_rng(5).permutation(
        n_tiles).astype(np.int32))
    tile_src[-1] = n_tiles
    n = n_tiles * 128 - (77 if num_rows == "mid-tile" else 0)
    got = twe.unpermute(y, plan.lam, n, tile_src=tile_src, **kw)
    inner = twe.unpermute_plain(y, plan.lam, n_tiles * 128, **kw)
    want = twe.permute_chunks_plain(inner, tile_src, n)
    assert got.shape == (n,) and torch.equal(got, want)
    assert not got[(n_tiles - 1) * 128:].any()
    assert torch.equal(y, keep)
    with pytest.raises(ValueError):
        twe.unpermute(y, plan.lam, n_tiles * 128 + 1, tile_src=tile_src)


def jax_plan(hp: tplan.HostPlan) -> jwe.WindowEllPlan:
    """The JAX plan of the port planner's arrays (bf16 values cast by
    JAX)."""
    leaves = {k: None if v is None else jnp.asarray(v)
              for k, v in hp.leaves().items()}
    if hp.values_dtype == "bfloat16":
        leaves["vals"] = leaves["vals"].astype(jnp.bfloat16)
    return jwe.WindowEllPlan(**leaves, **hp.aux(), occupancy=hp.occupancy)


@pytest.mark.parametrize("cap", [1, twe.CHUNK_RUNS])
@pytest.mark.parametrize("values", ["float32", "bfloat16", "pattern"])
def test_cpu_spmv_matches_jax(absorb_helper, values, cap):
    """The CPU SpMV (the plain fold, section epilogues and K2, in the
    kernels' order) on a leveled merge-path plan at sup 1024 with three
    sections, at R = 1 (every section splits, so K2 sums the last one's
    tiles) and the module's R: against JAX (interpret mode) under the row
    bound and against the oracle.  The pattern plan runs a column-scaled
    matrix through ``spmv_pattern``, as the dispatch serves it."""
    A = matrix("power_law")
    x = RandomGenerator(7).vector(A.num_cols)
    s = None
    if values == "pattern":
        s = RandomGenerator(3).rng.uniform(0.5, 2.0, A.num_cols) \
            .astype(np.float32)
        A = type(A)(A.num_rows, A.num_cols, s[A.col_indices],
                    A.col_indices, A.row_ptrs)
    hp = tplan.build(A, split_rows=128, sup=1024, t_base=2, permute_rows=True,
                     pattern=values == "pattern",
                     values_dtype="bfloat16" if values == "bfloat16"
                     else "float32")
    plan = recut(twe.plan_from_host(hp, "cpu"), cap)
    assert len(plan.sections) == 3
    assert (plan.sections[-1].n_split > 0) == (cap == 1)
    xt = torch.from_numpy(x)
    if s is None:
        y = twe.spmv_window_ell(plan, xt).numpy()
        y_jax = np.asarray(jwe.spmv_window_ell(jax_plan(hp), jnp.asarray(x)))
    else:
        y = twe.spmv_pattern(plan, torch.from_numpy(s), xt).numpy()
        y_jax = np.asarray(jwe.spmv_pattern(jax_plan(hp), jnp.asarray(s),
                                            jnp.asarray(x)))
    assert y.shape == (A.num_rows,)
    bound = ROW_TOL * np.maximum(abs_row_scale(A, x), 1.0)
    assert np.all(np.abs(y - y_jax) <= bound)
    assert spmv_matches(y, A, x, rel_tol=BF16_TOL if values == "bfloat16"
                        else ROW_TOL)
