"""The ports of the benchmark probes (``tpu_spmv_torch/probes``) against the
JAX probes of ``benchmarks/`` on the CPU.

Each probe's plain version, which its wrapper takes for CPU tensors, is held
to the Pallas kernel of the JAX script in interpret mode, in every mode, on
the same inputs (the port's ``make_inputs`` at a small size, handed to the
JAX ``build`` as NumPy arrays).  The scripts are imported from their files
and their module-level ``pl`` is replaced, for the test's duration, by a
namespace whose ``pallas_call`` runs in interpret mode: no JAX file changes.

Tolerance ``rtol=1e-5`` with ``atol = 1e-5 * max|ref|``: both sides sum fp32
products, in different orders.

P4's Pallas kernel zeroes its output at step 0 only, so its later
superblocks start from the uninitialised buffer (NaN in interpret mode); the
port defines every superblock to start from zero.  The P4 tests compare
block 0 with JAX, assert that JAX's later blocks are NaN, and hold the
port's later blocks to a float64 NumPy loop.

P1's v2 modes, gather and v1x16 gather from the output's own first rows,
which the Pallas kernel zeroes and never writes, so its output is all zeros
(fault F5).  The port seeds those rows with x2d; the P1 tests assert JAX's
zeros and hold the port to a float64 loop and to the mode's v3 twin outside
the head rows.  The v3 modes are held to JAX directly.

A test per probe stubs the JAX script's ``build`` and ``time_jitted``, runs
its ``main()`` at the default sizes, and holds the arrays it would have timed
bit for bit equal to the port's ``make_inputs``.
"""

import dataclasses
import functools
import importlib.util
import os
import subprocess
import sys
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402

from tpu_spmv_torch import probes  # noqa: E402
from tpu_spmv_torch.probes import profile_dma_share as p5  # noqa: E402
from tpu_spmv_torch.probes import profile_kernel as p4  # noqa: E402
from tpu_spmv_torch.probes import proto_v2 as p1  # noqa: E402
from tpu_spmv_torch.probes import proto_v3 as p2  # noqa: E402
from tpu_spmv_torch.probes import proto_v4 as p3  # noqa: E402
from tpu_spmv_torch.probes.common import run_index  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL = 1e-5


@functools.cache
def script(name: str):
    """``benchmarks/<name>.py`` imported from its file."""
    spec = importlib.util.spec_from_file_location(
        f"jax_probe_{name}", os.path.join(REPO, "benchmarks", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def interpret(monkeypatch):
    """Returns the JAX script of a name with its ``pl`` running Pallas in
    interpret mode until the test ends."""
    def load(name: str):
        mod = script(name)
        ns = types.SimpleNamespace(**{k: getattr(pl, k) for k in dir(pl)
                                      if not k.startswith("_")})
        ns.pallas_call = functools.partial(pl.pallas_call, interpret=True)
        monkeypatch.setattr(mod, "pl", ns)
        return mod
    return load


def arrays(inp, names):
    return [getattr(inp, n).numpy() for n in names]


def assert_close(got, ref):
    np.testing.assert_allclose(got, ref, rtol=RTOL,
                               atol=RTOL * float(np.max(np.abs(ref))))


def assert_bit_equal(jax_array, port_tensor):
    a, b = np.asarray(jax_array), port_tensor.numpy()
    assert a.dtype == b.dtype and a.shape == b.shape
    assert np.array_equal(a.view(np.uint8), b.view(np.uint8))


# ---- P4: profile_kernel ----

P4_ARGS = ("wg", "sbg", "sup", "x2d", "vals", "lo", "sb8")


def p4_loop(inp) -> np.ndarray:
    """P4 as a float64 loop over steps and groups, every superblock from
    zero."""
    wg, sbg, sup, x2d, vals, lo, sb8 = arrays(inp, P4_ARGS)
    out = np.zeros((inp.n_sup, 8, 128))
    for i in range(inp.n_steps):
        acc = np.zeros((8, 128))
        for t in range(inp.S):
            g = i * inp.S + t
            v = vals[8 * g:8 * g + 8].astype(np.float64)
            lg = lo[8 * g:8 * g + 8].astype(np.int64)
            if inp.mode == "stream":
                acc += v
                continue
            if inp.mode == "+lo":
                acc += v + lg
                continue
            table = x2d[8 * wg[g]:8 * wg[g] + 8].astype(np.float64)
            p = v * np.take_along_axis(table, lg, axis=1)
            if inp.mode == "+gather":
                acc += p
            elif inp.mode == "+select":
                acc[sbg[g]] += p.sum(0)
            else:
                n_t = int(inp.mode[len("+scatter"):])
                s = sb8[8 * g:8 * g + 8]
                rows = [np.where(s == k, p, 0.0).sum(0) for k in range(n_t)]
                acc += np.array(rows * (8 // n_t))
        out[sup[i]] += acc
    return out.reshape(-1, 128)


@pytest.mark.parametrize("mode", p4.MODES)
def test_profile_kernel_matches_jax(interpret, mode):
    n_steps, S, n_sup = 8, 16, 4
    inp = p4.make_inputs(n_steps, S, n_sup=n_sup, modes=(mode,))[mode]
    jk = interpret("profile_kernel")
    ref = np.asarray(jk.build(n_steps, S, n_sup, p4.COLS8, mode)(
        *arrays(inp, P4_ARGS)))
    got = p4.probe(inp).numpy()
    assert got.shape == ref.shape == (n_sup * 8, 128)
    assert_close(got[:8], ref[:8])
    assert np.isnan(ref[8:]).all()
    assert_close(got, p4_loop(inp))


# ---- P1: proto_v2 ----

P1_ARGS = ("wg", "base", "x2d", "vals", "lo", "sb")
P1_SMALL = dict(n_steps=4, S=32, out8=256)


def p1_loop(inp) -> np.ndarray:
    """P1 as a float64 loop over groups, the table x2d (in the v2 forms the
    seeded head rows, which keep x2d)."""
    wg, base, x2d, vals, lo, sb = arrays(inp, P1_ARGS)
    cols8, mode, U = inp.cols8, p1.base_mode(inp.mode), inp.unit
    out = np.zeros((cols8 + inp.out8, 128))
    if not inp.split:
        out[:cols8] = x2d
    acc = np.zeros((16, 128))
    for g in range(inp.n_groups):
        table = x2d[8 * wg[g]:8 * wg[g] + 8].astype(np.float64)
        p = vals[8 * g:8 * g + 8].astype(np.float64) * np.take_along_axis(
            table, lo[8 * g:8 * g + 8].astype(np.int64), axis=1)
        s = sb[8 * g:8 * g + 8]
        if mode == "gather":
            acc[:8] += p
            acc[8:] += p
            continue
        for k in range(16 if mode == "v1x16" else 8):
            acc[k] += np.where(s == k, p, 0.0).sum(0)
        if U and (g + 1) % U == 0:
            out[base[g + 1 - U] * 8:base[g + 1 - U] * 8 + 8] += acc[:8]
            acc[:] = 0.0
    if not U:
        out[cols8:cols8 + 16] += acc
    return out


@pytest.mark.parametrize("mode", [m for m in p1.MODES if m.startswith("v3")])
def test_proto_v2_v3_modes_match_jax(interpret, mode):
    inp = p1.make_inputs(**P1_SMALL, modes=(mode,))[mode]
    jk = interpret("proto_v2")
    ref = np.asarray(jk.build(inp.n_steps, inp.S, inp.out8, p1.COLS8, mode)(
        *arrays(inp, P1_ARGS)))
    got = p1.probe(inp).numpy()
    assert got.shape == ref.shape == (p1.COLS8 + inp.out8, 128)
    assert np.any(ref != 0) and not np.any(ref[:p1.COLS8])
    assert_close(got, ref)
    assert_close(got, p1_loop(inp))


@pytest.mark.parametrize("mode", [m for m in p1.MODES
                                  if not m.startswith("v3")])
def test_proto_v2_table_in_output_modes(interpret, mode):
    """F5: JAX gathers from zeroed rows and returns zeros; the port gathers
    from rows seeded with x2d, as its v3 twin gathers from the copy."""
    inp = p1.make_inputs(**P1_SMALL, modes=(mode,))[mode]
    jk = interpret("proto_v2")
    ref = np.asarray(jk.build(inp.n_steps, inp.S, inp.out8, p1.COLS8, mode)(
        *arrays(inp, P1_ARGS)))
    assert not np.any(ref)
    got = p1.probe(inp).numpy()
    assert np.array_equal(got[:p1.COLS8], inp.x2d.numpy())
    assert_close(got, p1_loop(inp))
    twin = p1.twin(mode)
    if twin is not None:
        v3 = p1.probe(p1.Inputs(**{**vars(inp), "mode": twin})).numpy()
        assert_close(got[p1.COLS8:], v3[p1.COLS8:])
    else:
        assert mode == "v1x16"


def test_proto_v2_main_inputs(monkeypatch, capsys):
    mod = script("proto_v2")
    port = p1.make_inputs(modes=("v3s16",))["v3s16"]
    seen = []

    def check(args):
        for name, a in zip(P1_ARGS, args):
            assert_bit_equal(a, getattr(port, name))
        seen.append(len(seen))

    stub_mains(monkeypatch, mod, check)
    monkeypatch.setattr(sys, "argv", ["proto_v2.py"])
    mod.main()
    assert len(seen) == len(p1.MAIN_MODES)
    out = capsys.readouterr().out
    assert f"groups={port.n_groups} stream={port.nbytes / 1e6:.0f}MB" in out
    assert out.count("ps/slot") == len(p1.MAIN_MODES)


@pytest.mark.parametrize("mode, S", [("v2s8", 12), ("v3s16", 24),
                                     ("gather", 8), ("v2b8", 40)])
def test_proto_v2_s_not_a_multiple_of_t_raises(mode, S):
    with pytest.raises(ValueError, match="multiple of T"):
        p1.make_inputs(2, S, out8=256, modes=(mode,))


def test_proto_v2_refuses_a_base_in_the_head_rows():
    inp = p1.make_inputs(**P1_SMALL, modes=("v2s8",))["v2s8"]
    base = inp.base.clone()
    base[5] = p1.COLS8 // 8 - 1
    with pytest.raises(ValueError, match="base"):
        p1.Inputs(**{**vars(inp), "base": base})


# ---- P2: proto_v3 ----

P2_ARGS = ("wg", "base", "x2d", "vals", "lo", "sb")


@pytest.mark.parametrize("mode", p2.MODES)
def test_proto_v3_matches_jax(interpret, mode):
    n_steps, S, out8 = 4, 32, 512
    inp = p2.make_inputs(n_steps, S, out8=out8, modes=(mode,))[mode]
    jk = interpret("proto_v3")
    ref = np.asarray(jk.build(n_steps, S, out8, p2.COLS8, mode)(
        *arrays(inp, P2_ARGS)))
    got = p2.probe(inp).numpy()
    assert got.shape == ref.shape == (out8, 128)
    assert np.any(ref != 0)
    assert_close(got, ref)


# ---- P3: proto_v4 ----

P3_ARGS = ("wg", "base", "x2d", "vals", "lo", "sb128", "src")


@pytest.mark.parametrize("mode", p3.MAIN_MODES)
def test_proto_v4_matches_jax(interpret, mode):
    n_steps, S, out8 = 4, 32, 1024
    inp = p3.make_inputs(n_steps, S, out8=out8, modes=(mode,))[mode]
    jk = interpret("proto_v4")
    ref = np.asarray(jk.build(n_steps, S, out8, p3.COLS8, mode, inp.n_out)(
        *arrays(inp, P3_ARGS)))
    if mode != "msum128":     # src drawn in 0..255, cast to int8:
        assert bool((inp.src < 0).any())   # negative entries are valid
    got = p3.probe(inp).numpy()
    assert got.shape == ref.shape == (out8, 128)
    assert np.any(ref != 0)
    assert_close(got, ref)


# ---- the run index and the kernel's order (P3, and P2's w128) ----

P3_SMALL = dict(n_steps=4, S=32, out8=1024)
P2_SMALL = dict(n_steps=4, S=32, out8=512)


def overlaps(inp) -> list:
    """Per band of ``inp.index``, the runs whose output rows touch it, in
    run order, found by walking every (band, run) pair."""
    unit, span = (128, 128) if inp.mode in ("msum128", "w128") \
        else (8, inp.n_out * 8)
    rows = inp.index.band_rows
    base = inp.base.tolist()
    return [[r for r, b0 in enumerate(base)
             if b0 * unit < (b + 1) * rows and b0 * unit + span > b * rows]
            for b in range(inp.index.n_bands)]


def assert_index_lists_overlaps(inp):
    idx = inp.index
    assert idx.n_bands == -(-inp.out8 // idx.band_rows)
    assert [idx.band(b) for b in range(idx.n_bands)] == overlaps(inp)


def assert_schedule_is_plain(mod, inp):
    assert_bit_equal(mod.probe_plain(inp).numpy(), mod.probe_schedule(inp))


@pytest.mark.parametrize("size", ["reduced", "main"])
@pytest.mark.parametrize("mode", [*p3.MAIN_MODES, "w128"])
def test_run_index_lists_every_overlap_once_in_run_order(mode, size):
    if mode == "w128":
        kw = P2_SMALL if size == "reduced" else {}
        inps = [p2.make_inputs(**kw, modes=(mode,))[mode]]
    else:
        kw = P3_SMALL if size == "reduced" else {}
        inps = [p3.make_inputs(**kw, modes=(mode,))[mode]]
    for inp in inps:
        assert_index_lists_overlaps(inp)
        runs = inp.index.runs.tolist()
        if mode in ("msum128", "w128"):     # one block a run
            assert sorted(runs) == list(range(inp.n_groups // 8))


@pytest.mark.parametrize("mode", [*p3.MAIN_MODES, "w128"])
def test_schedule_twin_equals_plain_bit_for_bit(mode):
    mod, kw = (p2, P2_SMALL) if mode == "w128" else (p3, P3_SMALL)
    assert_schedule_is_plain(mod, mod.make_inputs(**kw, modes=(mode,))[mode])


@pytest.mark.parametrize("mode", [*p3.MAIN_MODES, "w128"])
def test_schedule_twin_equals_plain_at_main_size(mode):
    mod = p2 if mode == "w128" else p3
    inp = mod.make_inputs(modes=(mode,))[mode]
    assert_schedule_is_plain(mod, inp)


@pytest.mark.parametrize("mode", [*p3.MAIN_MODES, "w128"])
def test_schedule_twin_matches_jax(interpret, mode):
    if mode == "w128":
        inp = p2.make_inputs(**P2_SMALL, modes=(mode,))[mode]
        ref = interpret("proto_v3").build(4, 32, 512, p2.COLS8, mode)(
            *arrays(inp, P2_ARGS))
        got = p2.probe_schedule(inp)
    else:
        inp = p3.make_inputs(**P3_SMALL, modes=(mode,))[mode]
        ref = interpret("proto_v4").build(4, 32, 1024, p3.COLS8, mode,
                                          inp.n_out)(*arrays(inp, P3_ARGS))
        got = p3.probe_schedule(inp)
    ref = np.asarray(ref)
    assert np.any(ref != 0)
    assert_close(got.numpy(), ref)


@pytest.mark.parametrize("mode", [*p3.MAIN_MODES, "w128"])
def test_a_dropped_run_fails_the_index_and_twin_checks(mode):
    """Mutation: one run left out of one band's list.  The overlap check
    and the twin's bit-for-bit check both catch it."""
    mod = p2 if mode == "w128" else p3
    kw = P2_SMALL if mode == "w128" else P3_SMALL
    inp = mod.make_inputs(**kw, modes=(mode,))[mode]
    idx = inp.index
    ptr, runs = idx.ptr.clone(), idx.runs.tolist()
    b = int(torch.argmax(ptr[1:] - ptr[:-1]))   # a band with runs
    del runs[int(ptr[b])]
    ptr[b + 1:] -= 1
    bad = dataclasses.replace(inp, index=dataclasses.replace(
        idx, ptr=ptr, runs=torch.tensor(runs, dtype=torch.int32)))
    with pytest.raises(AssertionError):
        assert_index_lists_overlaps(bad)
    with pytest.raises(AssertionError):
        assert_schedule_is_plain(mod, bad)
    assert_index_lists_overlaps(inp)
    assert_schedule_is_plain(mod, inp)


def test_products_pass_where_a_run_spans_two_bands():
    """sg64 computes its products in a pass of their own where a run's
    8*N rows cover two bands or more; msum128 takes no products pass."""
    inps = p3.make_inputs(**P3_SMALL)
    rows = inps["sg64_8"].index.band_rows
    for mode, inp in inps.items():
        spans = mode != "msum128" and inp.n_out * 8 >= 2 * rows
        assert inp.products_first == spans, mode
    assert [inps[m].products_first for m in p3.MAIN_MODES] == [
        False, True, True, False]


def test_bad_run_index_raises():
    inp = p3.make_inputs(**P3_SMALL, modes=("sg64_8",))["sg64_8"]
    idx = inp.index
    for bad, match in (
            (dataclasses.replace(idx, runs=idx.runs + 1000), "index.runs"),
            (dataclasses.replace(idx, ptr=idx.ptr.flip(0).contiguous()),
             "index.ptr"),
            (dataclasses.replace(idx, ptr=idx.ptr[:-1].contiguous()),
             "index.ptr"),
            (dataclasses.replace(idx, max_runs=idx.max_runs - 1),
             "max_runs")):
        with pytest.raises(ValueError, match=match):
            dataclasses.replace(inp, index=bad)
    for rows in (32, 128):   # the kernel's bands are 64 rows
        with pytest.raises(ValueError, match="bands of"):
            dataclasses.replace(inp, index=run_index(
                inp.base, 8, inp.n_out * 8, inp.out8, rows))
    m = p3.make_inputs(**P3_SMALL, modes=("msum128",))["msum128"]
    with pytest.raises(ValueError, match="bands of"):
        dataclasses.replace(m, index=run_index(m.base, 128, 128, m.out8, 64))
    buf = torch.zeros(inp.lo.numel() + 1, dtype=torch.int8)
    with pytest.raises(ValueError, match="aligned"):
        dataclasses.replace(inp, lo=buf[1:].view(inp.lo.shape))
    with pytest.raises(ValueError, match="no run index"):
        r = p2.make_inputs(**P2_SMALL, modes=("w128", "base"))
        dataclasses.replace(r["base"], index=r["w128"].index)


# ---- P5: profile_dma_share ----

@pytest.mark.parametrize("mode", p5.MODES)
def test_dma_share_matches_jax(interpret, mode):
    n_blocks, S, n_out = 8, 16, 4
    inp = p5.make_inputs(n_blocks, S, n_out=n_out, modes=(mode,))[mode]
    jk = interpret("profile_dma_share")
    ref = np.asarray(jk.build(inp.n_steps, S, n_out, inp.direct)(
        *arrays(inp, ("blk", "oi", "vals"))))
    got = p5.probe(inp).numpy()
    assert got.shape == ref.shape == (n_out * 8, 128)
    assert_close(got, ref)


# ---- the JAX mains' inputs, bit for bit ----

def stub_mains(monkeypatch, mod, check):
    """Replace ``mod``'s ``build`` with a no-op kernel and its
    ``time_jitted`` with ``check(args)``."""
    monkeypatch.setattr(mod, "build",
                        lambda *a, **k: (lambda *args: jnp.zeros(())))

    def fake_time(f, *args, **kw):
        check(args)
        return 1.0

    monkeypatch.setattr(mod, "time_jitted", fake_time)


def test_profile_kernel_main_inputs(monkeypatch, capsys):
    mod = script("profile_kernel")
    seen = []

    def check(args):
        S = args[0].shape[0] // p4.N_STEPS
        if S in seen:
            return
        inp = p4.make_inputs(p4.N_STEPS, S, modes=("+gather",))["+gather"]
        for name, a in zip(P4_ARGS, args):
            assert_bit_equal(a, getattr(inp, name))
        seen.append(S)

    stub_mains(monkeypatch, mod, check)
    monkeypatch.setattr(sys, "argv", ["profile_kernel.py"])
    mod.main()
    assert seen == list(p4.S_LIST)
    assert capsys.readouterr().out.count("ps/slot") == 4 * len(p4.MAIN_MODES)


def test_proto_v3_main_inputs(monkeypatch, capsys):
    mod = script("proto_v3")
    port = p2.make_inputs()
    seen = []

    def check(args):
        mode = p2.MODES[len(seen)]
        for name, a in zip(P2_ARGS, args):
            assert_bit_equal(a, getattr(port[mode], name))
        seen.append(mode)

    stub_mains(monkeypatch, mod, check)
    monkeypatch.setattr(sys, "argv", ["proto_v3.py", *p2.MODES])
    mod.main()
    assert seen == list(p2.MODES)
    assert "FAILED" not in capsys.readouterr().out


def test_proto_v4_main_inputs(monkeypatch, capsys):
    mod = script("proto_v4")
    port = p3.make_inputs()
    seen = []

    def check(args):
        mode = p3.MAIN_MODES[len(seen)]
        for name, a in zip(P3_ARGS, args):
            assert_bit_equal(a, getattr(port[mode], name))
        seen.append(mode)

    stub_mains(monkeypatch, mod, check)
    monkeypatch.setattr(sys, "argv", ["proto_v4.py"])
    mod.main()
    assert seen == list(p3.MAIN_MODES)
    assert "FAILED" not in capsys.readouterr().out


def test_dma_share_main_inputs(monkeypatch):
    mod = script("profile_dma_share")
    port = p5.make_inputs()
    seen = []

    def check(args):
        mode = p5.MODES[len(seen)]
        for name, a in zip(("blk", "oi", "vals"), args):
            assert_bit_equal(a, getattr(port[mode], name))
        seen.append(mode)

    stub_mains(monkeypatch, mod, check)
    mod.main()
    assert seen == list(p5.MODES)


# ---- what the port refuses ----

@pytest.mark.parametrize("mod", [p2, p3], ids=["proto_v3", "proto_v4"])
def test_s_not_a_multiple_of_t_raises(mod):
    with pytest.raises(ValueError, match="multiple of T"):
        mod.make_inputs(2, 24, out8=1024)


def test_bad_indices_raise():
    inp = p4.make_inputs(4, 16, n_sup=4, modes=("+gather",))["+gather"]
    with pytest.raises(ValueError, match="non-decreasing"):
        p4.Inputs(**{**vars(inp), "sup": inp.sup.flip(0).contiguous()})
    with pytest.raises(ValueError, match="wg"):
        p4.Inputs(**{**vars(inp), "wg": inp.wg + 4})
    q = p5.make_inputs(4, 16, n_out=2, modes=("reuse2",))["reuse2"]
    with pytest.raises(ValueError, match="oi"):
        p5.Inputs(**{**vars(q), "oi": q.oi + 1})
    r = p2.make_inputs(2, 16, out8=256, modes=("w128",))["w128"]
    with pytest.raises(ValueError, match="base"):
        p2.Inputs(**{**vars(r), "base": r.base + 2})


@pytest.mark.parametrize("name", probes.NAMES)
def test_main_needs_a_card(name):
    """No fallback: a probe's main raises where there is no CUDA device."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        probes.modules()[name].main([])


def test_launch_counts_cover_every_probe():
    probes.reset_launch_counts()
    assert probes.launch_counts() == {n: 0 for n in probes.NAMES}
    inp = p5.make_inputs(4, 16, n_out=2, modes=("direct",))["direct"]
    p5.probe(inp)              # a CPU tensor: the plain version, no launch
    assert probes.launch_counts()["profile_dma_share"] == 0


def test_probes_import_no_jax():
    code = ("import sys, tpu_spmv_torch.probes as p; p.modules(); "
            "bad = [m for m in sys.modules if m in ('jax', 'tpu_spmv') or "
            "m.startswith(('jax.', 'tpu_spmv.'))]; "
            "assert not bad, bad")
    env = {**os.environ, "PYTHONPATH": REPO}
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO,
                   env=env, timeout=300)
