"""P3: the permutation scatter, on the card (port of
``benchmarks/proto_v4.py``; kernel ``csrc/probe_proto_v4.cu``).

Per run of 8 groups, the 64 products of a lane, ``prod64[t*8 + s] = vals *
x2d[wg[g]*8 + s, lo]``, are a stack that each output row gathers from:

  sg64_N   for each of N output planes j and sublane s,
           ``out[base[r]*8 + j*8 + s, l] += prod64[sj & 63, l]`` where
           ``sj = src[(r*N + j)*8 + s, l] < 64`` (int8, sign-extended:
           negative entries are valid), 0 otherwise (``proto_v4.py:80-93``)
  msum128  the 128-target masked sum, P2's ``w128``

The src planes stream from device memory like a plan's arrays.  S must be a
multiple of T = 16 (``proto_v4.py:96``; ``ValueError`` otherwise, as in P2).
The kernel has no atomics: like the Pallas kernel's resident output, each
output element takes its runs in run order.  One CTA owns a tile of the
output (a band of ``BAND`` rows by a slice of lanes) and walks the runs that
touch its band, listed by the run index (:class:`~.common.RunIndex`, built
when the inputs are made).  Where a run spans two bands or more
(``products_first``), a products pass computes each
slot's product once before the tiles gather from them.  The result equals
the plain version's (``index_add_`` on the CPU) bit for bit, and
:func:`probe_schedule` is the kernel's order in plain torch.

    python3 -m tpu_spmv_torch.probes.proto_v4 [mode ...]

prints the JAX script's line per mode (mode, ms, GB/s, ps/slot), timed on
the card with CUDA events.  On the TPU the 64-deep gather did not lower, so
these are the first times any chip gave for ``sg64_*``.
"""

from __future__ import annotations

import dataclasses
import sys

import numpy as np
import torch

from .common import (CHUNKS, LANE, TB, WIDE, RunIndex, check_aligned,
                     check_multiple_of_t, check_range, check_run_index,
                     check_tensor, launch, masked_sum_wide_plain,
                     masked_sum_wide_schedule, run_index, start,
                     time_run_modes, window_gather_plain)

MAIN_MODES = ("sg64_8", "sg64_16", "sg64_64", "msum128")
MODES = MAIN_MODES    # the kernel takes any sg64_N
N_STEPS, S_DEFAULT = 64, 128
COLS8 = 32
OUT8 = 4096
ITERS, SAMPLES = 100, 2   # time_jitted(iters=100) and its 2 samples
STACK = TB * CHUNKS       # 64 products per lane and run
BAND = 64   # sg64's band rows (the kernel's kBand); msum128's are WIDE


def n_out_of(mode: str) -> int:
    """The output planes per run a mode names (``proto_v4.py:143``): N for
    ``sg64_N``, 16 otherwise."""
    return int(mode.split("_")[1]) if "_" in mode else 16


@dataclasses.dataclass(frozen=True)
class Inputs:
    """One mode's arguments (the Pallas call's, ``proto_v4.py:162``),
    checked when made: the kernel indexes with ``wg``, ``lo``, ``base`` and,
    in msum128, ``sb128`` unchecked."""

    mode: str
    S: int
    out8: int
    wg: torch.Tensor     # i32 (G,)
    base: torch.Tensor   # i32 (G/8,) run bases
    x2d: torch.Tensor    # f32 (cols8, 128)
    vals: torch.Tensor   # f32 (G*8, 128)
    lo: torch.Tensor     # i8 (G*8, 128)
    sb128: torch.Tensor  # i8 (G*8, 128), read in msum128
    src: torch.Tensor    # i8 (G/8 * N*8, 128) planes; (n_steps*8, 128) unread
    index: RunIndex = None   # built from base if None

    def __post_init__(self):
        if self.mode != "msum128" and not (
                self.mode.startswith("sg64_")
                and self.mode[5:].isdigit() and n_out_of(self.mode) > 0):
            raise ValueError(f"mode {self.mode!r}: sg64_N or msum128")
        check_multiple_of_t(self.S)
        G = self.wg.numel()
        if G < 1 or G % self.S:
            raise ValueError(f"{G} groups in steps of S={self.S}")
        n_runs, cols8 = G // TB, self.x2d.shape[0]
        if cols8 < CHUNKS or cols8 % CHUNKS:
            raise ValueError(f"cols8={cols8}: a multiple of {CHUNKS}")
        src_rows = G // self.S * CHUNKS if self.mode == "msum128" \
            else n_runs * self.n_out * CHUNKS
        dev = self.vals.device
        for name, dtype, shape in (
                ("wg", torch.int32, (G,)), ("base", torch.int32, (n_runs,)),
                ("x2d", torch.float32, (cols8, LANE)),
                ("vals", torch.float32, (G * CHUNKS, LANE)),
                ("lo", torch.int8, (G * CHUNKS, LANE)),
                ("sb128", torch.int8, (G * CHUNKS, LANE)),
                ("src", torch.int8, (src_rows, LANE))):
            check_tensor(name, getattr(self, name), dtype, shape, dev)
        check_range("wg", self.wg, 0, cols8 // CHUNKS)
        check_range("lo", self.lo, 0, LANE)
        check_aligned(self, ("vals", "lo", "sb128", "src"))
        if self.mode == "msum128":
            check_range("base", self.base, 0, self.out8 // 128)
            check_range("sb128", self.sb128, 0, 128)
        else:
            check_range("base", self.base, 0,
                        self.out8 // CHUNKS - self.n_out + 1)
        band = WIDE if self.mode == "msum128" else BAND
        if self.index is None:
            unit, span = (WIDE, WIDE) if self.mode == "msum128" \
                else (CHUNKS, self.n_out * CHUNKS)
            object.__setattr__(self, "index", run_index(
                self.base, unit, span, self.out8, band))
        check_run_index(self.index, n_runs, self.out8, dev, band)

    @property
    def products_first(self) -> bool:
        """Whether sg64 computes its products in a pass of their own: where
        a run's rows span two bands or more."""
        return self.mode != "msum128" and self.n_out * CHUNKS >= 2 * BAND

    @property
    def device(self) -> torch.device:
        return self.vals.device

    @property
    def n_groups(self) -> int:
        return self.wg.numel()

    @property
    def n_out(self) -> int:
        return n_out_of(self.mode)

    @property
    def nbytes(self) -> int:
        """The bytes counted per call: vals, lo and the stream the mode
        reads, sb128 in msum128 and src in sg64 (the JAX main also counts
        sb128 there, which the Pallas BlockSpec copied and this kernel does
        not read), and the run index."""
        return self.vals.nbytes + self.lo.nbytes + self.index.nbytes + (
            self.sb128.nbytes if self.mode == "msum128" else self.src.nbytes)


def make_inputs(n_steps: int = N_STEPS, S: int = S_DEFAULT,
                out8: int = OUT8, cols8: int = COLS8, seed: int = 0,
                device="cpu", modes=MAIN_MODES) -> dict:
    """The JAX main's arrays, bit for bit, in its draw order
    (``proto_v4.py:131-153``): ``base`` and ``src`` are drawn inside the
    mode loop, so they depend on the order of ``modes``.  ``{mode: Inputs}``
    on ``device``, sharing the common tensors."""
    n_groups = n_steps * S
    n_runs = n_groups // TB
    rng = np.random.default_rng(seed)
    vals = rng.random((n_groups * CHUNKS, LANE)).astype(np.float32)
    lo = rng.integers(0, LANE, (n_groups * CHUNKS, LANE), dtype=np.int8)
    sb128 = rng.integers(0, 128, (n_groups * CHUNKS, LANE), dtype=np.int8)
    wg = rng.integers(0, cols8 // CHUNKS, (n_groups,), dtype=np.int32)
    x2d = rng.random((cols8, LANE)).astype(np.float32)
    shared = {k: torch.from_numpy(v).to(device) for k, v in (
        ("wg", wg), ("x2d", x2d), ("vals", vals), ("lo", lo),
        ("sb128", sb128))}
    out = {}
    for mode in modes:
        n_out = n_out_of(mode)
        if mode == "msum128":
            base = rng.integers(0, out8 // 128, (n_runs,)).astype(np.int32)
            src = np.zeros((n_steps * 8, LANE), np.int8)
        else:
            base = rng.integers(0, out8 // 8 - n_out, (n_runs,)) \
                .astype(np.int32)
            src = rng.integers(0, 256, (
                n_steps * (S // TB) * n_out * 8, LANE)).astype(np.int8)
        out[mode] = Inputs(mode=mode, S=S, out8=out8,
                           base=torch.from_numpy(base).to(device),
                           src=torch.from_numpy(src).to(device), **shared)
    return out


def products(inp: Inputs) -> torch.Tensor:
    """The (n_runs, 64, 128) stacks of products."""
    return (inp.vals.view(-1, CHUNKS, LANE)
            * window_gather_plain(inp.x2d, inp.wg, inp.lo)
            ).view(inp.n_groups // TB, STACK, LANE)


def probe_plain(inp: Inputs) -> torch.Tensor:
    """P3's plain version, vectorised over runs: the stack gather as
    ``torch.gather`` along the stack, the adds with ``index_add_``.
    Returns (out8, 128)."""
    n_runs, dev = inp.n_groups // TB, inp.device
    prod = products(inp)
    if inp.mode == "msum128":
        return masked_sum_wide_plain(prod, inp.sb128, inp.base, inp.out8)
    sj = inp.src.view(n_runs, -1, LANE).int()
    picked = torch.gather(prod, 1, (sj & (STACK - 1)).long())
    contrib = torch.where(sj < STACK, picked, 0.0)
    dst = inp.base.long().view(-1, 1) * CHUNKS \
        + torch.arange(inp.n_out * CHUNKS, device=dev)
    out = torch.zeros(inp.out8, LANE, dtype=torch.float32, device=dev)
    return out.index_add_(0, dst.reshape(-1), contrib.reshape(-1, LANE))


def probe_schedule(inp: Inputs) -> torch.Tensor:
    """P3 in the kernel's order, in plain torch: band by band of the run
    index, the band's runs in index order, each run's gathered rows inside
    the band added into the band's tile, which is written once
    (``msum128``: :func:`~.common.masked_sum_wide_schedule`).  Every lane
    at once: lanes are independent, so the kernel's lane slices change no
    sum.  Equal to :func:`probe_plain` bit for bit; nothing on the card's
    path calls it.  Returns (out8, 128)."""
    prod = products(inp)
    if inp.mode == "msum128":
        return masked_sum_wide_schedule(prod, inp.sb128, inp.index, inp.out8)
    span = inp.n_out * CHUNKS
    sj = inp.src.view(-1, span, LANE).int()
    base = inp.base.tolist()
    band_rows = inp.index.band_rows
    out = torch.zeros(inp.out8, LANE, dtype=torch.float32, device=inp.device)
    for b in range(inp.index.n_bands):
        row0 = b * band_rows
        tile = torch.zeros(min(band_rows, inp.out8 - row0), LANE,
                           dtype=torch.float32, device=inp.device)
        for r in inp.index.band(b):
            top = base[r] * CHUNKS - row0
            t0, t1 = max(top, 0), min(top + span, tile.shape[0])
            s = sj[r, t0 - top:t1 - top]
            tile[t0:t1] += torch.where(
                s < STACK, torch.gather(prod[r], 0, (s & (STACK - 1)).long()),
                0.0)
        out[row0:row0 + tile.shape[0]] = tile
    return out


def probe(inp: Inputs) -> torch.Tensor:
    """P3's kernel, ``inp.mode``: launches ``csrc/probe_proto_v4.cu``, which
    writes every output row, for CUDA inputs; the plain version for CPU
    ones.  Returns (out8, 128) f32."""
    if inp.device.type == "cpu":
        return probe_plain(inp)
    if inp.device.type != "cuda":
        raise ValueError(f"no probe kernel for {inp.device}")
    out = torch.empty(inp.out8, LANE, dtype=torch.float32, device=inp.device)
    prod = torch.empty_like(inp.vals) if inp.products_first else None
    idx = inp.index
    launch("tsp_probe_proto_v4", inp.x2d, inp.vals, inp.lo, inp.sb128,
           inp.src, inp.wg, inp.base, idx.ptr, idx.runs, idx.n_bands,
           idx.max_runs, inp.n_groups // TB,
           inp.out8, inp.n_out, int(inp.mode == "msum128"), prod, out)
    probe.launches += 1
    return out


probe.launches = 0


def time_modes(inputs: dict, stream_gbs: float, modes=MAIN_MODES,
               iters: int = ITERS, samples: int = SAMPLES) -> list:
    """Time each of ``modes`` on the card and print the JAX script's line
    for it (:func:`~.common.time_run_modes`)."""
    return time_run_modes(probe, inputs, stream_gbs, modes, iters, samples)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    modes = tuple(argv) or MAIN_MODES
    dev, stream = start()
    time_modes(make_inputs(device=dev, modes=modes), stream, modes)
    return 0


if __name__ == "__main__":
    sys.exit(main())
