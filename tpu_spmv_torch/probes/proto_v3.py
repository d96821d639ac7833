"""P2: the round-3 scatter candidates, on the card (port of
``benchmarks/proto_v3.py``; kernel ``csrc/probe_proto_v3.cu``).

Every mode gathers and multiplies, ``p = vals * x2d[wg[g]*8 + s, lo]``, then
scatters each run of 8 groups (run ``r``: groups ``8r .. 8r+8``) into an
output that is resident for the whole call:

  base     8 masked sums by ``sb`` (0..7), added at rows ``base[r]*8 + k``
  nib      the same, ``sb`` nibble-packed across group pairs: group 2t is
           the low nibble, 2t+1 the high one (``proto_v3.py:74-77``)
  mrg      the same, ``lo`` and ``sb`` merged into one stream (each step's
           S*8 lo rows, then its S*8 sb rows); the ``sb`` argument is not
           read (``proto_v3.py:67-69``)
  ind8     8 masked sums, sum k added at its own row ``tgt[r*8 + k]``;
  ind8u    the same (the two differ in Mosaic's unrolling only)
  w128     128 masked sums by ``sb`` (0..127) at rows ``base[r]*128 + k``
  sgather  per group the sublane gather ``p[sb[g*8+s, l], l]``, summed over
           the run, added at rows ``base[r]*8 + s``

S must be a multiple of T = 16: the Pallas loop over ``S // T`` sub-tiles
(``proto_v3.py:146-150``) drops the groups past the last whole one, so the
port refuses such an S with ``ValueError``.  Every mode but ``w128`` adds
into shared output rows with atomics, so its result matches the plain
version to fp32 rounding in another order, not bit for bit.  ``w128`` runs
the owner-computes tiles that P3's ``msum128`` runs (``masked_sum_wide``,
through a run index of the 128-row blocks, :class:`~.common.RunIndex`): no
atomics, each output element's runs added in run order, equal to the plain
version bit for bit (:func:`probe_schedule` is its order in plain torch).

    python3 -m tpu_spmv_torch.probes.proto_v3 [mode ...]

prints the JAX script's line per mode (mode, ms, GB/s, ps/slot), timed on
the card with CUDA events.
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

MODES = ("base", "nib", "mrg", "ind8", "ind8u", "w128", "sgather")
MAIN_MODES = ("base", "nib", "ind8", "ind8u", "w128", "sgather")
N_STEPS, S_DEFAULT = 128, 128
COLS8 = 32
OUT8 = 2048
ITERS, SAMPLES = 300, 3   # time_jitted(iters=300, samples=3)

# mode -> mode code of tsp_probe_proto_v3
_CODE = {"base": 0, "nib": 1, "mrg": 2, "ind8": 3, "ind8u": 3,
         "sgather": 4, "w128": 5}


@dataclasses.dataclass(frozen=True)
class Inputs:
    """One mode's arguments (the Pallas call's, ``proto_v3.py:226``),
    checked when made: the kernel indexes with ``wg``, ``lo``, ``base`` and,
    in ``sgather`` and ``w128``, ``sb`` unchecked."""

    mode: str
    S: int
    out8: int
    wg: torch.Tensor    # i32 (G,)
    base: torch.Tensor  # i32 (G/8,) run bases; (G,) targets in ind8/ind8u
    x2d: torch.Tensor   # f32 (cols8, 128)
    vals: torch.Tensor  # f32 (G*8, 128)
    lo: torch.Tensor    # i8 (G*8, 128); (2*G*8, 128) merged in mrg
    sb: torch.Tensor    # i8 (G*8, 128); (G*4, 128) in nib; unread in mrg
    index: RunIndex = None  # w128's run index, built from base if None

    def __post_init__(self):
        if self.mode not in MODES:
            raise ValueError(f"mode {self.mode!r} not in {MODES}")
        check_multiple_of_t(self.S)
        G = self.wg.numel()
        if G < 1 or G % self.S:
            raise ValueError(f"{G} groups in steps of S={self.S}")
        n_runs, cols8 = G // TB, self.x2d.shape[0]
        if cols8 < CHUNKS or cols8 % CHUNKS:
            raise ValueError(f"cols8={cols8}: a multiple of {CHUNKS}")
        sb_rows = {"nib": G * CHUNKS // 2,
                   "mrg": G // self.S * CHUNKS}.get(self.mode, G * CHUNKS)
        ind8 = self.mode in ("ind8", "ind8u")
        dev = self.vals.device
        for name, dtype, shape in (
                ("wg", torch.int32, (G,)),
                ("base", torch.int32, (n_runs * CHUNKS if ind8 else n_runs,)),
                ("x2d", torch.float32, (cols8, LANE)),
                ("vals", torch.float32, (G * CHUNKS, LANE)),
                ("lo", torch.int8, ((2 if self.mode == "mrg" else 1)
                                    * G * CHUNKS, LANE)),
                ("sb", torch.int8, (sb_rows, LANE))):
            check_tensor(name, getattr(self, name), dtype, shape, dev)
        check_range("wg", self.wg, 0, cols8 // CHUNKS)
        check_range("lo", self.lo, 0, LANE)
        rows = {"w128": 128}.get(self.mode, 1 if ind8 else CHUNKS)
        check_range("base", self.base, 0, self.out8 // rows)
        if self.mode == "sgather":
            check_range("sb", self.sb, 0, CHUNKS)
        elif self.mode == "w128":
            check_range("sb", self.sb, 0, 128)
            check_aligned(self, ("vals", "lo", "sb"))
            if self.index is None:
                object.__setattr__(self, "index", run_index(
                    self.base, WIDE, WIDE, self.out8, WIDE))
            check_run_index(self.index, n_runs, self.out8, dev, WIDE)
        elif self.index is not None:
            raise ValueError(f"mode {self.mode} takes no run index")

    @property
    def device(self) -> torch.device:
        return self.vals.device

    @property
    def n_groups(self) -> int:
        return self.wg.numel()

    @property
    def nbytes(self) -> int:
        """The bytes counted per call, as the JAX main counts them (vals,
        lo, sb), less the ``sb`` argument of mrg, which is not read, and
        w128's run index."""
        return self.vals.nbytes + self.lo.nbytes \
            + (self.sb.nbytes if self.mode != "mrg" else 0) \
            + (self.index.nbytes if self.index is not None else 0)


def make_inputs(n_steps: int = N_STEPS, S: int = S_DEFAULT,
                out8: int = OUT8, cols8: int = COLS8, seed: int = 0,
                device="cpu", modes=MODES) -> dict:
    """The JAX main's arrays, bit for bit, in its draw order
    (``proto_v3.py:186-209``), and each mode's choice of them
    (``:211-218``); ``{mode: Inputs}`` on ``device``, sharing tensors."""
    n_groups = n_steps * S
    n_runs = n_groups // TB
    rng = np.random.default_rng(seed)
    vals = rng.random((n_groups * CHUNKS, LANE)).astype(np.float32)
    lo = rng.integers(0, LANE, (n_groups * CHUNKS, LANE), dtype=np.int8)
    sb8 = rng.integers(0, 8, (n_groups * CHUNKS, LANE), dtype=np.int8)
    sb128 = rng.integers(0, 128, (n_groups * CHUNKS, LANE), dtype=np.int8)
    pairs = sb8.reshape(n_groups // 2, 2, CHUNKS, LANE)
    sbnib = (pairs[:, 0] | (pairs[:, 1] << 4)).reshape(-1, LANE)
    wg = rng.integers(0, cols8 // CHUNKS, (n_groups,), dtype=np.int32)
    base_run = rng.integers(0, out8 // 8 - 16, (n_runs,)).astype(np.int32)
    base_w128 = rng.integers(0, out8 // 128, (n_runs,)).astype(np.int32)
    tgt = rng.integers(0, out8 - 1, (n_runs * 8,)).astype(np.int32)
    x2d = rng.random((cols8, LANE)).astype(np.float32)
    arrays = {
        "lo": lambda: lo, "sb8": lambda: sb8, "sbnib": lambda: sbnib,
        "sb128": lambda: sb128, "base_run": lambda: base_run,
        "base_w128": lambda: base_w128, "tgt": lambda: tgt,
        "merged": lambda: np.concatenate(
            [lo.reshape(n_steps, S * CHUNKS, LANE),
             sb8.reshape(n_steps, S * CHUNKS, LANE)],
            axis=1).reshape(-1, LANE),
        "zeros": lambda: np.zeros((n_steps * CHUNKS, LANE), np.int8)}
    tensors = {}

    def get(key: str) -> torch.Tensor:   # each array uploaded once
        if key not in tensors:
            tensors[key] = torch.from_numpy(arrays[key]()).to(device)
        return tensors[key]

    # each mode's (lo, sb, base), proto_v3.py:211-218
    choice = {"nib": ("lo", "sbnib", "base_run"),
              "w128": ("lo", "sb128", "base_w128"),
              "ind8": ("lo", "sb8", "tgt"), "ind8u": ("lo", "sb8", "tgt"),
              "mrg": ("merged", "zeros", "base_run")}
    shared = {k: torch.from_numpy(v).to(device)
              for k, v in (("wg", wg), ("x2d", x2d), ("vals", vals))}
    out = {}
    for mode in modes:
        lo_k, sb_k, base_k = choice.get(mode, ("lo", "sb8", "base_run"))
        out[mode] = Inputs(mode=mode, S=S, out8=out8, lo=get(lo_k),
                           sb=get(sb_k), base=get(base_k), **shared)
    return out


def _slot_streams(inp: Inputs) -> tuple:
    """``(lo, sb)`` as (G, 8, 128), sb unpacked."""
    G = inp.n_groups
    if inp.mode == "mrg":
        m = inp.lo.view(G // inp.S, 2, inp.S * CHUNKS, LANE)
        return m[:, 0].reshape(G, CHUNKS, LANE), m[:, 1].reshape(
            G, CHUNKS, LANE)
    lo = inp.lo.view(G, CHUNKS, LANE)
    if inp.mode == "nib":
        pk = inp.sb.view(G // 2, 1, CHUNKS, LANE).int()
        return lo, torch.cat([pk & 15, pk >> 4], 1).view(G, CHUNKS, LANE)
    return lo, inp.sb.view(G, CHUNKS, LANE)


def probe_plain(inp: Inputs) -> torch.Tensor:
    """P2's plain version, vectorised over runs: masked sums as
    ``where``/``sum`` (``scatter_add_`` for w128), the adds into the output
    with ``index_add_``.  Returns (out8, 128)."""
    n_runs, dev = inp.n_groups // TB, inp.device
    lo, sb = _slot_streams(inp)
    prod = (inp.vals.view(-1, CHUNKS, LANE)
            * window_gather_plain(inp.x2d, inp.wg, lo))
    if inp.mode == "w128":
        return masked_sum_wide_plain(prod.view(n_runs, -1, LANE), sb,
                                     inp.base, inp.out8)
    if inp.mode == "sgather":
        shape = (n_runs, TB, CHUNKS, LANE)
        rows = torch.take_along_dim(prod.view(shape), sb.view(shape).long(),
                                    dim=2).sum(1)
    else:
        p, s = prod.view(n_runs, -1, LANE), sb.view(n_runs, -1, LANE)
        rows = torch.stack([torch.where(s == k, p, 0.0).sum(1)
                            for k in range(CHUNKS)], 1)
    if inp.mode in ("ind8", "ind8u"):
        dst = inp.base.long()
    else:
        dst = (inp.base.long().view(-1, 1) * CHUNKS
               + torch.arange(CHUNKS, device=dev)).reshape(-1)
    out = torch.zeros(inp.out8, LANE, dtype=torch.float32, device=dev)
    return out.index_add_(0, dst, rows.reshape(-1, LANE))


def probe_schedule(inp: Inputs) -> torch.Tensor:
    """w128 in its kernel's order, in plain torch
    (:func:`~.common.masked_sum_wide_schedule`); equal to
    :func:`probe_plain` bit for bit.  Nothing on the card's path calls it.
    Returns (out8, 128)."""
    if inp.mode != "w128":
        raise ValueError(f"mode {inp.mode} adds with atomics: no run order")
    prod = (inp.vals.view(-1, CHUNKS, LANE)
            * window_gather_plain(inp.x2d, inp.wg, inp.lo))
    return masked_sum_wide_schedule(prod.view(inp.n_groups // TB, -1, LANE),
                                    inp.sb, inp.index, inp.out8)


def probe(inp: Inputs) -> torch.Tensor:
    """P2's kernel, ``inp.mode``: launches ``csrc/probe_proto_v3.cu`` for
    CUDA inputs (into a zeroed output; w128 writes every row itself); the
    plain version for CPU ones.  Returns (out8, 128) f32."""
    if inp.device.type == "cpu":
        return probe_plain(inp)
    if inp.device.type != "cuda":
        raise ValueError(f"no probe kernel for {inp.device}")
    idx = inp.index
    out = (torch.zeros if idx is None else torch.empty)(
        inp.out8, LANE, dtype=torch.float32, device=inp.device)
    launch("tsp_probe_proto_v3", inp.x2d, inp.vals, inp.lo, inp.sb, inp.wg,
           inp.base, None if idx is None else idx.ptr,
           None if idx is None else idx.runs,
           0 if idx is None else idx.n_bands,
           0 if idx is None else idx.max_runs, inp.out8, inp.n_groups // TB,
           inp.S, _CODE[inp.mode], out)
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
