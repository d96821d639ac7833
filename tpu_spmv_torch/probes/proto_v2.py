"""P1: the round-2 inner-loop candidates, on the card (port of
``benchmarks/proto_v2.py``; kernel ``csrc/probe_proto_v2.cu``).

Every mode gathers and multiplies, ``p = vals * tab[wg[g]*8 + s, lo]``, over
sub-tiles of T groups, and adds into an output of ``cols8 + out8`` rows that
is resident for the whole call:

  gather   per sublane s, the sum over all groups of p, added to the fixed
           rows ``cols8 + s`` and ``cols8 + 8 + s`` (``proto_v2.py:69-71``)
  v1x16    16 masked sums by ``sb`` into the fixed rows ``cols8 + k``
  v2s8     8 masked sums by ``sb`` per sub-tile of 8 groups, added at rows
           ``base[first group]*8 + k``
  v2s16    the same over sub-tiles of 16 groups
  v2b8     16-group sub-tiles, added per half (8 groups) at its own base
  v2g16    8 masked sums per group, added at the group's base

T is 16 for gather, v1x16 and v2b8, else the mode's suffix
(``proto_v2.py:35-39``).  The v3 forms (v3gather, v3s8, v3s16, v3b8, v3g16)
gather from a separate copy of x2d.  The v2 forms, gather and v1x16 gather
from the output's own first ``cols8`` rows.  The Pallas probe zeroes them at
step 0 and nothing writes them, so every product is 0 and its output is all
zeros (fault F5, ROADMAP Queue 3).  The port defines those modes to gather
from the head rows after the wrapper has seeded them with x2d: a v2 mode
computes what its v3 twin computes, and its head rows hold x2d.  The
wrapper refuses a base whose rows fall below ``cols8``, where the kernel's
adds would race with its gathers.

S must be a multiple of the mode's T: the Pallas loop over ``S // T``
sub-tiles drops the groups past the last whole one, so the port refuses
such an S with ``ValueError``.  The kernel adds with atomics, so it matches
the plain version to fp32 rounding in another order, not bit for bit.

    python3 -m tpu_spmv_torch.probes.proto_v2 [n_steps] [S]

prints the JAX script's header and its line per mode of its list (mode, ms,
GB/s, ps/slot), timed on the card with CUDA events.
"""

from __future__ import annotations

import dataclasses
import sys

import numpy as np
import torch

from .common import (CHUNKS, LANE, check_range, check_tensor, guard, launch,
                     rates, start, window_gather_plain)

MODES = ("gather", "v1x16", "v2s8", "v2s16", "v2b8", "v2g16",
         "v3gather", "v3s8", "v3s16", "v3b8", "v3g16")
MAIN_MODES = ("v3s16", "v3s8", "v3b8", "v3s16", "v3s8", "v3b8")
N_STEPS, S_DEFAULT = 128, 128
COLS8 = 32
OUT8 = 2048          # 256K rows of scatter space
ITERS, SAMPLES = 300, 2   # time_jitted(iters=300), two samples

# base mode -> (mode code of tsp_probe_proto_v2, T, groups per base unit;
# 0 for the fixed-row modes)
_MODE = {"gather": (0, 16, 0), "v1x16": (1, 16, 0), "v2s8": (2, 8, 8),
         "v2s16": (3, 16, 16), "v2b8": (4, 16, 8), "v2g16": (5, 16, 1)}


def base_mode(mode: str) -> str:
    """The mode without its table form (``proto_v2.py:35``)."""
    return mode.replace("v3", "v2").replace("v2gather", "gather")


def twin(mode: str) -> str | None:
    """The v3 form of a mode that gathers from the output (v1x16 has
    none)."""
    if mode == "gather":
        return "v3gather"
    return "v3" + mode[2:] if mode.startswith("v2") else None


@dataclasses.dataclass(frozen=True)
class Inputs:
    """One mode's arguments (the Pallas call's, ``proto_v2.py:155``),
    checked when made: the kernel indexes with ``wg``, ``lo`` and ``base``
    unchecked."""

    mode: str
    S: int
    out8: int
    wg: torch.Tensor    # i32 (G,)
    base: torch.Tensor  # i32 (G,) per-group bases, in units of 8 rows
    x2d: torch.Tensor   # f32 (cols8, 128)
    vals: torch.Tensor  # f32 (G*8, 128)
    lo: torch.Tensor    # i8 (G*8, 128)
    sb: torch.Tensor    # i8 (G*8, 128)

    def __post_init__(self):
        if self.mode not in MODES:
            raise ValueError(f"mode {self.mode!r} not in {MODES}")
        T = self.T
        if self.S <= 0 or self.S % T:
            raise ValueError(f"S={self.S} is not a multiple of T={T}: the "
                             f"Pallas loop over S // T sub-tiles would drop "
                             f"groups")
        G = self.wg.numel()
        if G < 1 or G % self.S:
            raise ValueError(f"{G} groups in steps of S={self.S}")
        cols8 = self.x2d.shape[0]
        if cols8 < CHUNKS or cols8 % CHUNKS:
            raise ValueError(f"cols8={cols8}: a multiple of {CHUNKS}")
        if self.out8 < 16 or self.out8 % CHUNKS:
            raise ValueError(f"out8={self.out8}: a multiple of {CHUNKS}, "
                             f"at least the 16 fixed rows")
        dev = self.vals.device
        for name, dtype, shape in (
                ("wg", torch.int32, (G,)), ("base", torch.int32, (G,)),
                ("x2d", torch.float32, (cols8, LANE)),
                ("vals", torch.float32, (G * CHUNKS, LANE)),
                ("lo", torch.int8, (G * CHUNKS, LANE)),
                ("sb", torch.int8, (G * CHUNKS, LANE))):
            check_tensor(name, getattr(self, name), dtype, shape, dev)
        check_range("wg", self.wg, 0, cols8 // CHUNKS)
        check_range("lo", self.lo, 0, LANE)
        if self.unit:
            # every destination at or past the head rows the modes gather
            # from, and inside the output
            check_range("base", self.base, cols8 // CHUNKS,
                        (cols8 + self.out8) // CHUNKS)

    @property
    def T(self) -> int:
        return _MODE[base_mode(self.mode)][1]

    @property
    def unit(self) -> int:
        """Groups that share one base (0: the fixed-row modes)."""
        return _MODE[base_mode(self.mode)][2]

    @property
    def split(self) -> bool:
        """The v3 form: the table is a copy of x2d, not the output."""
        return self.mode.startswith("v3")

    @property
    def cols8(self) -> int:
        return self.x2d.shape[0]

    @property
    def device(self) -> torch.device:
        return self.vals.device

    @property
    def n_groups(self) -> int:
        return self.wg.numel()

    @property
    def n_steps(self) -> int:
        return self.n_groups // self.S

    @property
    def nbytes(self) -> int:
        """The bytes counted per call, as the JAX main counts them (vals,
        lo, sb), less ``sb`` in the gather modes, which do not read it."""
        return self.vals.nbytes + self.lo.nbytes \
            + (0 if base_mode(self.mode) == "gather" else self.sb.nbytes)


def make_inputs(n_steps: int = N_STEPS, S: int = S_DEFAULT,
                out8: int = OUT8, cols8: int = COLS8, seed: int = 0,
                device="cpu", modes=MODES) -> dict:
    """The JAX main's arrays, bit for bit, in its draw order
    (``proto_v2.py:136-149``); ``{mode: Inputs}`` on ``device``, every mode
    sharing the same tensors."""
    n_groups = n_steps * S
    rng = np.random.default_rng(seed)
    vals = rng.random((n_groups * CHUNKS, LANE)).astype(np.float32)
    lo = rng.integers(0, LANE, (n_groups * CHUNKS, LANE), dtype=np.int8)
    sb8 = rng.integers(0, 8, (n_groups * CHUNKS, LANE), dtype=np.int8)
    wg = rng.integers(0, cols8 // CHUNKS, (n_groups,), dtype=np.int32)
    base = (cols8 // 8 + rng.integers(0, out8 // 8 - 1, (n_groups,))) * 1
    base = base.astype(np.int32)
    x2d = rng.random((cols8, LANE)).astype(np.float32)
    t = {k: torch.from_numpy(v).to(device)
         for k, v in (("wg", wg), ("base", base), ("x2d", x2d),
                      ("vals", vals), ("lo", lo), ("sb", sb8))}
    return {mode: Inputs(mode=mode, S=S, out8=out8, **t) for mode in modes}


def _output(inp: Inputs) -> torch.Tensor:
    """The zeroed output, its head rows seeded with x2d where the mode
    gathers from them."""
    out = torch.zeros(inp.cols8 + inp.out8, LANE, dtype=torch.float32,
                      device=inp.device)
    if not inp.split:
        out[:inp.cols8] = inp.x2d
    return out


def probe_plain(inp: Inputs) -> torch.Tensor:
    """P1's plain version, vectorised over groups: the gathers from x2d
    (the values of the seeded head rows), masked sums as ``where``/``sum``,
    the adds into the output with ``index_add_``.  Returns
    (cols8 + out8, 128)."""
    G, cols8 = inp.n_groups, inp.cols8
    prod = (inp.vals.view(G, CHUNKS, LANE)
            * window_gather_plain(inp.x2d, inp.wg, inp.lo))
    out = _output(inp)
    sb = inp.sb.view(G, CHUNKS, LANE)
    mode = base_mode(inp.mode)
    if mode == "gather":
        s = prod.sum(0)
        out[cols8:cols8 + 16] += torch.cat([s, s])
    elif mode == "v1x16":
        out[cols8:cols8 + 16] += torch.stack(
            [torch.where(sb == k, prod, 0.0).sum((0, 1)) for k in range(16)])
    else:
        U = inp.unit
        p, s = prod.view(G // U, -1, LANE), sb.view(G // U, -1, LANE)
        rows = torch.stack([torch.where(s == k, p, 0.0).sum(1)
                            for k in range(CHUNKS)], 1)
        dst = (inp.base[::U].long().view(-1, 1) * CHUNKS
               + torch.arange(CHUNKS, device=inp.device)).reshape(-1)
        out.index_add_(0, dst, rows.reshape(-1, LANE))
    return out


def probe(inp: Inputs) -> torch.Tensor:
    """P1's kernel, ``inp.mode``: launches ``csrc/probe_proto_v2.cu`` for
    CUDA inputs, into a zeroed output whose head rows it first seeds with
    x2d where the mode gathers from them; the plain version for CPU inputs.
    Returns (cols8 + out8, 128) f32."""
    if inp.device.type == "cpu":
        return probe_plain(inp)
    if inp.device.type != "cuda":
        raise ValueError(f"no probe kernel for {inp.device}")
    out = _output(inp)
    launch("tsp_probe_proto_v2", inp.x2d, inp.vals, inp.lo, inp.sb, inp.wg,
           inp.base, inp.n_steps, inp.S, inp.cols8,
           _MODE[base_mode(inp.mode)][0], int(inp.split), out)
    probe.launches += 1
    return out


probe.launches = 0


def time_modes(inputs: dict, stream_gbs: float, modes=MAIN_MODES,
               iters: int = ITERS, samples: int = SAMPLES) -> list:
    """Time each of ``modes`` on the card and print the JAX script's header
    and line for it, each held to the physics guard against
    ``stream_gbs``.  Returns a record per line."""
    from ..timing import time_cuda

    first = inputs[modes[0]]
    print(f"steps={first.n_steps} S={first.S} groups={first.n_groups} "
          f"stream={first.nbytes / 1e6:.0f}MB", flush=True)
    recs = []
    for mode in modes:
        inp = inputs[mode]
        secs = time_cuda(lambda: probe(inp), iters=iters, samples=samples,
                         device=inp.device)
        gbs, ps = rates(secs, inp.nbytes, inp.n_groups * CHUNKS * LANE)
        print(f"  {mode:7s} {secs * 1e3:7.3f} ms  {gbs:7.1f} GB/s  "
              f"{ps:6.2f} ps/slot", flush=True)
        guard(mode, gbs, stream_gbs)
        recs.append({"mode": mode, "ms": secs * 1e3, "gb_s": gbs,
                     "ps_per_slot": ps})
    return recs


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    n_steps = int(argv[0]) if len(argv) > 0 else N_STEPS
    S = int(argv[1]) if len(argv) > 1 else S_DEFAULT
    dev, stream = start()
    modes = tuple(dict.fromkeys(MAIN_MODES))
    time_modes(make_inputs(n_steps, S, device=dev, modes=modes), stream,
               MAIN_MODES)
    return 0


if __name__ == "__main__":
    sys.exit(main())
