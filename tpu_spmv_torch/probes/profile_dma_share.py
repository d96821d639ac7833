"""P5: does re-reading a streamed block cost anything, on the card (port of
``benchmarks/profile_dma_share.py``; kernel ``csrc/probe_dma_share.cu``).

Step i sums block ``blk[i]`` (block i in ``direct``) of S (8, 128) tiles into
output block ``oi[i]``, which starts from zero where ``oi`` changes
(``profile_dma_share.py:29-34``; ``oi`` is non-decreasing, so ``out[o]`` is
the sum over the steps with ``oi[i] == o``).  The modes are the JAX main's
``reuse`` values: ``direct`` (reuse 1, the block index is the step), and
``reuseN``, each block named by N steps in a row.  On the TPU the question
was whether Pallas skips the DMA of a block the previous step fetched; on
the card it is whether a block read again right away comes from the L2: the
time stays flat as N grows if it does, and grows with N if it does not.

    python3 -m tpu_spmv_torch.probes.profile_dma_share

prints the JAX script's lines (reuse, ms, GB/s, ns/step), timed on the card
with CUDA events.
"""

from __future__ import annotations

import dataclasses
import sys

import numpy as np
import torch

from ..timing import time_cuda
from .common import (CHUNKS, LANE, check_nondecreasing, check_range,
                     check_tensor, guard, launch, rates, start)

MODES = ("direct", "reuse1", "reuse2", "reuse4", "reuse8")
MAIN_MODES = MODES
N_BLOCKS, S_DEFAULT, N_OUT = 256, 128, 64
ITERS, SAMPLES = 20, 2   # time_jitted(iters=20) and its 2 samples


def reuse_of(mode: str) -> int:
    """Steps per block: 1 for ``direct``, N for ``reuseN``."""
    if mode == "direct":
        return 1
    if not (mode.startswith("reuse") and mode[5:].isdigit()
            and int(mode[5:]) > 0):
        raise ValueError(f"mode {mode!r}: direct or reuseN")
    return int(mode[5:])


@dataclasses.dataclass(frozen=True)
class Inputs:
    """One mode's arguments (the Pallas call's, ``profile_dma_share.py:72``),
    checked when made: the kernel indexes with ``blk`` and ``oi``
    unchecked."""

    mode: str
    S: int
    n_out: int
    blk: torch.Tensor   # i32 (n_steps,) block of each step (not read direct)
    oi: torch.Tensor    # i32 (n_steps,) output block, non-decreasing
    vals: torch.Tensor  # f32 (n_blocks*S*8, 128)

    def __post_init__(self):
        reuse_of(self.mode)
        n_steps, rows = self.blk.numel(), self.vals.shape[0]
        if self.S < 1 or rows % (self.S * CHUNKS) or n_steps < 1 \
                or self.n_out < 1:
            raise ValueError(f"{rows} rows in blocks of S={self.S}, "
                             f"{n_steps} steps, {self.n_out} outputs")
        n_blocks = rows // (self.S * CHUNKS)
        dev = self.vals.device
        for name, dtype, shape in (("blk", torch.int32, (n_steps,)),
                                   ("oi", torch.int32, (n_steps,)),
                                   ("vals", torch.float32, (rows, LANE))):
            check_tensor(name, getattr(self, name), dtype, shape, dev)
        if self.direct and n_steps > n_blocks:
            raise ValueError(f"direct: {n_steps} steps, {n_blocks} blocks")
        check_range("blk", self.blk, 0, n_blocks)
        check_range("oi", self.oi, 0, self.n_out)
        check_nondecreasing("oi", self.oi)
        if dev.type == "cuda" and self.vals.data_ptr() % 16:
            raise ValueError("vals must be 16-byte aligned (float4 loads)")

    @property
    def device(self) -> torch.device:
        return self.vals.device

    @property
    def direct(self) -> bool:
        return self.mode == "direct"

    @property
    def n_steps(self) -> int:
        return self.blk.numel()

    @property
    def n_blocks(self) -> int:
        return self.vals.shape[0] // (self.S * CHUNKS)

    @property
    def nbytes(self) -> int:
        """The bytes counted per call, as the JAX main counts them: the
        values once, however often a block is read."""
        return self.vals.nbytes


def make_inputs(n_blocks: int = N_BLOCKS, S: int = S_DEFAULT,
                n_out: int = N_OUT, seed: int = 0, device="cpu",
                modes=MAIN_MODES) -> dict:
    """The JAX main's arrays, bit for bit (``profile_dma_share.py:57-69``):
    the values from the generator, ``blk`` and ``oi`` from the mode;
    ``{mode: Inputs}`` on ``device``, sharing the values."""
    rng = np.random.default_rng(seed)
    vals = torch.from_numpy(
        rng.random((n_blocks * S * CHUNKS, LANE), np.float32)).to(device)
    out = {}
    for mode in modes:
        reuse = reuse_of(mode)
        n_steps = n_blocks * reuse
        blk = np.repeat(np.arange(n_blocks, dtype=np.int32), reuse)
        oi = (np.arange(n_steps, dtype=np.int64) * n_out
              // n_steps).astype(np.int32)
        out[mode] = Inputs(mode=mode, S=S, n_out=n_out,
                           blk=torch.from_numpy(blk).to(device),
                           oi=torch.from_numpy(oi).to(device), vals=vals)
    return out


def probe_plain(inp: Inputs) -> torch.Tensor:
    """P5's plain version: every block's sum once, each step's picked by
    index, added into its output block with ``index_add_``.  Returns
    (n_out*8, 128)."""
    sums = inp.vals.view(inp.n_blocks, inp.S, CHUNKS, LANE).sum(1)
    b = torch.arange(inp.n_steps, device=inp.device) if inp.direct \
        else inp.blk.long()
    out = torch.zeros(inp.n_out, CHUNKS, LANE, dtype=torch.float32,
                      device=inp.device)
    return out.index_add_(0, inp.oi.long(), sums[b]).view(-1, LANE)


def probe(inp: Inputs) -> torch.Tensor:
    """P5's kernel, ``inp.mode``: launches ``csrc/probe_dma_share.cu`` (the
    block sums, then the per-output-block sum of their partials) for CUDA
    inputs; the plain version for CPU ones.  Returns (n_out*8, 128) f32."""
    if inp.device.type == "cpu":
        return probe_plain(inp)
    if inp.device.type != "cuda":
        raise ValueError(f"no probe kernel for {inp.device}")
    part = torch.empty(inp.n_steps * CHUNKS, LANE, dtype=torch.float32,
                       device=inp.device)
    out = torch.empty(inp.n_out * CHUNKS, LANE, dtype=torch.float32,
                      device=inp.device)
    launch("tsp_probe_dma_share", inp.vals, inp.blk, inp.oi, inp.n_steps,
           inp.S, inp.n_out, int(inp.direct), part, out)
    probe.launches += 1
    return out


probe.launches = 0


def time_modes(inputs: dict, stream_gbs: float, modes=MAIN_MODES,
               iters: int = ITERS, samples: int = SAMPLES) -> list:
    """Time each of ``modes`` on the card and print the JAX script's lines
    (its header, then reuse, ms, GB/s, ns/step), each held to the physics
    guard against ``stream_gbs``.  Returns a record per line."""
    first = inputs[modes[0]]
    print(f"data: {first.vals.nbytes / 1e6:.0f} MB, S={first.S}, "
          f"blocks={first.n_blocks}", flush=True)
    recs = []
    for mode in modes:
        inp = inputs[mode]
        secs = time_cuda(lambda: probe(inp), iters=iters, samples=samples,
                         device=inp.device)
        gbs, _ = rates(secs, inp.nbytes, 1)
        reuse = reuse_of(mode)
        print(f"  reuse={reuse}{' direct' if inp.direct else ''}: "
              f"{secs * 1e3:7.3f} ms  {gbs:7.1f} GB/s "
              f"({secs / inp.n_steps * 1e9:6.0f} ns/step)", flush=True)
        guard(mode, gbs, stream_gbs)
        recs.append({"mode": mode, "ms": secs * 1e3, "gb_s": gbs,
                     "ns_per_step": secs / inp.n_steps * 1e9})
    return recs


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv:
        raise SystemExit("profile_dma_share takes no arguments")
    dev, stream = start()
    time_modes(make_inputs(device=dev), stream)
    return 0


if __name__ == "__main__":
    sys.exit(main())
