"""P4: K1's cost split by stage, on the card (port of
``benchmarks/profile_kernel.py``; kernel ``csrc/probe_profile_kernel.cu``).

The window-ELL fold on a synthetic, fully dense plan, ablated one stage at a
time.  Step i owns groups ``i*S .. i*S + S`` and forms an (8, 128) sum; with
``p = vals * x2d[wg[g]*8 + s, lo]`` per slot:

  stream     sum of vals
  +lo        sum of vals + lo
  +gather    sum of p
  +select    each group's sum of p added at its sublane ``sbg[g]``
  +scatterN  per group, N masked sums of p by the slot's sublane ``sb``;
             sublane k takes sum ``k % N`` (the JAX ``rows * (8 // N)``
             repeats the list)

and adds it into output superblock ``sup[i]``.  The Pallas kernel zeroes
its output at step 0 only, so its later superblocks start from whatever the
buffer holds (NaN in interpret mode); here every superblock starts from
zero: ``out[b]`` is the sum over the steps with ``sup[i] == b``.

    python3 -m tpu_spmv_torch.probes.profile_kernel [n_steps] [S]

prints, for each S, the JAX script's lines (mode, ms, GB/s, ps/slot), timed
on the card with CUDA events over its 300 calls per sample.
"""

from __future__ import annotations

import dataclasses
import sys

import numpy as np
import torch

from ..timing import time_cuda
from .common import (CHUNKS, LANE, check_nondecreasing, check_range,
                     check_tensor, guard, launch, rates, start,
                     window_gather_plain)

MODES = ("stream", "+lo", "+gather", "+select", "+scatter1", "+scatter2",
         "+scatter4", "+scatter8")
# the JAX main's list, +scatter8 twice (profile_kernel.py:126-127)
MAIN_MODES = ("+gather", "+select", "+scatter2", "+scatter4", "+scatter8",
              "+scatter8")
N_STEPS = 512
S_LIST = (16, 32, 64, 128)
N_SUP = 64
COLS8 = 32        # 4096 columns, 4 windows
MAX_COLS8 = 64    # the kernel's shared-memory table (32 KB)
ITERS, SAMPLES = 300, 2   # time_jitted(iters=300) and its 2 samples

# mode -> (stage, N) of tsp_probe_profile_kernel
_STAGE = {"stream": (0, 1), "+lo": (1, 1), "+gather": (2, 1),
          "+select": (3, 1), "+scatter1": (4, 1), "+scatter2": (4, 2),
          "+scatter4": (4, 4), "+scatter8": (4, 8)}


@dataclasses.dataclass(frozen=True)
class Inputs:
    """One mode's arguments (the Pallas call's, ``profile_kernel.py:130``),
    checked when made: the kernel indexes with ``wg``, ``lo`` and ``sup``
    unchecked."""

    mode: str
    n_sup: int
    wg: torch.Tensor    # i32 (G,) window of each group
    sbg: torch.Tensor   # i32 (G,) sublane of each group (+select)
    sup: torch.Tensor   # i32 (n_steps,) superblock of each step, sorted
    x2d: torch.Tensor   # f32 (cols8, 128) gather table
    vals: torch.Tensor  # f32 (G*8, 128)
    lo: torch.Tensor    # i8  (G*8, 128) lane index
    sb8: torch.Tensor   # i8  (G*8, 128) sublane of each slot (+scatterN)

    def __post_init__(self):
        if self.mode not in MODES:
            raise ValueError(f"mode {self.mode!r} not in {MODES}")
        n_steps, G = self.sup.numel(), self.wg.numel()
        if n_steps < 1 or G < n_steps or G % n_steps or self.n_sup < 1:
            raise ValueError(f"{G} groups over {n_steps} steps, "
                             f"{self.n_sup} superblocks")
        cols8 = self.x2d.shape[0]
        if cols8 % CHUNKS or not CHUNKS <= cols8 <= MAX_COLS8:
            raise ValueError(f"cols8={cols8}: a multiple of {CHUNKS} up to "
                             f"{MAX_COLS8} (the kernel's shared-memory table)")
        dev = self.vals.device
        for name, dtype, shape in (
                ("wg", torch.int32, (G,)), ("sbg", torch.int32, (G,)),
                ("sup", torch.int32, (n_steps,)),
                ("x2d", torch.float32, (cols8, LANE)),
                ("vals", torch.float32, (G * CHUNKS, LANE)),
                ("lo", torch.int8, (G * CHUNKS, LANE)),
                ("sb8", torch.int8, (G * CHUNKS, LANE))):
            check_tensor(name, getattr(self, name), dtype, shape, dev)
        check_range("wg", self.wg, 0, cols8 // CHUNKS)
        check_range("lo", self.lo, 0, LANE)
        check_range("sup", self.sup, 0, self.n_sup)
        check_nondecreasing("sup", self.sup)

    @property
    def device(self) -> torch.device:
        return self.vals.device

    @property
    def n_steps(self) -> int:
        return self.sup.numel()

    @property
    def n_groups(self) -> int:
        return self.wg.numel()

    @property
    def S(self) -> int:
        return self.n_groups // self.n_steps

    @property
    def nbytes(self) -> int:
        """The bytes counted per call, as the JAX main counts them (vals and
        lo; sb8 for +scatter8 only), less lo in ``stream``, which does not
        read it."""
        b = self.vals.nbytes + (self.lo.nbytes if self.mode != "stream" else 0)
        return b + (self.sb8.nbytes if self.mode == "+scatter8" else 0)


def make_inputs(n_steps: int = N_STEPS, S: int = 128, seed: int = 0,
                device="cpu", modes=MODES, n_sup: int = N_SUP,
                cols8: int = COLS8) -> dict:
    """The JAX main's arrays for one S, bit for bit, in its draw order from
    a generator made anew for each S (``profile_kernel.py:108-121``);
    ``{mode: Inputs}`` on ``device``, every mode sharing the tensors."""
    n_groups = n_steps * S
    rng = np.random.default_rng(seed)
    vals = rng.random((n_groups * CHUNKS, LANE), np.float32)
    lo = rng.integers(0, LANE, (n_groups * CHUNKS, LANE), dtype=np.int8)
    sb8 = rng.integers(0, 8, (n_groups * CHUNKS, LANE), dtype=np.int8)
    wg = rng.integers(0, cols8 // CHUNKS, (n_groups,), dtype=np.int32)
    sbg = rng.integers(0, 8, (n_groups,), dtype=np.int32)
    sup = np.minimum(np.arange(n_steps) * n_sup // n_steps,
                     n_sup - 1).astype(np.int32)
    x2d = rng.random((cols8, LANE), np.float32)
    t = {k: torch.from_numpy(v).to(device) for k, v in dict(
        wg=wg, sbg=sbg, sup=sup, x2d=x2d, vals=vals, lo=lo, sb8=sb8).items()}
    return {m: Inputs(mode=m, n_sup=n_sup, **t) for m in modes}


def probe_plain(inp: Inputs) -> torch.Tensor:
    """P4's plain version, vectorised over steps and groups; the step sums
    go to their superblocks with ``index_add_``.  Returns (n_sup*8, 128)."""
    shape = (inp.n_steps, inp.S, CHUNKS, LANE)
    v = inp.vals.view(shape)
    if inp.mode == "stream":
        acc = v.sum(1)
    elif inp.mode == "+lo":
        acc = (v + inp.lo.view(shape).float()).sum(1)
    else:
        prod = v * window_gather_plain(inp.x2d, inp.wg, inp.lo).view(shape)
        if inp.mode == "+gather":
            acc = prod.sum(1)
        elif inp.mode == "+select":
            hit = inp.sbg.view(inp.n_steps, inp.S, 1, 1) \
                == torch.arange(CHUNKS, device=inp.device).view(1, 1, -1, 1)
            acc = torch.where(hit, prod.sum(2, keepdim=True), 0.0).sum(1)
        else:
            n_t = _STAGE[inp.mode][1]
            sb = inp.sb8.view(shape)
            rows = torch.stack([torch.where(sb == k, prod, 0.0).sum(2)
                                for k in range(n_t)], 2)
            acc = rows.sum(1).repeat(1, CHUNKS // n_t, 1)
    out = torch.zeros(inp.n_sup, CHUNKS, LANE, dtype=torch.float32,
                      device=inp.device)
    return out.index_add_(0, inp.sup.long(), acc).view(-1, LANE)


def probe(inp: Inputs) -> torch.Tensor:
    """P4's kernel, ``inp.mode``: launches ``csrc/probe_profile_kernel.cu``
    (the stage kernel, then the per-superblock sum of its step partials)
    for CUDA inputs; the plain version for CPU ones.  Returns
    (n_sup*8, 128) f32."""
    if inp.device.type == "cpu":
        return probe_plain(inp)
    if inp.device.type != "cuda":
        raise ValueError(f"no probe kernel for {inp.device}")
    stage, n_t = _STAGE[inp.mode]
    part = torch.empty(inp.n_steps * CHUNKS, LANE, dtype=torch.float32,
                       device=inp.device)
    out = torch.empty(inp.n_sup * CHUNKS, LANE, dtype=torch.float32,
                      device=inp.device)
    launch("tsp_probe_profile_kernel", inp.x2d, inp.x2d.shape[0], inp.vals,
           inp.lo, inp.sb8, inp.wg, inp.sbg, inp.sup, inp.n_steps, inp.S,
           inp.n_sup, stage, n_t, part, out)
    probe.launches += 1
    return out


probe.launches = 0


def time_modes(inputs: dict, stream_gbs: float, modes=MAIN_MODES,
               iters: int = ITERS, samples: int = SAMPLES) -> list:
    """Time each of ``modes`` on the card (``inputs`` from
    :func:`make_inputs` on a CUDA device) and print the JAX script's lines,
    each held to the physics guard against ``stream_gbs``.  Returns a record
    per line."""
    first = inputs[modes[0]]
    print(f"S={first.S:4d} steps={first.n_steps} groups={first.n_groups} "
          f"stream={(first.vals.nbytes + first.lo.nbytes) / 1e6:.0f}MB",
          flush=True)
    recs = []
    for mode in modes:
        inp = inputs[mode]
        secs = time_cuda(lambda: probe(inp), iters=iters, samples=samples,
                         device=inp.device)
        gbs, ps = rates(secs, inp.nbytes, inp.n_groups * CHUNKS * LANE)
        print(f"  {mode:8s} {secs * 1e3:7.3f} ms  {gbs:7.1f} GB/s  "
              f"{ps:6.2f} ps/slot", flush=True)
        guard(f"{mode} S={inp.S}", gbs, stream_gbs)
        recs.append({"mode": mode, "S": inp.S, "ms": secs * 1e3,
                     "gb_s": gbs, "ps_per_slot": ps})
    return recs


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    n_steps = int(argv[0]) if argv else N_STEPS
    s_list = [int(argv[1])] if len(argv) > 1 else S_LIST
    dev, stream = start()
    for S in s_list:
        time_modes(make_inputs(n_steps, S, device=dev, modes=MAIN_MODES),
                   stream)
    return 0


if __name__ == "__main__":
    sys.exit(main())
