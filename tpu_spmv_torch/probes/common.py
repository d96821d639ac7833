"""What the four probe ports share: the probes' tile constants, the plain
window gather, input checks, the kernel launch, and the timed line with its
physics guard."""

from __future__ import annotations

import ctypes
import dataclasses
import subprocess
import time

import numpy as np
import torch

from ..errors import DeviceException

LANE = 128
CHUNKS = 8
T = 16      # groups per sub-tile of P2 and P3 (their Pallas loop S // T)
TB = 8      # groups per scatter run (half a sub-tile)
GUARD = 1.02  # a printed GB/s above GUARD x measured STREAM is refused
WIDE = 128    # targets of the wide masked sum: one 128-row block a run


def window_gather_plain(x2d: torch.Tensor, wg: torch.Tensor,
                        lo: torch.Tensor) -> torch.Tensor:
    """``g[k, c, l] = x2d[wg[k]*8 + c, lo[k*8 + c, l]]`` for every group k:
    ``take_along_axis(table, lo, axis=1)`` on group k's (8, 128) window, the
    lane index picking within the same sublane row
    (``benchmarks/profile_kernel.py:55-57``).  Returns (G, 8, 128)."""
    rows = wg.long().view(-1, 1) * CHUNKS \
        + torch.arange(CHUNKS, device=wg.device)
    return torch.take_along_dim(x2d[rows], lo.view(-1, CHUNKS, LANE).long(),
                                dim=2)


def check_tensor(name: str, t: torch.Tensor, dtype: torch.dtype,
                 shape: tuple, device: torch.device) -> None:
    if t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: want {dtype} {tuple(shape)}, got "
                         f"{t.dtype} {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name} on {t.device}, want {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def check_aligned(inp, names) -> None:
    """The streams the tile kernels copy through the TMA (and the products
    pass reads as float4) start on 16 bytes."""
    for name in names:
        if getattr(inp, name).data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned (TMA boxes)")


def check_range(name: str, t: torch.Tensor, lo: int, hi: int) -> None:
    """Every value of ``t`` in ``[lo, hi)``: the kernels index with it
    unchecked."""
    if t.numel() and (int(t.min()) < lo or int(t.max()) >= hi):
        raise ValueError(f"{name}: values outside [{lo}, {hi})")


def check_nondecreasing(name: str, t: torch.Tensor) -> None:
    if t.numel() > 1 and bool((t[1:] < t[:-1]).any()):
        raise ValueError(f"{name} must be non-decreasing")


def check_multiple_of_t(S: int) -> None:
    if S <= 0 or S % T:
        raise ValueError(f"S={S} is not a multiple of T={T}: the Pallas "
                         f"loop over S // T sub-tiles would drop groups")


def launch(fn: str, *args) -> None:
    """Call ``fn`` of the kernels library with ``args`` (a tensor goes as its
    data pointer) and the current stream of the tensors' device, that
    device made current; raises
    :class:`DeviceException` when the launch returns a CUDA error."""
    from ..kernels._build import kernels
    from ..kernels.window_ell import on_device

    dev = next(a.device for a in args if isinstance(a, torch.Tensor))
    ptrs = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    with on_device(dev.index):     # the attribute P1 sets is per device
        err = getattr(kernels(), fn)(
            *ptrs,
            ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    if err:
        raise DeviceException(f"{fn} launch: cudaError {err}")


def require_cuda(device=None) -> torch.device:
    """The CUDA device to run a probe on; raises where there is none: a probe
    measures the card, never the CPU."""
    if not torch.cuda.is_available():
        raise RuntimeError("the probes time their kernels on an NVIDIA GPU; "
                           "no CUDA device is available")
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda":
        raise RuntimeError(f"the probes run on a CUDA device, not {dev}")
    return dev


@dataclasses.dataclass(frozen=True)
class RunIndex:
    """The run index of the owner-computes kernels (``masked_sum_wide`` in
    ``csrc/probe_common.cuh``, ``scatter_tiles`` in
    ``csrc/probe_proto_v4.cu``): the output cut into bands of
    ``band_rows`` rows, each band into tiles of a slice of lanes, one CTA a
    tile; ``runs[ptr[b]:ptr[b+1]]`` are the runs whose output rows touch
    band ``b``, in run order."""

    band_rows: int
    ptr: torch.Tensor    # i32 (n_bands + 1,)
    runs: torch.Tensor   # i32 (run, band) overlaps, band by band
    max_runs: int        # the most runs of a band (a CTA copies its list)

    @property
    def n_bands(self) -> int:
        return self.ptr.numel() - 1

    @property
    def nbytes(self) -> int:
        return self.ptr.nbytes + self.runs.nbytes

    def band(self, b: int) -> list:
        """The runs of band ``b``, in order."""
        lo, hi = self.ptr[b:b + 2].tolist()
        return self.runs[lo:hi].tolist()


def run_index(base: torch.Tensor, unit: int, span: int, out8: int,
              band_rows: int) -> RunIndex:
    """The run index of runs that cover output rows ``base[r]*unit ..
    base[r]*unit + span`` (of ``out8``) in bands of ``band_rows`` rows, on
    ``base``'s device; built with NumPy."""
    if band_rows <= 0:
        raise ValueError(f"band_rows={band_rows}")
    first = base.cpu().numpy().astype(np.int64) * unit
    last = np.minimum(first + span, out8) - 1
    b0 = first // band_rows
    counts = np.maximum(last // band_rows - b0 + 1, 0)
    run = np.repeat(np.arange(first.size), counts)
    starts = np.repeat(np.cumsum(counts) - counts, counts)
    band = np.repeat(b0, counts) + np.arange(run.size) - starts
    order = np.argsort(band, kind="stable")      # run order within a band
    n_bands = -(-out8 // band_rows)
    per_band = np.bincount(band, minlength=n_bands)
    ptr = np.concatenate([[0], np.cumsum(per_band)])
    return RunIndex(band_rows,
                    torch.from_numpy(ptr.astype(np.int32)).to(base.device),
                    torch.from_numpy(run[order].astype(np.int32))
                    .to(base.device), int(per_band.max(initial=0)))


def check_run_index(index: RunIndex, n_runs: int, out8: int,
                    device: torch.device, band_rows: int) -> None:
    """What the tile kernels index with unchecked: the offsets, the run
    numbers, the longest list, a band count that covers ``out8`` rows; and
    the ``band_rows`` the kernel is built for."""
    if index.band_rows != band_rows:
        raise ValueError(f"run index: bands of {index.band_rows} rows, the "
                         f"kernel's are {band_rows}")
    n_bands = -(-out8 // index.band_rows)
    check_tensor("index.ptr", index.ptr, torch.int32, (n_bands + 1,), device)
    check_tensor("index.runs", index.runs, torch.int32,
                 (index.runs.numel(),), device)
    check_nondecreasing("index.ptr", index.ptr)
    if int(index.ptr[0]) != 0 or int(index.ptr[-1]) != index.runs.numel():
        raise ValueError("index.ptr must run from 0 to len(index.runs)")
    if int((index.ptr[1:] - index.ptr[:-1]).max()) > index.max_runs:
        raise ValueError("index.max_runs is below a band's runs")
    check_range("index.runs", index.runs, 0, n_runs)


def masked_sum_wide_plain(prod: torch.Tensor, sb: torch.Tensor,
                          base: torch.Tensor, out8: int) -> torch.Tensor:
    """The plain wide masked sum (P2's ``w128``, P3's ``msum128``): per run,
    the (64, 128) products summed into 128 targets by ``sb``, added at rows
    ``base[r]*128 + k`` of a zero (out8, 128) output."""
    n_runs = prod.shape[0]
    rows = torch.zeros(n_runs, 128, LANE, dtype=torch.float32,
                       device=prod.device)
    rows.scatter_add_(1, sb.reshape(n_runs, -1, LANE).long(), prod)
    dst = base.long().view(-1, 1) * 128 \
        + torch.arange(128, device=prod.device)
    out = torch.zeros(out8, LANE, dtype=torch.float32, device=prod.device)
    return out.index_add_(0, dst.reshape(-1), rows.reshape(-1, LANE))


def masked_sum_wide_schedule(prod: torch.Tensor, sb: torch.Tensor,
                             index: RunIndex, out8: int) -> torch.Tensor:
    """The wide masked sum in ``masked_sum_wide``'s order, in plain torch:
    block by block (a band of the run index), the block's runs in index
    order, each run's 64 products summed into 128 targets slot by slot from
    zero, then added into the block's tile, which is written once.  Every
    lane at once: lanes are independent, so the kernel's lane slices change
    no sum.  Equal to :func:`masked_sum_wide_plain` bit for bit."""
    n_runs = prod.shape[0]
    sb = sb.reshape(n_runs, -1, LANE).long()
    lanes = torch.arange(LANE, device=prod.device)
    out = torch.zeros(out8, LANE, dtype=torch.float32, device=prod.device)
    for b in range(index.n_bands):
        tile = torch.zeros(WIDE, LANE, dtype=torch.float32,
                           device=prod.device)
        for r in index.band(b):
            sums = torch.zeros_like(tile)
            for s in range(prod.shape[1]):
                sums[sb[r, s], lanes] += prod[r, s]
            tile += sums
        out[b * WIDE:(b + 1) * WIDE] = tile[:out8 - b * WIDE]
    return out


def start(device=None) -> tuple:
    """Open a probe's run: require a CUDA device, measure STREAM on it, print
    the card's line; returns ``(device, STREAM GB/s)``."""
    from ..bandwidth import measured_stream_bandwidth

    dev = require_cuda(device)
    stream = measured_stream_bandwidth(dev)
    print(f"device: {torch.cuda.get_device_name(dev)}; nvidia-smi: "
          f"{card()}; STREAM (256 MB read-reduce) {stream:.1f} GB/s",
          flush=True)
    return dev, stream


def card() -> str:
    """The card's name and power limit, as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def rates(secs: float, nbytes: int, n_slots: int) -> tuple:
    """``(GB/s, ps per slot)`` of one call."""
    return nbytes / secs / 1e9, secs / n_slots * 1e12


def guard(what: str, gbs: float, stream_gbs: float) -> None:
    """Raise when a printed rate exceeds ``GUARD`` x the measured STREAM:
    every byte a probe counts is read from device memory at least once per
    call, so a higher rate is a wrong count or a wrong time."""
    if gbs > GUARD * stream_gbs:
        raise RuntimeError(f"physics guard: {what} {gbs:.1f} GB/s > "
                           f"{GUARD} x STREAM {stream_gbs:.1f} GB/s")


def time_run_modes(probe, inputs: dict, stream_gbs: float, modes,
                   iters: int, samples: int) -> list:
    """P2's and P3's timed lines: per mode, the first call timed apart (the
    library's build and load included, where the JAX scripts time their
    compile), then ``time_cuda`` over ``iters`` calls a sample, printed as
    the JAX scripts print it and held to the physics guard against
    ``stream_gbs``.  Returns a record per line."""
    from ..timing import time_cuda

    recs = []
    for mode in modes:
        inp = inputs[mode]
        t0 = time.perf_counter()
        probe(inp)
        torch.cuda.synchronize(inp.device)
        first_s = time.perf_counter() - t0
        secs = time_cuda(lambda: probe(inp), iters=iters, samples=samples,
                         device=inp.device)
        gbs, ps = rates(secs, inp.nbytes, inp.n_groups * CHUNKS * LANE)
        print(f"{mode:8s} {secs * 1e3:7.3f} ms  {gbs:7.1f} GB/s  "
              f"{ps:6.2f} ps/slot  (first call {first_s:.1f}s, stream "
              f"{inp.nbytes / 1e6:.0f} MB)", flush=True)
        guard(mode, gbs, stream_gbs)
        recs.append({"mode": mode, "ms": secs * 1e3, "gb_s": gbs,
                     "ps_per_slot": ps})
    return recs
