"""Device timing with CUDA events (port of ``tpu_spmv/timing.py``).

The JAX package chains calls inside one jitted loop and differences two loop
lengths, to get past a remote TPU's round trip.  On a local GPU a pair of
CUDA events around a run of calls measures the device time directly:
warm up, then take the median over samples of the mean time per call.
"""

from __future__ import annotations

import statistics
from typing import Callable, Sequence

import torch


def time_cuda(fn: Callable[[], object], iters: int = 100, samples: int = 5,
              warmup: int = 10, device=None) -> float:
    """Median over ``samples`` of the mean seconds per ``fn()`` call, each
    sample timing ``iters`` back-to-back calls between two CUDA events on
    the current stream.  Raises when no CUDA device is present, or when
    ``device`` is not a CUDA device: a device time is never taken on the
    CPU."""
    return time_turns([fn], iters, samples, warmup, device)[0]


def time_turns(fns: Sequence[Callable[[], object]], iters: int = 100,
               samples: int = 5, warmup: int = 10,
               device=None) -> list:
    """:func:`time_cuda` of each of ``fns``, in turns: each sample times
    ``iters`` calls of every function in order, so a drift in the host's
    speed (which sets the time of a launch-bound call) falls on all of
    them alike.  Returns seconds per call, one per function."""
    if not torch.cuda.is_available() or (
            device is not None and torch.device(device).type != "cuda"):
        raise RuntimeError(f"time_cuda needs a CUDA device, not {device}")
    for fn in fns:
        for _ in range(warmup):
            fn()
    torch.cuda.synchronize(device)
    per_call = [[] for _ in fns]
    for _ in range(samples):
        for fn, times in zip(fns, per_call):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                fn()
            stop.record()
            stop.synchronize()
            times.append(start.elapsed_time(stop) / 1e3 / iters)
    return [statistics.median(t) for t in per_call]
