"""Device timing with CUDA events (port of ``tpu_spmv/timing.py``).

The JAX package chains calls inside one jitted loop and differences two loop
lengths, to get past a remote TPU's round trip.  On a local GPU a pair of
CUDA events around a run of calls measures the device time directly:
warm up, then take the median over samples of the mean time per call.
"""

from __future__ import annotations

import statistics
from typing import Callable

import torch


def time_cuda(fn: Callable[[], object], iters: int = 100, samples: int = 5,
              warmup: int = 10, device=None) -> float:
    """Median over ``samples`` of the mean seconds per ``fn()`` call, each
    sample timing ``iters`` back-to-back calls between two CUDA events on
    the current stream.  Raises when no CUDA device is present: a device
    time is never taken on the CPU."""
    if not torch.cuda.is_available():
        raise RuntimeError("time_cuda needs a CUDA device")
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize(device)
    per_call = []
    for _ in range(samples):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        stop.record()
        stop.synchronize()
        per_call.append(start.elapsed_time(stop) / 1e3 / iters)
    return statistics.median(per_call)
