"""Tracing and profiling (port of ``tpu_spmv/profiling.py``).

* :func:`trace`: ``torch.profiler.profile`` around the enclosed block, CPU
  activities and, where a card is present, CUDA ones (every kernel launch,
  the port's own among them), written as a Chrome trace into ``log_dir``;
* :func:`annotate`: a named region in such a trace
  (``torch.profiler.record_function``), and an NVTX range on the card;
* :func:`cost_analysis` and :func:`memory_analysis`: the FLOPs and memory
  sizes of one call of a function;
* :func:`roofline_report`: a measured plan time against the plan's
  streamed bytes and the measured STREAM rate.

``start_server`` has no PyTorch counterpart (PyTorch has no live profiler
endpoint): it raises ``NotImplementedError`` naming :func:`trace`.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Any, Callable

import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """Trace the enclosed block into ``log_dir`` as a Chrome trace
    (``trace_<pid>_<ns>.json``, for ``chrome://tracing`` or Perfetto)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


def start_server(port: int = 9012):
    """The JAX package's live profiler endpoint: PyTorch has none."""
    raise NotImplementedError(
        "PyTorch has no live profiler endpoint; capture a trace with "
        "tpu_spmv_torch.profiling.trace(log_dir) instead")


@contextlib.contextmanager
def annotate(name: str):
    """A named region in captured traces, and an NVTX range on the card."""
    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


def cost_analysis(fn: Callable, *args, **kwargs) -> dict[str, Any]:
    """``{"flops": n}`` for one call of ``fn(*args, **kwargs)``, counted by
    ``torch.utils.flop_counter.FlopCounterMode`` over the PyTorch operators
    it dispatches (matrix products, convolutions, attention).  The port's
    own kernels are invisible to it: a call through ctypes dispatches no
    operator, so an SpMV counts no FLOPs."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn(*args, **kwargs)
    return {"flops": float(counter.get_total_flops())}


def _nbytes(obj) -> int:
    """Bytes of the tensors in ``obj`` (a tensor, or a tuple, list or dict
    of them)."""
    if isinstance(obj, torch.Tensor):
        return obj.numel() * obj.element_size()
    if isinstance(obj, dict):
        obj = list(obj.values())
    if isinstance(obj, (list, tuple)):
        return sum(_nbytes(o) for o in obj)
    return 0


def memory_analysis(fn: Callable, *args, **kwargs) -> dict[str, Any]:
    """Argument and output sizes of one call of ``fn`` (bytes of their
    tensors), and on the card the temporary peak: device memory allocated
    during the call beyond what was allocated before it
    (``torch.cuda.max_memory_allocated``); ``None`` off the card.  The
    generated-code size of the JAX function has no counterpart
    (``None``)."""
    cuda = torch.cuda.is_available()
    if cuda:
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    out = fn(*args, **kwargs)
    temp = None
    if cuda:
        torch.cuda.synchronize()
        temp = torch.cuda.max_memory_allocated() - before
    return {"argument_size_in_bytes": _nbytes(list(args) + list(
                kwargs.values())),
            "output_size_in_bytes": _nbytes(out),
            "temp_size_in_bytes": temp,
            "generated_code_size_in_bytes": None}


def roofline_report(plan, secs: float, device=None) -> dict[str, Any]:
    """A measured per-call time ``secs`` of a window-ELL plan (or a
    banded, composite or strip stack of them) against its streamed bytes
    (``stream_bytes``, the physics guard's count) and the STREAM rate
    measured on ``device`` (:func:`~tpu_spmv_torch.bandwidth.
    measured_stream_bandwidth`, the card unless the caller names another;
    on the CPU no STREAM is measured, and its rate and the fraction are 0):
    bytes, slots, ps per slot, the achieved rate and its fraction of
    STREAM (``tpu_spmv/profiling.py:73-102``)."""
    from .bandwidth import measured_stream_bandwidth
    from .errors import target_device
    from .kernels.plan import CHUNKS, LANE

    plans = getattr(plan, "plans", (plan,))
    slots = sum(p.n_groups * CHUNKS * LANE for p in plans)
    bytes_ = sum(p.stream_bytes for p in plans)
    if getattr(plan, "tail", None) is not None:  # composite remainder
        bytes_ += float(plan.tail.nnz) * 12.0
    dev = target_device(device, "roofline_report")
    stream = measured_stream_bandwidth(dev) if dev.type == "cuda" else 0.0
    gbs = bytes_ / secs / 1e9 if secs > 0 else 0.0
    return {
        "stream_bytes": float(bytes_),
        "slots": int(slots),
        "ps_per_slot": secs / slots * 1e12 if slots else 0.0,
        "actual_gb_s": gbs,
        "stream_gb_s": float(stream),
        "stream_fraction": gbs / stream if stream else 0.0,
    }
