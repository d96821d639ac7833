"""Tracing and profiling (port of ``tpu_spmv/profiling.py``).

* the span recorder: a span is ``(name, start_ns, end_ns, parent, call,
  count)`` on ``time.time_ns()``, the clock ``torch.profiler`` counts its
  timeline from (``trace_start_ns``), so a span and a device event of one
  trace compare directly.  ``parent`` is the index of the enclosing span in
  :func:`spans` (-1 for a root), ``call`` an id every span of one public
  call shares, ``count`` an optional integer the span carries;
* :func:`trace`: ``torch.profiler.profile`` around the enclosed block, CPU
  activities and, where a card is present, CUDA ones (every kernel launch,
  the port's own among them), written as a Chrome trace into ``log_dir``;
* :func:`annotate`: a named span, and while it records a region in such a
  trace (``torch.profiler.record_function``) and an NVTX range on the card;
* :func:`cost_analysis` and :func:`memory_analysis`: the FLOPs and memory
  sizes of one call of a function.

The recorder records in two cases only: inside ``with recording():``, and
while a ``torch.profiler`` session is in its recording step (not in a
schedule's warm-up step).  Each public entry (``spmv_csr``, ``spmv_ell``,
``pagerank``; :func:`call_span`) takes that check once and sets
:data:`on` for the call; a span site inside the call then costs one test of
:data:`on` when nothing records.  Spans are kept in memory, at most
``SPAN_CAP`` of them (:func:`dropped` counts those past it), read with
:func:`spans` and emptied with :func:`clear`.  The recorder is one per
process and is not locked: record from one thread at a time.
"""

from __future__ import annotations

import contextlib
import functools
import os
import time
from typing import Any, Callable, NamedTuple

import torch

SPAN_CAP = 1 << 16
OFF = -1        # enter()'s token where nothing records

# recording in the current public call: the span sites test it
on = False
_forced = 0     # depth of recording() blocks
_spans: list = []   # [name, start_ns, end_ns, parent, call, count]
_open: list = []    # indices of the open spans, innermost last
_call = 0
_dropped = 0
_clock = time.time_ns
_profiler_enabled = torch._C._autograd._profiler_enabled


class Span(NamedTuple):
    """One recorded span, as :func:`spans` gives it."""

    name: str
    start_ns: int
    end_ns: int      # 0 while the span is open
    parent: int      # index in spans() of the enclosing span, -1 for a root
    call: int
    count: int | None


def spans() -> list:
    """The spans recorded since the last :func:`clear`, in the order they
    opened."""
    return [Span(*s) for s in _spans]


def dropped() -> int:
    """Spans not stored since the last :func:`clear`: the list was full."""
    return _dropped


def clear() -> None:
    """Forget every span; not inside a recorded span."""
    global _dropped
    if _open:
        raise RuntimeError("profiling.clear() inside a recorded span")
    _spans.clear()
    _dropped = 0


@contextlib.contextmanager
def recording():
    """Record spans inside the block, with or without a profiler."""
    global _forced
    _forced += 1
    try:
        yield
    finally:
        _forced -= 1


def begin(name: str) -> int:
    """Open a span inside the innermost open one (a root where none is
    open, under a new call id); only where :data:`on`.  Returns its index
    for :func:`end`."""
    global _call, _dropped
    if _open:
        parent = _open[-1]
    else:
        parent = -1
        _call += 1
    i = len(_spans)
    if i >= SPAN_CAP:
        # never stored; a token below OFF that no other open span has
        i = -2 - len(_open)
        _dropped += 1
    else:
        _spans.append([name, _clock(), 0, parent, _call, None])
    _open.append(i)
    return i


def end(i: int, count: int | None = None) -> None:
    """Close span ``i``, giving it its ``count``, and any span an exception
    left open inside it."""
    now = _clock()
    j = _open.pop()
    while j != i:
        if j >= 0:
            _spans[j][2] = now
        j = _open.pop()
    if i >= 0:
        span = _spans[i]
        span[2] = now
        span[5] = count


def enter(name: str) -> int:
    """A public call's entry: the one check of whether anything records,
    and where it does, its span opened and :data:`on` set.  Returns the
    token for :func:`leave`, ``OFF`` where nothing records."""
    global on
    if not on:
        if not (_forced or _profiler_enabled()):
            return OFF
        on = True
    return begin(name)


def leave(token: int) -> None:
    """A public call's exit: its span closed, and :data:`on` restored where
    it was the outermost."""
    global on
    if token == OFF:
        return
    end(token)
    if not _open:
        on = False


def call_span(name: str):
    """Decorate a public entry: each call is a span named ``name`` (a root
    unless made inside another recorded span), with :data:`on` set for the
    call while anything records."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            token = enter(name)
            if token == OFF:
                return fn(*args, **kwargs)
            try:
                return fn(*args, **kwargs)
            finally:
                leave(token)
        return call
    return wrap


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


@contextlib.contextmanager
def annotate(name: str):
    """A named span around the enclosed block (as a public call's: a root
    unless inside another recorded span); while it records, also a region
    in captured traces and an NVTX range on the card."""
    token = enter(name)
    if token == OFF:
        yield
        return
    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()
        leave(token)


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
