"""The traced slice: a bounded run of calls under ``torch.profiler``, kept
in memory, reduced to plain event lists, and the arithmetic over them.

The slice is one profiler cycle: a warm-up step (traced and dropped), the
active step (the slice itself) and one closing step, so that no kernel of
the slice's last call is lost when the trace stops.  The slice spans from
its first call's issue to its last wait's return.  Times are microseconds
on the profiler's timeline, which the host spans and the device events
share.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class Slice:
    """What the readers get from a traced slice.

    ``device``: ``(name, start, end)`` of every operation that ran on the
    device (kernels, copies, fills), on any of the run's cards; ``host``:
    ``(name, start, end)`` of the benchmark's own spans; ``span``: the
    slice's ``(start, end)``; ``calls``: the operations in it; ``spmvs``:
    the SpMVs they made; ``waits``: of the CUDA runtime's device
    synchronisations in the slice, how many lie inside the benchmark's
    wait spans, and how many there are (the check that the two clocks
    agree); ``card``: the card of each ``device`` event
    (``FunctionEvent.device_index``; ``None``: all on the first of
    ``cards``); ``cards``: the run's cards."""

    device: list
    host: list
    span: tuple
    calls: int
    spmvs: int
    waits: tuple = (0, 0)
    card: list = None
    cards: tuple = (0,)

    @property
    def window_s(self) -> float:
        return (self.span[1] - self.span[0]) * 1e-6

    @property
    def busy_s(self) -> float:
        """The union of the device events: some card busy."""
        return busy_us(self.device, *self.span) * 1e-6

    def on_card(self, c: int) -> list:
        """The ``device`` events of card ``c`` (all of them where the run
        has one card)."""
        if self.card is None or len(self.cards) == 1:
            return list(self.device) if c == self.cards[0] else []
        return [e for e, k in zip(self.device, self.card) if k == c]

    @property
    def card_busy_us(self) -> dict:
        """Each card's busy time inside the slice's span, µs."""
        return {c: busy_us(self.on_card(c), *self.span) for c in self.cards}

    @property
    def card_busy_s(self) -> float:
        """The busy time a card, the mean over the run's cards."""
        b = self.card_busy_us
        return sum(b.values()) / len(b) * 1e-6

    @property
    def kernels(self) -> int:
        return sum(1 for e in self.device if is_kernel(e[0]))


def is_kernel(name: str) -> bool:
    """A launched kernel, not a copy or a fill the runtime makes."""
    return not name.startswith(("Memcpy", "Memset"))


def busy_us(events: list, lo: float, hi: float) -> float:
    """The union of the events' intervals inside ``[lo, hi]``."""
    total, cur_s, cur_e = 0.0, None, None
    for _, s, e in sorted(events, key=lambda ev: ev[1]):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def idle_gaps(events: list, host: list, lo: float, hi: float) -> list:
    """The device's idle gaps inside ``[lo, hi]``, longest first, as
    ``(name, µs)``: each named by the innermost benchmark span the host was
    in at the gap's middle (``"host"`` where it was in none)."""
    gaps, t = [], lo
    for _, s, e in sorted(events, key=lambda ev: ev[1]):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if hi > t:
        gaps.append((t, hi))
    out = []
    for s, e in gaps:
        mid = 0.5 * (s + e)
        inside = [h for h in host if h[1] <= mid <= h[2]]
        name = min(inside, key=lambda h: h[2] - h[1])[0] if inside \
            else "host"
        out.append((name, e - s))
    return sorted(out, key=lambda g: -g[1])


def top_ops(events: list, k: int = 10) -> list:
    """The ``k`` device operations that took the most time, summed by name,
    as ``(name, µs)``."""
    by = {}
    for name, s, e in events:
        by[name] = by.get(name, 0.0) + (e - s)
    return sorted(by.items(), key=lambda kv: -kv[1])[:k]


def record(run_calls, warm: int, n: int, closing: int,
           cards: tuple = (0,)) -> Slice:
    """Trace ``run_calls(n, spans)`` (which returns the SpMVs it made and
    appends its spans to ``spans`` as ``(name, start, end)`` in
    ``time.time_ns()``) after ``run_calls(warm, [])`` and before
    ``run_calls(closing, [])``, on the cards ``cards`` (their indices).

    Only the device's activity is traced (with the CUDA runtime's calls),
    not the host's operators: recording each operator would slow the host
    path that the cells measure.  The benchmark's own spans are taken on
    the host clock and put on the profiler's timeline, which counts from
    ``trace_start_ns`` on the same clock."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    spans = []
    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                 acc_events=True) as prof:
        run_calls(warm, [])
        prof.step()
        spmvs = run_calls(n, spans)
        prof.step()
        run_calls(closing, [])
        prof.step()
    t0 = prof.profiler.kineto_results.trace_start_ns()
    host = [(name, (s - t0) * 1e-3, (e - t0) * 1e-3) for name, s, e in spans]
    device, card, syncs = [], [], []
    for e in prof.events():
        rng = (e.time_range.start, e.time_range.end)
        if e.device_type == DeviceType.CUDA:
            if not e.is_user_annotation \
                    and not e.name.startswith("ProfilerStep"):
                device.append((e.name, *rng))
                card.append(e.device_index)
        elif e.name == "cudaDeviceSynchronize":
            syncs.append(rng)
    if not host or not device:
        raise RuntimeError("the trace holds no slice")
    waits = [h for h in host if h[0].endswith(".wait")]
    inside = sum(1 for s, e in syncs
                 if any(h[1] <= s and e <= h[2] for h in waits))
    return Slice(device, host, (host[0][1], host[-1][2]), n, spmvs,
                 (inside, len(syncs)), card, tuple(cards))
