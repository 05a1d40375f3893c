"""The program's own spans and counters over the traced stretch, reduced for the readers.

The port records spans and counters (``wav2vec_heart_sounds_tpu_torch/utils/observe.py``)
only while a ``torch.profiler`` records, so the traced stretch (``trace.py::Stretch``) turns
them on for exactly its steps and the measured window runs without them. :func:`view` takes
the stretch's bounds as :func:`trace.summarise` does (its earliest and latest profiler event),
the program's spans that overlap them and its counter increments inside them, and reduces
them with the stretch's device activity:

- idle time, the complement of the union of ``run.trace.device``'s intervals, goes
  nanosecond by nanosecond to the innermost main-thread span open at that instant (a gap is
  split at span edges), or to ``None`` under no span, so the parts add up to the stretch's
  idle time;
- each device activity goes to a span by its launch, the CUDA runtime call that has the
  activity's correlation id: to the innermost span of the launching thread at the call, or,
  when that thread has no span in the stretch (the autograd engine's), to the main thread's
  innermost span then. A span's device time a step is the mean over its instances that lie
  whole inside the stretch: the stretch starts inside the first step's forward, whose span
  opened before the profiler and so was never recorded, and it ends inside the next step's.

A program that records no spans (one without ``observe.STORE``) gives a view without spans,
and the readers return ``None``; so does a stretch without device activity (a CPU run).
"""

from __future__ import annotations

import bisect
import threading
from collections import defaultdict
from dataclasses import dataclass, field

from torch.autograd import DeviceType

Segment = tuple[int, int, object]             # (start ns, end ns, innermost span or None)


@dataclass
class View:
    steps: int
    t0: int
    t1: int
    has_device: bool
    spans: list = field(default_factory=list)   # observe.SpanRecord overlapping the stretch
    counts: dict = field(default_factory=dict)  # counter -> sum over the stretch
    idle: dict = field(default_factory=dict)    # innermost main-thread span's name -> idle ns
    whole: dict = field(default_factory=dict)   # name -> (device ns, instances) of whole ones

    def per_step_ms(self, ns: float) -> float:
        return ns / 1e6 / self.steps

    def inside(self, s) -> bool:
        return self.t0 <= s.start_ns and s.end_ns <= self.t1


def segments(spans, t0: int, t1: int) -> list[Segment]:
    """``[t0, t1)`` cut where one thread's (nested) ``spans`` open and close, each piece
    holding the innermost span open over it (``None`` where none is)."""
    out: list[Segment] = []
    stack: list[tuple[int, object]] = []             # (end, span) of the open spans
    at = t0

    def close_until(t):
        nonlocal at
        while stack and stack[-1][0] <= t:
            end, span = stack.pop()
            if end > at:
                out.append((at, end, span))
                at = end

    for s in sorted(spans, key=lambda s: (s.start_ns, -s.end_ns)):
        start, end = max(s.start_ns, t0), min(s.end_ns, t1)
        if end <= start:
            continue
        close_until(start)
        if start > at:
            out.append((at, start, stack[-1][1] if stack else None))
            at = start
        stack.append((end, s))
    close_until(t1)
    if t1 > at:
        out.append((at, t1, None))
    return out


def idle_gaps(device: list[tuple[int, int]], t0: int, t1: int) -> list[tuple[int, int]]:
    """The complement of the union of the ``(start, end)`` intervals in ``[t0, t1)``."""
    gaps, edge = [], t0
    for start, end in sorted(device):
        if start > edge:
            gaps.append((edge, min(start, t1)))
        edge = max(edge, end)
        if edge >= t1:
            break
    if edge < t1:
        gaps.append((edge, t1))
    return [(a, b) for a, b in gaps if b > a]


def _name(span) -> str | None:
    return None if span is None else span.name


def split(gaps: list[tuple[int, int]], pieces: list[Segment]) -> dict:
    """Nanoseconds of ``gaps`` under the name of each piece's span (both sorted, each
    disjoint)."""
    out: dict = defaultdict(int)
    j = 0
    for a, b in gaps:
        while j < len(pieces) and pieces[j][1] <= a:
            j += 1
        k = j
        while k < len(pieces) and pieces[k][0] < b:
            start, end, span = pieces[k]
            out[_name(span)] += min(b, end) - max(a, start)
            k += 1
    return dict(out)


def _innermost(pieces: list[Segment], starts: list[int], t: int):
    i = bisect.bisect_right(starts, t) - 1
    return pieces[i][2] if i >= 0 and t < pieces[i][1] else None


def launched(activities, launches: dict, by_thread: dict, main: int) -> dict:
    """Device nanoseconds of ``activities`` (``(start, end, correlation id)``) under the
    span (the instance) of each one's launch (``launches``: correlation id -> ``(thread,
    t)``; ``by_thread``: thread -> its segments). An activity without a launch goes to
    ``None``."""
    index = {tid: (pieces, [p[0] for p in pieces]) for tid, pieces in by_thread.items()}
    out: dict = defaultdict(int)
    for start, end, corr in activities:
        launch = launches.get(corr)
        span = None
        if launch is not None:
            tid, t = launch
            pieces, starts = index.get(tid) or index.get(main, ([], []))
            span = _innermost(pieces, starts, t)
        out[span] += end - start
    return dict(out)


def reduce(steps: int, t0: int, t1: int, activities, launches: dict, spans, counts,
           main: int) -> View:
    """The view of a stretch ``[t0, t1]`` of ``steps`` steps from its device ``activities``
    (``(start, end, correlation id)``), their ``launches`` (correlation id -> ``(thread,
    t)``), the program's ``spans`` (``observe.SpanRecord``) and counter increments
    (``observe.CountRecord``) there, and the main thread's id."""
    inside = [s for s in spans if s.end_ns > t0 and s.start_ns < t1]
    totals: dict = defaultdict(int)
    for c in counts:
        if t0 <= c.at_ns <= t1:
            totals[c.name] += c.n
    threads: dict = defaultdict(list)
    for s in inside:
        threads[s.thread].append(s)
    by_thread = {tid: segments(ss, t0, t1) for tid, ss in threads.items()}
    main_pieces = by_thread.get(main) or [(t0, t1, None)]
    gaps = idle_gaps([(a, b) for a, b, _ in activities], t0, t1)
    v = View(steps=steps, t0=t0, t1=t1, has_device=bool(activities), spans=inside,
             counts=dict(totals), idle=split(gaps, main_pieces))
    by_span = launched(activities, launches, by_thread, main)
    for s in inside:
        if v.inside(s):
            ns, n = v.whole.get(s.name, (0, 0))
            v.whole[s.name] = (ns + by_span.get(s, 0), n + 1)
    return v


def _store():
    """The port's span store, or ``None`` for a program that keeps none."""
    try:
        from wav2vec_heart_sounds_tpu_torch.utils import observe
    except ImportError:
        return None
    store = getattr(observe, "STORE", None)
    return store if hasattr(store, "between") else None


_last: tuple = (None, None)


def view(run) -> View | None:
    """The stretch of ``run`` reduced with the program's spans (``None`` untraced); computed
    once a stretch."""
    global _last
    summary = run.trace
    if summary is None:
        return None
    if _last[0] is summary:
        return _last[1]
    kept = set(summary.device)
    t0 = t1 = None
    activities, calls = [], []
    for e in summary.prof.profiler.kineto_results.events():
        start = e.start_ns()
        end = start + e.duration_ns()
        if e.device_type() == DeviceType.CPU:
            if e.name().startswith("cu"):                 # a CUDA runtime or driver call
                calls.append((e.correlation_id(), e.device_resource_id(), start))
        elif (e.name(), start, end) in kept:
            activities.append((start, end, e.correlation_id()))
        else:
            continue
        t0 = start if t0 is None else min(t0, start)
        t1 = end if t1 is None else max(t1, end)
    store = _store()
    spans, counts, aliases = [], [], {}
    if store is not None and t0 is not None:
        spans, counts = store.between(t0, t1)
        aliases = dict(store.aliases)
    wanted = {corr for _, _, corr in activities}
    launches = {corr: (aliases.get(tid, tid), t) for corr, tid, t in calls if corr in wanted}
    result = reduce(summary.steps, t0 or 0, t1 or 0, activities, launches, spans, counts,
                    threading.main_thread().native_id)
    _last = (summary, result)
    return result


def idle_ms(run, under) -> float | None:
    """Device idle ms a step under the main-thread spans for which ``under(name)`` holds
    (``None``: under no span); ``None`` without device activity or spans."""
    v = view(run)
    if v is None or not v.has_device or not v.spans:
        return None
    return v.per_step_ms(sum(ns for name, ns in v.idle.items() if under(name)))


def device_ms(run, name: str) -> float | None:
    """Device ms of the work launched inside span ``name``, the mean over its instances
    whole inside the stretch (one a step)."""
    v = view(run)
    if v is None or not v.has_device or name not in v.whole:
        return None
    ns, n = v.whole[name]
    return ns / 1e6 / n


def counter_per_step(run, name: str) -> float | None:
    """Counter ``name``'s increments a step over the stretch."""
    v = view(run)
    if v is None or not v.has_device or not v.spans:
        return None
    return v.counts.get(name, 0) / v.steps


def mean_span_ms(run, name: str) -> float | None:
    """The mean host ms of span ``name`` over its instances whole inside the stretch."""
    v = view(run)
    if v is None or not v.has_device:
        return None
    ns = [s.end_ns - s.start_ns for s in v.spans if s.name == name and v.inside(s)]
    return sum(ns) / len(ns) / 1e6 if ns else None
