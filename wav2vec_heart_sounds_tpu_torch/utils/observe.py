"""Observability (port of ``wav2vec_heart_sounds_tpu/utils/observe.py``): per-epoch scalar
logging, a profiler hook, and spans and counters inside the program's loops.

``ScalarLogger`` is a copy, held to the original by ``tests/test_torch_imports.py``: JSONL
rows in ``<log_dir>/scalars.jsonl``, mirrored to TensorBoard when its writer imports.
:func:`trace` takes the ``jax.profiler`` trace's place with ``torch.profiler``: host
activity, and the card's kernels when there is a card.

:func:`span` and :func:`count` record only while a ``torch.profiler`` records, in any thread
of the process (the gate is ``torch.autograd.profiler._is_profiler_enabled``, which a thread
started before the profiler sees too; the C-level check reads ``False`` there). With no
profiler, ``span`` returns one shared no-op object and ``count`` returns at once: no
allocation, no ``record_function`` range (whose device-side shadow a trace reader could
count as device work). While one records, each span appends ``(name, start_ns, end_ns,
thread, parent, batch)`` to a bounded store (:data:`STORE`; the oldest go first): the
clock is the profiler events' own (``time.time_ns``), ``thread`` the OS thread id the
profiler gives a thread's events, ``parent`` the name of the enclosing open span on the same
thread, ``batch`` the serial of the batch the span serves. A span without a ``batch`` takes
its parent's, else the serial of its thread's last closed span that had one; a
``batch.gather`` span (:func:`gathered`) starts a new serial. :func:`spans` and
:func:`counters` read the store over a time range.

:func:`op_range` is for a module whose forward a trace reader follows into its backward: a
``record_function`` range while a profiler records (the ops inside carry the autograd
sequence numbers of their backward), :data:`OFF` otherwise. It is no span: the device work
launched inside stays with the enclosing span.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time
from collections import deque
from typing import Iterable, Iterator, NamedTuple

import torch
from torch.autograd import profiler as _profiler

CAPACITY = 1 << 16          # spans, and counter increments, the store keeps
clock = time.time_ns        # the clock of torch.profiler's events (checked by the tests)
NEW_BATCH = -1              # ``span(..., batch=NEW_BATCH)``: the span starts a new batch serial
_END = object()


class ScalarLogger:
    """Append-only scalar sink: ``scalars.jsonl`` rows + optional TensorBoard mirror."""

    def __init__(self, log_dir: str | None):
        self.log_dir = log_dir
        self._tb = None
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
            try:
                from torch.utils.tensorboard.writer import SummaryWriter

                self._tb = SummaryWriter(log_dir)
            except Exception:
                self._tb = None

    def scalar(self, tag: str, value: float, step: int) -> None:
        if not self.log_dir:
            return
        with open(os.path.join(self.log_dir, "scalars.jsonl"), "a") as fh:
            fh.write(json.dumps({"tag": tag, "value": float(value), "step": int(step),
                                 "time": time.time()}) + "\n")
        if self._tb is not None:
            self._tb.add_scalar(tag, value, step)

    def scalars(self, prefix: str, values: dict[str, float], step: int) -> None:
        for name, value in values.items():
            self.scalar(f"{prefix}/{name}", value, step)

    def flush(self) -> None:
        if self._tb is not None:
            self._tb.flush()


class SpanRecord(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    thread: int                 # OS thread id (``threading.get_native_id()``)
    parent: str | None          # the enclosing open span on the same thread
    batch: int | None           # the serial of the batch the span serves


class CountRecord(NamedTuple):
    name: str
    at_ns: int
    n: int
    thread: int
    batch: int | None


class _Thread:
    """One thread's open spans and the serial of its last closed span that had one."""

    __slots__ = ("tid", "open", "batch")

    def __init__(self, tid: int):
        self.tid, self.open, self.batch = tid, [], None


class SpanStore:
    """Spans and counter increments of the program, ``capacity`` of each at most.

    ``aliases`` maps the low 32 bits of a recording thread's ``threading.get_ident()`` (the
    id CUPTI gives the CUDA runtime calls of a thread the profiler knows nothing else of) to
    its OS thread id."""

    def __init__(self, capacity: int = CAPACITY):
        self.spans: deque[SpanRecord] = deque(maxlen=capacity)
        self.counts: deque[CountRecord] = deque(maxlen=capacity)
        self.aliases: dict[int, int] = {}
        self._local = threading.local()
        self._serials = itertools.count()

    def thread(self) -> _Thread:
        try:
            return self._local.state
        except AttributeError:
            state = self._local.state = _Thread(threading.get_native_id())
            self.aliases[threading.get_ident() & 0xFFFFFFFF] = state.tid
            return state

    def new_serial(self) -> int:
        return next(self._serials)

    def count(self, name: str, n: int) -> None:
        state = self.thread()
        batch = state.open[-1].batch if state.open else state.batch
        self.counts.append(CountRecord(name, clock(), n, state.tid, batch))

    def between(self, start_ns: int | None = None, end_ns: int | None = None
                ) -> tuple[list[SpanRecord], list[CountRecord]]:
        """The spans that overlap ``[start_ns, end_ns]`` and the increments inside it."""
        lo = -1 if start_ns is None else start_ns
        hi = float("inf") if end_ns is None else end_ns
        return ([s for s in tuple(self.spans) if s.end_ns >= lo and s.start_ns <= hi],
                [c for c in tuple(self.counts) if lo <= c.at_ns <= hi])


class _Span:
    __slots__ = ("_store", "name", "batch", "_state", "_parent", "_start")

    def __init__(self, store: SpanStore, name: str, batch: int | None):
        self._store, self.name, self.batch = store, name, batch

    def __enter__(self) -> _Span:
        state = self._state = self._store.thread()
        parent = self._parent = state.open[-1] if state.open else None
        if self.batch == NEW_BATCH:
            self.batch = self._store.new_serial()
        elif self.batch is None:
            self.batch = parent.batch if parent is not None else state.batch
        state.open.append(self)
        self._start = clock()
        return self

    def __exit__(self, *exc) -> bool:
        end = clock()
        state, parent = self._state, self._parent
        if state.open and state.open[-1] is self:
            state.open.pop()
        else:
            state.open.remove(self)
        if self.batch is not None:
            state.batch = self.batch
        self._store.spans.append(SpanRecord(self.name, self._start, end, state.tid,
                                            parent.name if parent is not None else None,
                                            self.batch))
        return False


class _Off:
    """What :func:`span` returns while no profiler records: enters and exits doing nothing;
    its ``batch`` reads ``None`` and ignores an assignment."""

    __slots__ = ()
    batch = property(lambda self: None, lambda self, value: None)

    def __enter__(self) -> _Off:
        return self

    def __exit__(self, *exc) -> bool:
        return False


OFF = _Off()
STORE = SpanStore()


def span(name: str, batch: int | None = None):
    """A context manager that records the enclosed region as span ``name`` while a profiler
    records (``batch``: the serial it serves, or :data:`NEW_BATCH`); :data:`OFF` otherwise."""
    if not _profiler._is_profiler_enabled:
        return OFF
    return _Span(STORE, name, batch)


def op_range(name: str):
    """A ``record_function`` range named ``name`` while a profiler records; :data:`OFF`
    otherwise."""
    if not _profiler._is_profiler_enabled:
        return OFF
    return _profiler.record_function(name)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name`` while a profiler records."""
    if _profiler._is_profiler_enabled:
        STORE.count(name, n)


def gathered(batches: Iterable) -> Iterator[tuple[int | None, object]]:
    """``(serial, batch)`` for each batch of ``batches``: each ``next()`` runs under a
    ``batch.gather`` span that starts a new batch serial (``None`` while no profiler
    records). The last ask, which finds no batch, is a span too."""
    it = iter(batches)
    while True:
        with span("batch.gather", NEW_BATCH) as gather:
            batch = next(it, _END)
        if batch is _END:
            return
        yield gather.batch, batch


def spans(start_ns: int | None = None, end_ns: int | None = None) -> list[SpanRecord]:
    """The recorded spans that overlap ``[start_ns, end_ns]``, oldest first."""
    return STORE.between(start_ns, end_ns)[0]


def counters(start_ns: int | None = None, end_ns: int | None = None) -> dict[str, int]:
    """Each counter's sum over the increments recorded in ``[start_ns, end_ns]``."""
    totals: dict[str, int] = {}
    for c in STORE.between(start_ns, end_ns)[1]:
        totals[c.name] = totals.get(c.name, 0) + c.n
    return totals


@contextlib.contextmanager
def trace(log_dir: str | None, label: str = "trace") -> Iterator[None]:
    """Capture a ``torch.profiler`` trace of the enclosed region as a Chrome trace,
    ``<log_dir>/<label>/trace.json``, with the region's spans (``spans.jsonl``, one object a
    line) and counters (``counters.json``) beside it (no-op without a log_dir)."""
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    path = os.path.join(log_dir, label)
    os.makedirs(path, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    profiler = profile(activities=activities)
    start = clock()
    profiler.start()
    try:
        yield
    finally:
        profiler.stop()
        end = clock()
        profiler.export_chrome_trace(os.path.join(path, "trace.json"))
        with open(os.path.join(path, "spans.jsonl"), "w") as fh:
            for s in spans(start, end):
                fh.write(json.dumps(s._asdict()) + "\n")
        with open(os.path.join(path, "counters.json"), "w") as fh:
            json.dump(counters(start, end), fh)
