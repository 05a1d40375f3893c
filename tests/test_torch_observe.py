"""Spans and counters inside the port (``utils/observe.py``) and where the loops record them.

With no profiler recording, ``span`` returns the shared no-op and nothing is stored. Under a
CPU ``torch.profiler``: spans nest with their parents, threads and batch serials, also on a
thread started before the profiler; the clock is the profiler's own (its events of the ops
inside a span lie within the span); the store is bounded; ``trace`` writes the spans and
counters beside its Chrome trace. Then the loops at a tiny size: each batch of
``experiments.cinc.score`` and of ``SupervisedTrainer._run_epoch`` gets its span tree under
one serial, on the threads it runs on, and the despike loop counts its host syncs.
"""

import json
import threading
from collections import defaultdict

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from wav2vec_heart_sounds_tpu_torch.data.fragments import Fragment, FragmentDataset
from wav2vec_heart_sounds_tpu_torch.data.loader import Batcher
from wav2vec_heart_sounds_tpu_torch.experiments.cinc import _device_prep, score
from wav2vec_heart_sounds_tpu_torch.models.build import build_classifier
from wav2vec_heart_sounds_tpu_torch.models.classifier import ClassifierConfig
from wav2vec_heart_sounds_tpu_torch.models.wav2vec2 import Wav2Vec2Config
from wav2vec_heart_sounds_tpu_torch.ops.despike import remove_spikes
from wav2vec_heart_sounds_tpu_torch.train.classifier import SupervisedTrainer
from wav2vec_heart_sounds_tpu_torch.utils import observe

FS_WIRE, FS, BATCH = 2000, 4000, 4
SECONDS = 2                                 # four 500 ms despike frames a window
SCORE_TREE = {"batch.gather": None, "batch.h2d": None, "prep": None, "prep.despike": "prep",
              "score.forward": None, "score.readback": None, "score.tally": None}
MAIN_TREE = {"batch.wait": None, "prep": None, "prep.despike": "prep", "step.forward": None,
             "step.backward": None, "step.optimizer": None}
PREFETCH_TREE = {"batch.gather": None, "batch.h2d": None}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


class Recorded:
    """What the store took while a CPU profiler recorded: ``spans``, ``counts`` and the
    profiler's host events as ``(name, start_ns, end_ns)``."""

    def __init__(self, store):
        self.store = store

    def __enter__(self):
        self.prof = profile(activities=[ProfilerActivity.CPU])
        self.start = observe.clock()
        self.prof.start()
        return self

    def __exit__(self, *exc):
        self.prof.stop()
        self.spans, self.counts = self.store.between(self.start, observe.clock())
        self.events = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
                       for e in self.prof.profiler.kineto_results.events()
                       if e.device_type() == DeviceType.CPU]
        return False


@pytest.fixture
def store(monkeypatch):
    """A store of this test's own."""
    fresh = observe.SpanStore()
    monkeypatch.setattr(observe, "STORE", fresh)
    return fresh


def by_batch(spans):
    out = defaultdict(list)
    for s in spans:
        out[s.batch].append(s)
    return out


def test_without_a_profiler_span_is_the_shared_noop_and_records_nothing(store):
    assert not torch.autograd.profiler._is_profiler_enabled
    first = observe.span("a")
    assert first is observe.OFF and observe.span("b", batch=3) is observe.OFF
    with observe.span("a") as s:
        s.batch = 7                          # ignored
        observe.count("c", 2)
    assert s.batch is None
    assert list(observe.gathered(["x", "y"])) == [(None, "x"), (None, "y")]
    assert not store.spans and not store.counts and not store.aliases


@pytest.mark.parametrize("norm", ["group", "layer"])
def test_the_feature_encoder_opens_a_profiler_range_and_no_span(store, norm):
    """``op_range`` is the shared no-op without a profiler; under one, the feature encoder's
    forward (either architecture) is a ``record_function`` range whose ops' sequence numbers
    name its backward's ops, and the store takes no span, so the device work launched inside
    stays with the enclosing span."""
    from wav2vec_heart_sounds_tpu_torch.models.wav2vec2 import FeatureEncoder

    assert observe.op_range("r") is observe.OFF
    cfg = Wav2Vec2Config.tiny(feat_extract_norm=norm, conv_bias=norm == "layer")
    encoder = FeatureEncoder(cfg, torch.float32)
    x = torch.randn(2, 400, generator=torch.Generator().manual_seed(0))
    with Recorded(store) as rec:
        encoder(x).square().sum().backward()
    assert not rec.spans
    events = rec.prof.events()
    ranges = [e for e in events if e.name == "model.feature_encoder"
              and e.device_type == DeviceType.CPU]
    assert len(ranges) == 1
    numbers = set()
    stack = list(ranges[0].cpu_children)
    while stack:
        e = stack.pop()
        numbers.add(e.sequence_nr)
        stack.extend(e.cpu_children)
    backward = [e.name for e in events
                if e.name.startswith("autograd::engine::evaluate_function:")
                and e.sequence_nr in numbers]
    convs = len(cfg.conv_dim)
    assert sum("ConvolutionBackward" in name for name in backward) == convs


def test_spans_nest_with_parents_threads_and_batches_and_counters_add_up(store):
    main = threading.get_native_id()
    with Recorded(store) as rec:
        for serial, item in observe.gathered(["p", "q"]):
            with observe.span("outer"):
                with observe.span("inner") as inner:
                    observe.count("n", 2)
                    observe.count("n")
                assert inner.batch == serial
            observe.count("m")
    names = [(s.name, s.parent) for s in rec.spans]
    assert names == [("batch.gather", None), ("inner", "outer"), ("outer", None)] * 2 + \
        [("batch.gather", None)]             # the last ask finds no batch
    assert {s.thread for s in rec.spans} == {main}
    batches = by_batch(rec.spans)
    assert len(batches) == 3 and None not in batches
    for serial in sorted(batches)[:2]:
        assert [s.name for s in batches[serial]] == ["batch.gather", "inner", "outer"]
    for s in rec.spans:
        assert s.start_ns <= s.end_ns
    outer = [s for s in rec.spans if s.name == "outer"]
    inner = [s for s in rec.spans if s.name == "inner"]
    for o, i in zip(outer, inner):
        assert o.start_ns <= i.start_ns <= i.end_ns <= o.end_ns
    totals = observe.counters(rec.start, observe.clock())
    assert totals == {"n": 6, "m": 2}
    per_batch = defaultdict(int)
    for c in rec.counts:
        per_batch[c.batch, c.name] += c.n
    assert sorted(per_batch.values()) == [1, 1, 3, 3]
    assert all(c.thread == main for c in rec.counts)


def test_a_thread_started_before_the_profiler_records_its_spans(store):
    go, done, seen = threading.Event(), threading.Event(), {}

    def side():
        go.wait(30)
        seen["tid"], seen["ident"] = threading.get_native_id(), threading.get_ident()
        with observe.span("side", batch=5):
            torch.ones(8).add_(1)
        done.set()

    thread = threading.Thread(target=side, daemon=True)
    thread.start()
    with Recorded(store) as rec:
        go.set()
        assert done.wait(30)
    thread.join(30)
    assert not thread.is_alive()
    [s] = rec.spans
    assert (s.name, s.thread, s.parent, s.batch) == ("side", seen["tid"], None, 5)
    assert s.thread != threading.get_native_id()
    assert store.aliases[seen["ident"] & 0xFFFFFFFF] == seen["tid"]


def test_the_clock_is_the_profilers(store):
    a, b = torch.randn(96, 96), torch.randn(96, 96)
    with Recorded(store) as rec:
        for _ in range(5):
            with observe.span("mm"):
                torch.mm(a, b)
    spans = [s for s in rec.spans if s.name == "mm"]
    events = [e for e in rec.events if e[0] == "aten::mm"]
    assert len(spans) == len(events) == 5
    for s, (_, start, end) in zip(spans, sorted(events, key=lambda e: e[1])):
        assert s.start_ns <= start <= end <= s.end_ns


def test_the_store_is_bounded(monkeypatch):
    small = observe.SpanStore(capacity=4)
    monkeypatch.setattr(observe, "STORE", small)
    with Recorded(small):
        for i in range(10):
            with observe.span(f"s{i}"):
                observe.count("c")
    assert [s.name for s in small.spans] == ["s6", "s7", "s8", "s9"]
    assert len(small.counts) == 4


def test_trace_writes_spans_and_counters_beside_the_chrome_trace(store, tmp_path):
    with observe.trace(str(tmp_path), "region"):
        with observe.span("work", batch=2):
            observe.count("things", 3)
            (torch.ones(16, 16) @ torch.ones(16, 16)).sum()
    out = tmp_path / "region"
    assert sorted(p.name for p in out.iterdir()) == ["counters.json", "spans.jsonl", "trace.json"]
    [line] = (out / "spans.jsonl").read_text().splitlines()
    row = json.loads(line)
    assert (row["name"], row["parent"], row["batch"], row["thread"]) == \
        ("work", None, 2, threading.get_native_id())
    assert row["start_ns"] <= row["end_ns"]
    assert json.loads((out / "counters.json").read_text()) == {"things": 3}
    assert json.loads((out / "trace.json").read_text())["traceEvents"]


# ---- the loops ----------------------------------------------------------------------------

def _windows(n, seed, spikes=(), seconds=1):
    """``n`` raw windows of ``seconds`` at ``FS_WIRE`` in [-1, 1]; window ``i`` in ``spikes``
    carries one Gaussian pulse far above its floor (with 500 ms frames enough to hold a
    median below it, it trips the despike loop)."""
    rng = np.random.default_rng(seed)
    t = np.arange(FS_WIRE * seconds) / FS_WIRE
    x = (0.3 * np.sin(2 * np.pi * rng.uniform(30, 200, size=(n, 1)) * t)
         + 0.05 * rng.normal(size=(n, len(t))))
    for i in spikes:
        x[i] += 3.0 * np.exp(-0.5 * ((t - 0.3) / 0.0008) ** 2)
    return x / np.abs(x).max(axis=1, keepdims=True)


@pytest.fixture(scope="module")
def model():
    cfg = ClassifierConfig(num_classes=2, head_hidden=(8,), encoder=Wav2Vec2Config.tiny(),
                           fs=FS)
    return build_classifier(cfg, device="cpu")


def test_each_scored_batch_gets_its_span_tree_under_one_serial(store, model):
    x = _windows(10, 0, spikes=(1, 6), seconds=SECONDS)
    ds = FragmentDataset([Fragment(w.astype(np.float32), i % 2, f"p{i // 3}")
                          for i, w in enumerate(x)], fs=FS_WIRE)
    batcher = Batcher(ds, BATCH, False, target_len=SECONDS * FS_WIRE)
    with Recorded(store) as rec:
        out = score(model.eval(), batcher, FS_WIRE, FS, SECONDS * FS)
    assert out["logits"].shape == (12, 2)
    batches = by_batch(rec.spans)
    full = [b for b, spans in batches.items() if len(spans) > 1]
    assert len(full) == len(batcher) == 3
    main = threading.get_native_id()
    for serial in full:
        spans = batches[serial]
        assert {(s.name, s.parent) for s in spans} == set(SCORE_TREE.items())
        assert len(spans) == len(SCORE_TREE) and {s.thread for s in spans} == {main}
        order = [s.name for s in sorted(spans, key=lambda s: s.start_ns)]
        assert order == ["batch.gather", "batch.h2d", "prep", "prep.despike", "score.forward",
                         "score.readback", "score.tally"]
    # the last ask of the batcher finds no batch: a gather alone, under a serial of its own
    assert [s.name for b, spans in batches.items() if b not in full for s in spans] == \
        ["batch.gather"]
    counted = defaultdict(int)
    for c in rec.counts:
        counted[c.batch, c.name] += c.n
    assert {b for b, _ in counted} == set(full)
    # windows 1 and 6 (batches 0 and 1) each trip the loop; each sync is counted
    assert [counted[b, "despike.iterations"] for b in full] == [1, 1, 0]
    assert [counted[b, "despike.syncs"] for b in full] == [2, 2, 1]


def test_each_training_batch_gets_its_span_tree_on_its_threads(store):
    cfg = ClassifierConfig(num_classes=2, head_hidden=(8,), encoder=Wav2Vec2Config.tiny(),
                           fs=FS)
    trained = build_classifier(cfg, device="cpu", train=True)
    x = _windows(12, 1, spikes=(2,), seconds=SECONDS)
    ds = FragmentDataset([Fragment(w.astype(np.float32), i % 2, f"p{i}")
                          for i, w in enumerate(x)], fs=FS_WIRE)
    batcher = Batcher(ds, BATCH, True, seed=0, target_len=SECONDS * FS_WIRE, wire_int16=True)
    trainer = SupervisedTrainer(trained, seed=0, log=lambda line: None,
                                device_preprocess=_device_prep(FS_WIRE, FS, SECONDS * FS,
                                                               "cpu"))
    with Recorded(store) as rec:
        trainer._run_epoch(batcher, True, None)
    main = threading.get_native_id()
    batches = by_batch(rec.spans)
    full = [b for b, spans in batches.items() if any(s.name == "step.forward" for s in spans)]
    assert len(full) == len(batcher) == 3
    prefetch = set()
    for serial in full:
        spans = batches[serial]
        ours = {(s.name, s.parent) for s in spans if s.thread == main}
        theirs = {(s.name, s.parent) for s in spans if s.thread != main}
        assert ours == set(MAIN_TREE.items()) and theirs == set(PREFETCH_TREE.items())
        assert len(spans) == len(MAIN_TREE) + len(PREFETCH_TREE), [(s.name, s.thread) for s in spans]
        prefetch |= {s.thread for s in spans if s.thread != main}
        at = {s.name: s for s in spans}
        assert at["batch.gather"].end_ns <= at["batch.h2d"].start_ns
        assert at["batch.h2d"].end_ns <= at["batch.wait"].end_ns
        order = [s.name for s in sorted(spans, key=lambda s: s.start_ns) if s.thread == main]
        assert order[2:] == ["prep.despike", "step.forward", "step.backward", "step.optimizer"]
    assert len(prefetch) == 1
    # the prefetch thread's last ask finds no batch; so does the loop's last wait
    rest = sorted((s.name for b, spans in batches.items() if b not in full for s in spans))
    assert rest == ["batch.gather", "batch.wait"]


def test_one_planted_spike_costs_one_iteration_and_two_syncs(store):
    x = torch.as_tensor(_windows(BATCH, 2, spikes=(1,), seconds=4), dtype=torch.float32)
    clean = torch.as_tensor(_windows(BATCH, 2, seconds=4), dtype=torch.float32)
    for wave, iterations in ((clean, 0), (x, 1)):
        with Recorded(store) as rec:
            with observe.span("prep", batch=11):
                out = remove_spikes(wave, FS_WIRE)
        totals = defaultdict(int)
        for c in rec.counts:
            assert c.batch == 11
            totals[c.name] += c.n
        assert totals["despike.iterations"] == iterations
        assert totals["despike.syncs"] == totals["despike.iterations"] + 1
    assert not torch.equal(out[1], x[1]) and torch.equal(out[[0, 2, 3]], x[[0, 2, 3]])
