"""The reduction of the port's spans and counters (``harness/spans.py``), on a hand-made
stretch with known answers, and the readers of them in traced runs of the tiny cells."""

import pytest

from benchmark.harness import spans
from benchmark.harness.runner import run_cell
from wav2vec_heart_sounds_tpu_torch.utils.observe import CountRecord, SpanRecord

MAIN, PREFETCH, AUTOGRAD = 1, 2, 3


def test_a_hand_made_stretch_gives_known_readings():
    # device work at 10-20, 40-50, 70-80, 86-88 and 96-98 ns of a stretch 0-100 ns: idle 66
    activities = [(10, 20, 1), (40, 50, 2), (70, 80, 3), (86, 88, 4), (96, 98, 5)]
    launches = {1: (AUTOGRAD, 8),        # a thread with no span: the main thread's span then
                2: (MAIN, 30),           # its own thread's innermost span
                3: (PREFETCH, 62),       # its own thread's span, not the main thread's
                5: (MAIN, 1)}            # in a span the stretch cuts (4 has no launch)
    recorded = [SpanRecord("early", -10, 3, MAIN, None, 0),       # cut at 0
                SpanRecord("outer", 5, 65, MAIN, None, 1),
                SpanRecord("inner", 25, 35, MAIN, "outer", 1),
                SpanRecord("p", 60, 75, PREFETCH, None, 2),
                SpanRecord("late", 85, 95, MAIN, None, 2),
                SpanRecord("after", 120, 130, MAIN, None, 3)]     # outside the stretch
    counts = [CountRecord("despike.syncs", 10, 2, MAIN, 1),
              CountRecord("despike.syncs", 50, 1, MAIN, 1),
              CountRecord("despike.syncs", 150, 5, MAIN, 3)]
    v = spans.reduce(2, 0, 100, activities, launches, recorded, counts, MAIN)
    # gaps 0-10, 20-40, 50-70, 80-86, 88-96, 98-100, split where main-thread spans open and
    # close
    assert v.idle == {"early": 3, None: 2 + 5 + 5 + 1 + 2, "outer": 5 + 5 + 5 + 15,
                      "inner": 10, "late": 1 + 7}
    assert sum(v.idle.values()) == 100 - 10 - 10 - 10 - 2 - 2
    # each activity goes to the span of its launch (4 has none); a span's device time counts
    # only its instances whole inside the stretch, so the cut "early" has none
    pieces = {tid: spans.segments([s for s in v.spans if s.thread == tid], 0, 100)
              for tid in (MAIN, PREFETCH)}
    by_span = spans.launched(activities, launches, pieces, MAIN)
    assert {spans._name(span): ns for span, ns in by_span.items()} == \
        {"outer": 10, "inner": 10, "p": 10, None: 2, "early": 2}
    assert v.whole == {"outer": (10, 1), "inner": (10, 1), "p": (10, 1), "late": (0, 1)}
    assert v.counts == {"despike.syncs": 3}
    assert [s.name for s in v.spans] == ["early", "outer", "inner", "p", "late"]
    assert v.has_device and v.per_step_ms(4_000_000) == 2.0


def test_segments_name_the_innermost_span_and_fill_the_rest():
    nested = [SpanRecord("a", 10, 50, MAIN, None, 0), SpanRecord("b", 20, 30, MAIN, "a", 0),
              SpanRecord("c", 30, 40, MAIN, "a", 0), SpanRecord("d", 50, 60, MAIN, None, 1)]
    pieces = [(a, b, spans._name(span)) for a, b, span in spans.segments(nested, 0, 70)]
    assert pieces == [(0, 10, None), (10, 20, "a"), (20, 30, "b"), (30, 40, "c"),
                      (40, 50, "a"), (50, 60, "d"), (60, 70, None)]
    assert spans.segments([], 5, 9) == [(5, 9, None)]
    assert spans.idle_gaps([(0, 4), (2, 6), (8, 9)], 0, 12) == [(6, 8), (9, 12)]


def test_without_device_work_or_spans_the_readers_give_nothing():
    bare = spans.reduce(4, 0, 100, [], {}, [], [], MAIN)
    assert not bare.has_device and bare.idle == {None: 100} and bare.whole == {}

    class Run:
        trace = None
    assert spans.idle_ms(Run(), lambda name: True) is None
    assert spans.counter_per_step(Run(), "despike.syncs") is None


NEW_READERS = {"train": ("prep_idle_ms", "batch_idle_ms", "unspanned_idle_ms",
                         "forward_device_ms", "backward_device_ms", "optimizer_device_ms",
                         "despike_syncs"),
               "score": ("prep_idle_ms", "batch_idle_ms", "runner_idle_ms", "unspanned_idle_ms",
                         "despike_syncs", "gather_ms")}


@pytest.mark.parametrize("kind", ["train", "score"])
def test_a_traced_tiny_run_counts_the_syncs_and_leaves_the_readers_out(tiny, kind):
    """On the CPU the stretch has spans and counters but no device activity: every reader of
    the spans stays out of the line, as the readers of device time do, while the view holds
    the despike loop's syncs (three a batch at most: one test and an iteration a spike)."""
    result = run_cell(f"tiny-{kind}", 2**31 + 17, 0.5, True, device="cpu", layout=tiny)
    assert result["correct"]
    assert not {f"{name}.{kind}" for name in NEW_READERS[kind]} & set(result["metrics"])
    v = spans._last[1]
    assert v is not None and not v.has_device and v.spans
    assert v.counts["despike.syncs"] == v.counts["despike.iterations"] + v.steps
    assert 1 <= v.counts["despike.syncs"] / v.steps <= 2
    batch = {"train": "batch.wait", "score": "batch.gather"}[kind]
    assert {s.name for s in v.spans} >= {"prep", "prep.despike", batch}
