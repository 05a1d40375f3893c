"""``gather_ms.score``: the mean host ms of the port's ``batch.gather`` span over the traced
stretch: ``train/evaluate.py::evaluate``'s ``next()`` on the iterable ``score`` is handed
(the ``Batcher``'s gather, padding and wire, and the benchmark's feed around it).
``host_wait_ms.score`` times the same call from outside over the window."""

from benchmark.harness.spans import mean_span_ms


def read(run):
    return mean_span_ms(run, "batch.gather")
