"""``batch_idle_ms.score``: device idle ms a scoring batch with the host in host batching.

The spans ``batch.gather`` (``train/evaluate.py::evaluate``'s ``next()`` on the ``Batcher``)
and ``batch.h2d`` (``_device_prep``'s copy of the host batch to the card). The traced
stretch's idle time (no kernel, copy or fill on the card) goes to the innermost main-thread
span of the port open at each instant (``harness/spans.py``); the reading is the part under
``batch.*``, over the stretch's steps."""

from benchmark.harness.spans import idle_ms


def read(run):
    return idle_ms(run, lambda name: name is not None and name.startswith("batch."))
