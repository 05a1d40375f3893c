"""``batch_idle_ms.train``: device idle ms a training step with the main thread in host
batching.

On the main thread that is the span ``batch.wait`` (``SupervisedTrainer._run_epoch`` waiting
for the prefetch thread's next batch, gathered and copied to the card there). The traced
stretch's idle time (no kernel, copy or fill on the card) goes to the innermost main-thread
span of the port open at each instant (``harness/spans.py``); the reading is the part under
``batch.*``, over the stretch's steps."""

from benchmark.harness.spans import idle_ms


def read(run):
    return idle_ms(run, lambda name: name is not None and name.startswith("batch."))
