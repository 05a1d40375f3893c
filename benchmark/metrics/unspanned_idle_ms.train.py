"""``unspanned_idle_ms.train``: device idle ms a training step under no span of the port.

What the port's spans do not yet explain: the host outside ``batch.wait``, ``prep`` and
``step.*`` on the main thread. The traced stretch's idle time (no kernel, copy or fill on
the card) goes to the innermost main-thread span of the port open at each instant
(``harness/spans.py``); the reading is the part under no span, over the stretch's steps."""

from benchmark.harness.spans import idle_ms


def read(run):
    return idle_ms(run, lambda name: name is None)
