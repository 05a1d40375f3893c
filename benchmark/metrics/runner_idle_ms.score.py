"""``runner_idle_ms.score``: device idle ms a scoring batch with the host in the runner.

The spans ``score.readback`` (``experiments/cinc.py::score``'s copy of the logits to the
host, which waits for the card) and ``score.tally`` (``evaluate``'s argmax, confusion matrix
and per-window patient loop). The traced stretch's idle time (no kernel, copy or fill on the
card) goes to the innermost main-thread span of the port open at each instant
(``harness/spans.py``); the reading is the part under ``score.readback`` and
``score.tally``, over the stretch's steps."""

from benchmark.harness.spans import idle_ms


def read(run):
    return idle_ms(run, lambda name: name in ("score.readback", "score.tally"))
