"""``despike_syncs.score``: host syncs a scoring batch of the port's despike loop
(``ops/despike.py::remove_spikes``), counted by the port's counter ``despike.syncs``: the
first activity test and one an iteration (``despike.iterations``), each a ``bool()`` that
waits for the card. Read over the traced stretch, per step."""

from benchmark.harness.spans import counter_per_step


def read(run):
    return counter_per_step(run, "despike.syncs")
