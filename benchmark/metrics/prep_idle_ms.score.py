"""``prep_idle_ms.score``: device idle ms a scoring batch with the host in the port's
preprocessing.

The spans ``prep`` (``experiments/cinc.py::_device_prep``: dequantisation and the PCG chain
on the card) and ``prep.despike`` inside it (the despike loop, a host sync an iteration).
The traced stretch's idle time (no kernel, copy or fill on the card) goes to the innermost
main-thread span of the port open at each instant (``harness/spans.py``); the reading is the
part under ``prep`` and ``prep.despike``, over the stretch's steps."""

from benchmark.harness.spans import idle_ms


def read(run):
    return idle_ms(run, lambda name: name in ("prep", "prep.despike"))
