"""``host_wait_ms.score``: the mean time a scoring batch took to come out of the port's
``Batcher`` (the gather, the padding and the wire), in ms: what the scoring loop waited
in ``next()`` on the iterable the benchmark hands ``score``, over the window's batches."""


def read(run):
    waits = run.window["wait_s"]
    return 1e3 * sum(waits) / len(waits) if waits else None
