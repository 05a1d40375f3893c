"""``device_idle_pct.train``: the share of the traced stretch in which no kernel, copy or
fill ran on the card, in % (100 minus the union of their intervals over the stretch)."""


def read(run):
    t = run.trace
    if t is None or t.window_s <= 0 or not t.device:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
