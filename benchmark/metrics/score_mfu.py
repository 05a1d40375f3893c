"""``score_mfu``: the whole scoring forward's share of the card's peak, in %.

The benchmark's count of a window's forward operations (``harness/flops.py``) times the
windows scored a second in the window, over the peak rate of the configuration's compute
dtype (989 TFLOP/s in bf16)."""

from benchmark.harness.peaks import PEAK_FLOPS


def read(run):
    obs, drv = run.window, run.measured
    if not obs["windows"]:
        return None
    return 100.0 * drv.flops_per_window * obs["windows"] / obs["seconds"] \
        / PEAK_FLOPS[drv.cfg.compute_dtype]
