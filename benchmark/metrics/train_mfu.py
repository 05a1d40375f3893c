"""``train_mfu``: the whole training step's share of the card's peak, in %.

The benchmark's count of a window's training operations (``harness/flops.py``: forward,
input and weight gradients, nothing recomputed) times the training windows a second of the
window, over the peak rate of the configuration's compute dtype (989 TFLOP/s in bf16)."""

from benchmark.harness.peaks import PEAK_FLOPS


def read(run):
    obs, drv = run.window, run.measured
    if not obs["windows"]:
        return None
    return 100.0 * drv.flops_per_window * obs["windows"] / obs["seconds"] \
        / PEAK_FLOPS[drv.cfg.compute_dtype]
