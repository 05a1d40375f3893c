"""``posconv_roofline.train``: the model's positional convolution (``models/wav2vec2.py``'s
``encoder.pos_conv_embed``), forward and backward, against its bound, in %.

The least time the card could take for one training step of its work over the device time a
step of the module, whatever implements it: the forward is the device time inside the
traced stretch's ``record_function`` range around the module's forward
(``harness/trace.py::PosConvRange``), the backward that of the
``autograd::engine::evaluate_function`` ops whose sequence numbers the range's ops carry (as
``posconv_bwd_ms.train`` reads it); the weight's re-lay is part of both. The bound
(``chip_smoke.py``'s phase 25 count): forward 2 B T D C K operations (C channels a group, K
taps) against x read, out and pre written and the weight read; backward twice the
operations (dx and dW) against x, pre and g read, dx written and the weight read and its
gradient written; each the larger of its bytes over 3.35 TB/s and its operations over 989
TFLOP/s (bf16)."""

from torch.autograd import DeviceType

from benchmark.harness.peaks import bound_s
from benchmark.harness.train_cell import POS_CONV_RANGE

BACKWARD = "autograd::engine::evaluate_function:"


def bound_per_step(cfg, batch: int, frames: int) -> float:
    """Seconds: the bound of one training step's positional conv, forward and backward."""
    dtype = cfg.compute_dtype
    d, k = cfg.hidden_size, cfg.pos_conv_kernel
    c = d // cfg.pos_conv_groups
    flops = 2.0 * batch * frames * d * c * k
    act, weight = batch * frames * d * dtype.itemsize, d * c * k * dtype.itemsize
    return bound_s(3 * act + weight, flops, dtype) + bound_s(4 * act + 2 * weight, 2 * flops,
                                                             dtype)


def _sequence_numbers(event, thread, out):
    for child in event.cpu_children:
        if child.sequence_nr >= 0:
            out.add((child.sequence_nr, thread))
        _sequence_numbers(child, thread, out)


def read(run):
    if run.trace is None:
        return None
    events = run.trace.prof.events()
    forward_us, numbers = 0.0, set()
    for e in events:
        if e.name == POS_CONV_RANGE and e.device_type == DeviceType.CPU:
            forward_us += e.device_time_total
            _sequence_numbers(e, e.thread, numbers)
    backward_us = sum(e.device_time_total for e in events
                      if e.name.startswith(BACKWARD) and (e.sequence_nr, e.fwd_thread) in numbers)
    if not forward_us or not backward_us:
        return None
    drv = run.measured
    bound = bound_per_step(drv.cfg, drv.traffic["batch_size"], drv.cfg.frames(drv.samples))
    return 100.0 * bound / ((forward_us + backward_us) / 1e6 / run.trace.steps)
