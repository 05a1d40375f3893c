"""``feature_encoder_ms.train``: device ms a training step of the conv feature encoder
(``models/wav2vec2.py::FeatureEncoder``), forward and backward, whatever implements it.

The port opens a ``record_function`` range ``model.feature_encoder`` around the module's
forward while a profiler records (``utils/observe.py::op_range``; no span, so the spans'
readers keep its device work under ``step.forward``). Forward: the device time of the ops
inside the range (kernels of theirs and of their children), the mean over its instances in
the traced stretch. Backward: the range's ops carry autograd sequence numbers; the
backward's ``autograd::engine::evaluate_function`` ops with those numbers (and the forward's
thread) are the encoder's backward, and their device time over the stretch's steps is added,
as ``posconv_bwd_ms.train`` reads its range. A program without the range reads nothing."""

from torch.autograd import DeviceType

RANGE = "model.feature_encoder"
BACKWARD = "autograd::engine::evaluate_function:"


def _sequence_numbers(event, thread, out):
    for child in event.cpu_children:
        if child.sequence_nr >= 0:
            out.add((child.sequence_nr, thread))
        _sequence_numbers(child, thread, out)


def read(run):
    if run.trace is None:
        return None
    events = run.trace.prof.events()
    forward_us, instances, numbers = 0.0, 0, set()
    for e in events:
        if e.name == RANGE and e.device_type == DeviceType.CPU:
            forward_us += e.device_time_total
            instances += 1
            _sequence_numbers(e, e.thread, numbers)
    if not forward_us:
        return None
    backward_us = sum(e.device_time_total for e in events
                      if e.name.startswith(BACKWARD) and (e.sequence_nr, e.fwd_thread) in numbers)
    return (forward_us / instances + backward_us / run.trace.steps) / 1e3
