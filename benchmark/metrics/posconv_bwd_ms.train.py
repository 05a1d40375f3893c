"""``posconv_bwd_ms.train``: device ms a training step of the backward of the model's
positional convolution (``models/wav2vec2.py``'s ``encoder.pos_conv_embed``), whatever
implements it.

The traced stretch wraps every forward of that module in a ``record_function`` range
(``harness/trace.py::PosConvRange``). The ops inside a range carry autograd sequence
numbers; the backward's ``autograd::engine::evaluate_function`` ops with those numbers (and
the forward's thread) are that module's backward, and their device time (kernels of theirs
and of their children) over the stretch's steps is the reading."""

from benchmark.harness.train_cell import POS_CONV_RANGE

BACKWARD = "autograd::engine::evaluate_function:"


def _forward_sequence_numbers(event, thread, out):
    for child in event.cpu_children:
        if child.sequence_nr >= 0:
            out.add((child.sequence_nr, thread))
        _forward_sequence_numbers(child, thread, out)


def read(run):
    if run.trace is None:
        return None
    events = run.trace.prof.events()
    forward = set()
    for e in events:
        if e.name == POS_CONV_RANGE:
            _forward_sequence_numbers(e, e.thread, forward)
    if not forward:
        return None
    us = sum(e.device_time_total for e in events
             if e.name.startswith(BACKWARD) and (e.sequence_nr, e.fwd_thread) in forward)
    return us / 1e3 / run.trace.steps if us else None
