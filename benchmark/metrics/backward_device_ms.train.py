"""``backward_device_ms.train``: device ms a training step of the work launched inside the
span ``step.backward`` (``train/classifier.py::SupervisedTrainer._train_step``):
``loss.backward()``; the autograd engine's thread has no span of its own, so its launches go
to the main thread's span then.

Each kernel, copy or fill of the traced stretch goes to the span of the CUDA runtime call
that launched it (matched by correlation id; ``harness/spans.py``); the reading is the sum
of their durations under ``step.backward``, over the stretch's steps."""

from benchmark.harness.spans import device_ms


def read(run):
    return device_ms(run, "step.backward")
