"""``forward_device_ms.train``: device ms a training step of the work launched inside the
span ``step.forward`` (``train/classifier.py::SupervisedTrainer._train_step``): the training
forward's enqueue (``batch_transform`` when one is set, the optimizer's ``zero_grad``, the
model and the loss).

Each kernel, copy or fill of the traced stretch goes to the span of the CUDA runtime call
that launched it (matched by correlation id; ``harness/spans.py``); the reading is the sum
of their durations under ``step.forward``, over the stretch's steps."""

from benchmark.harness.spans import device_ms


def read(run):
    return device_ms(run, "step.forward")
