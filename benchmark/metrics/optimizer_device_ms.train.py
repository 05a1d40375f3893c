"""``optimizer_device_ms.train``: device ms a training step of the work launched inside the
span ``step.optimizer`` (``train/classifier.py::SupervisedTrainer._train_step``):
``MasterOptimizer.step``: the clip, the update of the float32 master and the copy to the
live leaves.

Each kernel, copy or fill of the traced stretch goes to the span of the CUDA runtime call
that launched it (matched by correlation id; ``harness/spans.py``); the reading is the sum
of their durations under ``step.optimizer``, over the stretch's steps."""

from benchmark.harness.spans import device_ms


def read(run):
    return device_ms(run, "step.optimizer")
