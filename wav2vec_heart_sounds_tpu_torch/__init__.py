"""PyTorch + CUDA port of ``wav2vec_heart_sounds_tpu`` for NVIDIA Hopper (H100).

The JAX package stays the reference. This package mirrors its module names so each
counterpart is easy to find, but imports only ``torch``, ``numpy`` and ``scipy``: it never
imports JAX, Flax, pandas, click or the JAX package, so it runs on a machine that has none of
them.

Ported so far: the scoring path (raw PCG windows -> preprocessing -> wav2vec2-base ->
fragment and patient verdicts), the training step (``train.classifier.SupervisedTrainer``),
the CinC, vest and fusion runners (``experiments.cinc.run``, ``experiments.multichannel.run``),
with every TPU kernel on those paths as a hand-written CUDA kernel in ``csrc/``; and the
generative half: the DiffWave and WaveGrad vocoders with their samplers
(``models.diffusion``), their trainer and dataset writer (``train.generative``,
``train.generate``) and the synthetic-schedule runner (``experiments.synthetic.run``); and
the command line (``cli``: ``python -m wav2vec_heart_sounds_tpu_torch.cli``) with the data
splits, reporting, presets, the C++ host chain (``native``) and the rest of the signal
surface; and data parallelism over cards (``parallel``: one process per card on
``torch.distributed``, taken by both trainers and every runner through ``mesh``). Entry
points run on the card unless the caller asks for the CPU.
"""

__all__ = [
    "config",
    "signal",
    "ops",
    "augment",
    "data",
    "models",
    "train",
    "parallel",
    "experiments",
    "reporting",
    "utils",
    "native",
    "cli",
]
