"""Waveform augmentation: the host pipelines (NumPy copies) and the batched card twin.

The probabilistic per-record pipelines run on the host at dataset-build time (HPSS and
time-stretch have no tensor form; :mod:`.pipelines`, copied from the JAX package), while
:func:`.torchaug.augment_pcg_batch` augments whole training batches on the card.
"""

from .pipelines import AugmentConfig, augment_multi_pcg, augment_pcg
from .torchaug import augment_multi_pcg_batch, augment_pcg_batch

__all__ = ["AugmentConfig", "augment_pcg", "augment_multi_pcg", "augment_pcg_batch",
           "augment_multi_pcg_batch"]
