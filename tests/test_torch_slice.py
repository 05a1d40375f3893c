"""The scoring slice end to end: the JAX path vs the port on the same weights and batches.

JAX: eval ``Batcher`` -> ``experiments.cinc._device_prep`` (dequant, ``jaxproc``
preprocessing, crop) -> ``train.evaluate.make_apply_fn`` -> ``evaluate``.
Port: its own ``FragmentDataset`` and ``Batcher`` -> ``experiments.cinc.score``.
Logits agree at atol 1e-4 (float32; preprocessing and model summation orders differ);
fragment and patient statistics are equal.
"""

import numpy as np
import jax
import pytest

from wav2vec_heart_sounds_tpu.data.fragments import Fragment as JaxFragment
from wav2vec_heart_sounds_tpu.data.fragments import FragmentDataset as JaxDataset
from wav2vec_heart_sounds_tpu.data.loader import Batcher as JaxBatcher
from wav2vec_heart_sounds_tpu.experiments.cinc import _device_prep
from wav2vec_heart_sounds_tpu.models.build import build_classifier as jax_build
from wav2vec_heart_sounds_tpu.models.classifier import ClassifierConfig as JaxClassifierConfig
from wav2vec_heart_sounds_tpu.models.wav2vec2 import Wav2Vec2Config as JaxConfig
from wav2vec_heart_sounds_tpu.train.evaluate import evaluate as jax_evaluate
from wav2vec_heart_sounds_tpu.train.evaluate import make_apply_fn
from wav2vec_heart_sounds_tpu_torch.config import WindowSpec
from wav2vec_heart_sounds_tpu_torch.data.fragments import Fragment, FragmentDataset
from wav2vec_heart_sounds_tpu_torch.data.loader import Batcher
from wav2vec_heart_sounds_tpu_torch.experiments.cinc import score
from wav2vec_heart_sounds_tpu_torch.models.build import build_classifier
from wav2vec_heart_sounds_tpu_torch.models.classifier import ClassifierConfig
from wav2vec_heart_sounds_tpu_torch.models.from_jax import from_jax
from wav2vec_heart_sounds_tpu_torch.models.wav2vec2 import Wav2Vec2Config

FS_WIRE, FS, WINDOW_S, BATCH = 2000, 4000, 1.0, 4


def _recordings(seed=0):
    """5 patients x 3 raw windows (15 windows: the last batch of 4 has one padded row)."""
    rng = np.random.default_rng(seed)
    n = int(FS_WIRE * WINDOW_S)
    t = np.arange(n) / FS_WIRE
    out = []
    for p in range(5):
        for w in range(3):
            x = (np.sin(2 * np.pi * rng.uniform(40, 120) * t) * (1 + (p % 2) * np.sin(3 * t))
                 + 0.1 * rng.normal(size=n))
            if w == 1:
                x[rng.integers(0, n)] = 20.0 * (1 if p % 2 else -1)
            out.append((x.astype(np.float32), p % 2, f"p{p}"))
    return out


@pytest.fixture(scope="module")
def jax_classifier():
    win_len = WindowSpec(window_s=WINDOW_S).window_len(FS)
    cfg = JaxClassifierConfig(num_classes=2, head_hidden=(16,), encoder=JaxConfig.tiny(),
                              random_init=True, fs=FS)
    return jax_build(cfg, jax.random.key(0), win_len)


@pytest.mark.parametrize("wire_int16", [False, True])
def test_scoring_path_matches_jax(jax_classifier, wire_int16):
    model, variables = jax_classifier
    win_len = WindowSpec(window_s=WINDOW_S).window_len(FS)
    loader_len = WindowSpec(window_s=WINDOW_S).window_len(FS_WIRE)
    recs = _recordings()

    prep = _device_prep(FS_WIRE, FS, win_len)
    apply = make_apply_fn(model, variables)
    jax_logits = []

    def jax_apply(x):
        out = np.asarray(apply(prep(x)))
        jax_logits.append(out)
        return out

    jax_ds = JaxDataset([JaxFragment(w, y, p) for w, y, p in recs], fs=FS_WIRE)
    ref = jax_evaluate(jax_apply, JaxBatcher(jax_ds, BATCH, False, target_len=loader_len,
                                             wire_int16=wire_int16))

    port = build_classifier(ClassifierConfig(num_classes=2, head_hidden=(16,),
                                             encoder=Wav2Vec2Config.tiny(), fs=FS),
                            device="cpu")
    port.load_state_dict(from_jax(variables["params"]), strict=True)
    ds = FragmentDataset([Fragment(w, y, p) for w, y, p in recs], fs=FS_WIRE)
    got = score(port, Batcher(ds, BATCH, False, target_len=loader_len, wire_int16=wire_int16),
                FS_WIRE, FS, win_len)

    ref_logits = np.concatenate(jax_logits)
    assert got["logits"].shape == ref_logits.shape == (16, 2)
    np.testing.assert_allclose(got["logits"], ref_logits, atol=1e-4)
    assert got["fragment"] == ref["fragment"]
    assert got["patient"] == ref["patient"]
