"""The encoder on the JAX package's opt-in routes (``qkv_fuse=False``: K3a; ``conv_fuse=True``:
K8) against the JAX package on the CPU.

The JAX CPU path runs its einsum attention and XLA's conv + exact-erf GELU whatever the
gates say, so it is the reference for both routes at once. A tiny encoder whose conv_1
reaches 4096 frames (128 channels; a k=2/s=1 conv_0 so that 8194 samples suffice, and two
more k=3/s=2 layers below the threshold keep the attention at 1023 frames) takes K8 on
conv_1 only, and the unpacked attention in both layers. Its eval forward from the JAX init
(carried across by ``from_jax``) agrees at f32 atol 2e-5, and one ``fit`` step at rate 0
agrees with the JAX trainer at the bars of ``tests/test_torch_train.py``: the loss at 1e-4,
the trained weights at 2e-4 / 2e-3.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from wav2vec_heart_sounds_tpu.models.classifier import ClassifierConfig as JaxClassifierConfig
from wav2vec_heart_sounds_tpu.models.classifier import Wav2VecClassifier
from wav2vec_heart_sounds_tpu.models.wav2vec2 import Wav2Vec2Config as JaxConfig
from wav2vec_heart_sounds_tpu.train.classifier import SupervisedTrainer as JaxTrainer
from wav2vec_heart_sounds_tpu_torch.models.build import build_classifier
from wav2vec_heart_sounds_tpu_torch.models.classifier import ClassifierConfig
from wav2vec_heart_sounds_tpu_torch.models.from_jax import from_jax, to_jax
from wav2vec_heart_sounds_tpu_torch.models.wav2vec2 import Wav2Vec2Config, conv_fuse_layers
from wav2vec_heart_sounds_tpu_torch.ops.kernels import attention, conv
from wav2vec_heart_sounds_tpu_torch.train.classifier import SupervisedTrainer

N = 8194                       # conv_0 -> 8193, conv_1 -> 4096 (K8), conv_2 -> 2047, conv_3 -> 1023
ARCH = dict(conv_dim=(128, 128, 32, 32), conv_kernel=(2, 3, 3, 3), conv_stride=(1, 2, 2, 2))
NO_NOISE = dict(hidden_dropout=0.0, attention_dropout=0.0, activation_dropout=0.0,
                feat_proj_dropout=0.0, mask_time_prob=0.0)
BATCH = 2


@pytest.fixture(scope="module")
def jax_init():
    cfg = JaxClassifierConfig(num_classes=2, head_hidden=(16,), random_init=True, fs=4000,
                              encoder=JaxConfig.tiny(**ARCH, **NO_NOISE))
    model = Wav2VecClassifier(cfg, dtype=jnp.float32)  # build_classifier's random init, jitted
    variables = jax.jit(model.init)(jax.random.key(5), jnp.zeros((1, 1024), jnp.float32))
    return model, jax.device_get(variables)


def _waves(seed):
    rng = np.random.default_rng(seed)
    t = np.arange(N) / 4000
    x = np.sin(2 * np.pi * rng.uniform(30, 200, size=(BATCH, 1)) * t) \
        + 0.2 * rng.normal(size=(BATCH, N))
    return (x / np.abs(x).max(axis=1, keepdims=True)).astype(np.float32)


def _port_model(variables):
    encoder = Wav2Vec2Config.tiny(**ARCH, **NO_NOISE, qkv_fuse=False, conv_fuse=True)
    assert conv_fuse_layers(encoder, N) == [False, True, False, False]
    model = build_classifier(ClassifierConfig(head_hidden=(16,), fs=4000, encoder=encoder),
                             device="cpu", train=True)
    model.load_state_dict(from_jax(variables["params"]), strict=True)
    return model


class _Count:
    """Counts the calls of the plain K3a and K8 ops the gated route goes through."""

    def __init__(self, monkeypatch):
        self.calls = {"conv": 0, "attention": 0}
        for module, name, key in ((conv, "conv_gelu_fwd_reference", "conv"),
                                  (attention, "attention_reference", "attention")):
            real = getattr(module, name)

            def spy(*args, _real=real, _key=key, **kwargs):
                self.calls[_key] += 1
                return _real(*args, **kwargs)

            monkeypatch.setattr(module, name, spy)


def test_eval_forward_matches_jax_cpu(jax_init, monkeypatch):
    model, variables = jax_init
    x = _waves(0)
    ref = np.asarray(jax.jit(model.apply)(variables, jnp.asarray(x)))
    port = _port_model(variables).eval()
    count = _Count(monkeypatch)
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    assert count.calls == {"conv": 1, "attention": 2}        # conv_1, both layers
    np.testing.assert_allclose(got, ref, atol=2e-5)


def test_fit_step_matches_jax_trainer(jax_init, monkeypatch):
    model, variables = jax_init
    batches = [{"waveform": _waves(1), "label": np.array([0, 1], np.int32),
                "valid": np.ones(BATCH, bool)}]
    jax_trainer = JaxTrainer(model, variables, optimizer_name="sgd", lr=5e-2, weight_decay=1e-5,
                             log=lambda s: None)
    jax_losses = []
    run = jax_trainer._run_epoch

    def record(batcher, train, max_batches, *args):
        cm, loss = run(batcher, train, max_batches, *args)
        jax_losses.append(loss)
        return cm, loss

    jax_trainer._run_epoch = record
    jax_trainer.fit(batches, None, 1)
    port = _port_model(variables)
    trainer = SupervisedTrainer(port, optimizer_name="sgd", lr=5e-2, weight_decay=1e-5,
                                log=lambda s: None)
    losses = []
    run_port = trainer._run_epoch

    def record_port(batcher, train, max_batches):
        cm, loss = run_port(batcher, train, max_batches)
        losses.append(loss)
        return cm, loss

    trainer._run_epoch = record_port
    count = _Count(monkeypatch)
    trainer.fit(batches, None, 1)
    assert count.calls == {"conv": 1, "attention": 2}
    np.testing.assert_allclose(losses, jax_losses, atol=1e-4)
    trained = jax.device_get(jax_trainer.state.params)
    ours = to_jax(port.state_dict(), trained)
    for path in (("head", "dense_0", "kernel"),
                 ("encoder", "feature_projection", "projection", "kernel"),
                 ("encoder", "feature_encoder", "conv_1", "kernel"),
                 ("encoder", "layers_0", "attention", "q_proj", "base", "kernel")):
        a, b = ours, trained
        for key in path:
            a, b = a[key], b[key]
        assert not np.array_equal(np.asarray(b), _leaf(variables["params"], path))  # it trained
        np.testing.assert_allclose(a, np.asarray(b), atol=2e-4, rtol=2e-3, err_msg=str(path))


def _leaf(tree, path):
    for key in path:
        tree = tree[key]
    return np.asarray(tree)
