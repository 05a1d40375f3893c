"""The training slice end to end: the port's ``SupervisedTrainer`` vs the JAX package's.

Both train the tiny wav2vec2 classifier from the same ``from_jax`` init on the same fixed
batches of raw 2 kHz int16 windows, preprocessed on the device by each package's
``device_preprocess`` (dequant, PCG preprocessing, crop), with every dropout rate and
SpecAugment at 0 so both are deterministic; 3 epochs x 2 batches, float32. Per-epoch
losses agree at atol 1e-4 (preprocessing and model sums run in other orders, and the
port's training FFN uses the kernels' rational erf, 1.5e-7 from XLA's); the final head
and feature-projection weights at atol 2e-4 / rtol 2e-3. ``fit`` with a validation
batcher restores the best-MCC parameters and refreshes the float32 master. SpecAugment
and the dropout sites are checked on the port alone (the JAX masks come from another
generator).
"""

import numpy as np
import jax
import pytest
import torch

from wav2vec_heart_sounds_tpu.experiments.cinc import _device_prep as jax_device_prep
from wav2vec_heart_sounds_tpu.models.build import build_classifier as jax_build
from wav2vec_heart_sounds_tpu.models.classifier import ClassifierConfig as JaxClassifierConfig
from wav2vec_heart_sounds_tpu.models.wav2vec2 import Wav2Vec2Config as JaxConfig
from wav2vec_heart_sounds_tpu.train.classifier import SupervisedTrainer as JaxTrainer
from wav2vec_heart_sounds_tpu.train.losses import cross_entropy as jax_cross_entropy
from wav2vec_heart_sounds_tpu_torch.experiments.cinc import _device_prep
from wav2vec_heart_sounds_tpu_torch.models.build import build_classifier
from wav2vec_heart_sounds_tpu_torch.models.classifier import ClassifierConfig
from wav2vec_heart_sounds_tpu_torch.models.from_jax import from_jax, to_jax
from wav2vec_heart_sounds_tpu_torch.models.wav2vec2 import (
    Wav2Vec2Config, layer_sites, sample_time_mask)
from wav2vec_heart_sounds_tpu_torch.ops.kernels import dropout as k_dropout
from wav2vec_heart_sounds_tpu_torch.train.classifier import SupervisedTrainer
from wav2vec_heart_sounds_tpu_torch.train.losses import cross_entropy

FS_WIRE, FS, BATCH = 2000, 4000, 4
WIN = FS                                               # 1 s windows
NO_NOISE = dict(hidden_dropout=0.0, attention_dropout=0.0, activation_dropout=0.0,
                feat_proj_dropout=0.0, mask_time_prob=0.0)


def _batches(n, seed, int16=True):
    rng = np.random.default_rng(seed)
    t = np.arange(FS_WIRE) / FS_WIRE
    out = []
    for _ in range(n):
        x = (np.sin(2 * np.pi * rng.uniform(30, 200, size=(BATCH, 1)) * t)
             + 0.2 * rng.normal(size=(BATCH, FS_WIRE)))
        x = x / np.abs(x).max(axis=1, keepdims=True)
        wave = np.round(x * 32767).astype(np.int16) if int16 else x.astype(np.float32)
        out.append({"waveform": wave, "label": np.arange(BATCH, dtype=np.int32) % 2,
                    "valid": np.ones(BATCH, dtype=bool)})
    return out


@pytest.fixture(scope="module")
def jax_init():
    cfg = JaxClassifierConfig(num_classes=2, head_hidden=(16,), random_init=True, fs=FS,
                              encoder=JaxConfig.tiny(**NO_NOISE))
    model, variables = jax_build(cfg, jax.random.key(3), WIN)
    return model, jax.device_get(variables)   # host copies: the JAX train step donates its inputs


def _recorded(trainer):
    """Wrap ``_run_epoch`` to record each train epoch's mean loss (same API on both sides)."""
    losses, run = [], trainer._run_epoch

    def record(batcher, train, max_batches, *args):
        cm, loss = run(batcher, train, max_batches, *args)
        if train:
            losses.append(loss)
        return cm, loss

    trainer._run_epoch = record
    return losses


def _port_trainer(variables, name, lr, seed=0, ffn_mega=True):
    encoder = Wav2Vec2Config.tiny(**NO_NOISE, ffn_mega=ffn_mega)
    model = build_classifier(ClassifierConfig(head_hidden=(16,), fs=FS, encoder=encoder),
                             device="cpu", train=True)
    model.load_state_dict(from_jax(variables["params"]), strict=True)
    return model, SupervisedTrainer(model, optimizer_name=name, lr=lr, weight_decay=1e-5,
                                    device_preprocess=_device_prep(FS_WIRE, FS, WIN, "cpu"),
                                    seed=seed, log=lambda s: None)


def _compare_params(port_model, jax_params):
    ours = to_jax(port_model.state_dict(), jax_params)
    for path in (("head", "dense_0", "kernel"), ("encoder", "feature_projection",
                                                 "projection", "kernel")):
        a, b = ours, jax_params
        for key in path:
            a, b = a[key], b[key]
        np.testing.assert_allclose(a, np.asarray(b), atol=2e-4, rtol=2e-3, err_msg=str(path))


@pytest.mark.parametrize("ffn_mega", [True, False])
@pytest.mark.parametrize("name,lr", [("sgd", 5e-3), ("adamw", 1e-3)])
def test_fit_matches_jax_trainer(jax_init, name, lr, ffn_mega):
    """Both FFN routes of the port (K4, and the K5 + K2 control) against the JAX trainer."""
    model, variables = jax_init
    train = _batches(2, seed=0)
    jax_trainer = JaxTrainer(model, variables, optimizer_name=name, lr=lr, weight_decay=1e-5,
                             device_preprocess=jax_device_prep(FS_WIRE, FS, WIN),
                             log=lambda s: None)
    jax_losses = _recorded(jax_trainer)
    jax_trainer.fit(train, None, 3)
    port, trainer = _port_trainer(variables, name, lr, ffn_mega=ffn_mega)
    losses = _recorded(trainer)
    trainer.fit(train, None, 3)
    assert len(losses) == len(jax_losses) == 3
    np.testing.assert_allclose(losses, jax_losses, atol=1e-4)
    assert losses[-1] < losses[0]
    _compare_params(port, jax.device_get(jax_trainer.state.params))


def test_fit_restores_best_mcc_like_jax(jax_init):
    model, variables = jax_init
    train, valid = _batches(2, seed=0), _batches(2, seed=3, int16=False)
    jax_trainer = JaxTrainer(model, variables, optimizer_name="sgd", lr=2e-2,
                             device_preprocess=jax_device_prep(FS_WIRE, FS, WIN),
                             log=lambda s: None)
    jax_best = jax_trainer.fit(train, valid, 3)
    port, trainer = _port_trainer(variables, "sgd", 2e-2)
    snapshots, mccs, run = [], [], trainer._run_epoch

    def record(batcher, is_train, max_batches):
        cm, loss = run(batcher, is_train, max_batches)
        if not is_train:
            mccs.append(cm.stats()["mcc"])
            snapshots.append({k: v.clone() for k, v in port.state_dict().items()})
        return cm, loss

    trainer._run_epoch = record
    best = trainer.fit(train, valid, 3)
    assert best == jax_best == max(mccs)
    assert mccs.index(best) < len(mccs) - 1                  # the restore goes back in time
    restored = snapshots[mccs.index(best)]
    for key, value in port.state_dict().items():
        torch.testing.assert_close(value, restored[key], rtol=0, atol=0)
    _compare_params(port, jax.device_get(jax_trainer.state.params))
    # the float32 master follows the restore: the next step starts from the restored weights
    for p, m in zip(trainer.optimizer.params, trainer.optimizer.master):
        torch.testing.assert_close(p.detach().float(), m, rtol=0, atol=0)


def test_build_classifier_defaults_to_the_card():
    """Every entry point runs on the card unless the caller asks for the CPU."""
    import inspect

    assert inspect.signature(build_classifier).parameters["device"].default == "cuda"
    model = build_classifier(ClassifierConfig(head_hidden=(8,), random_init=True,
                                              encoder=Wav2Vec2Config.tiny()), device="meta")
    assert next(model.parameters()).device.type == "meta"


def test_cross_entropy_matches_jax():
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(6, 2)).astype(np.float32)
    labels = np.array([0, 1, 1, 0, 1, 0], np.int32)
    for valid in (None, np.array([1, 1, 0, 1, 0, 1], np.float32), np.zeros(6, np.float32)):
        ref = float(jax_cross_entropy(logits, labels, valid))
        got = float(cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels),
                                  None if valid is None else torch.from_numpy(valid)))
        assert np.isclose(got, ref, atol=1e-6)


def test_spec_augment_spans():
    gen = torch.Generator().manual_seed(0)
    length, span, prob = 199, 10, 0.05
    mask = sample_time_mask(gen, 64, length, prob, span)
    assert mask.shape == (64, length) and mask.dtype == torch.bool
    # max(1, int(0.05 * 199)) = 9 spans of 10 frames, starts in [0, 189): runs of >= 10
    gen = torch.Generator().manual_seed(0)
    starts = torch.randint(0, length - span, (64, max(1, int(prob * length))), generator=gen)
    assert starts.shape[1] == 9 and int(starts.max()) < length - span
    expected = torch.zeros(64, length, dtype=torch.bool)
    for row, row_starts in enumerate(starts):
        for s in row_starts:
            expected[row, s:s + span] = True
    torch.testing.assert_close(mask, expected, rtol=0, atol=0)
    assert not bool(mask[:, length - 1].any())               # starts < T' - 10: last frame kept
    assert int(sample_time_mask(gen, 2, 5, 0.05, 10).sum(1).max()) <= 5   # T' < span: start 0


def test_masked_frames_take_the_embedding_and_pass_its_gradient():
    cfg = ClassifierConfig(head_hidden=(8,), fs=FS,
                           encoder=Wav2Vec2Config.tiny(**{**NO_NOISE, "mask_time_prob": 0.3}))
    model = build_classifier(cfg, seed=1, device="cpu", train=True)
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(3, WIN)).astype(np.float32))
    logits = model(x, train=True, generator=torch.Generator().manual_seed(4))
    logits.sum().backward()
    grad = model.encoder.masked_spec_embed.grad
    assert grad is not None and float(grad.abs().sum()) > 0
    with torch.no_grad():
        ref = model(x)                                       # eval: no mask
        model.encoder.masked_spec_embed.zero_()
    assert not torch.allclose(logits.detach(), ref)


def test_training_forward_draws_from_the_generator_and_uses_every_site(monkeypatch):
    cfg = Wav2Vec2Config.tiny()
    model = build_classifier(ClassifierConfig(head_hidden=(8,), fs=FS, encoder=cfg),
                             device="cpu", train=True)
    sites = []
    real = k_dropout.dropout

    def spy(x, seed, site, rate):
        sites.append((seed, site))
        return real(x, seed, site, rate)

    monkeypatch.setattr("wav2vec_heart_sounds_tpu_torch.models.wav2vec2.dropout", spy)
    x = torch.from_numpy(np.random.default_rng(1).normal(size=(2, WIN)).astype(np.float32))
    a = model(x, train=True, generator=torch.Generator().manual_seed(9))
    b = model(x, train=True, generator=torch.Generator().manual_seed(9))
    c = model(x, train=True, generator=torch.Generator().manual_seed(10))
    torch.testing.assert_close(a, b, rtol=0, atol=0)          # same generator state, same step
    assert not torch.allclose(a, c)
    assert [s for _, s in sites[:2]] == [0, 1] and sites[0][0] == sites[1][0]
    assert len({seed for seed, _ in sites}) == 2              # one base seed per forward
    all_sites = {0, 1} | {s for i in range(cfg.num_layers) for s in layer_sites(i)}
    assert len(all_sites) == 2 + 4 * cfg.num_layers
