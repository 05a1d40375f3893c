"""The vest slice end to end: the port's multichannel LoRA classifier, freeze mask, losses,
masked optimizer, vest augmentation and runner vs the JAX package's, on the CPU.

A tiny encoder (``Wav2Vec2Config.tiny``) with LoRA r=8 behind the sinc beamformer (3
microphones, 600 samples at 1 kHz, so delays clip at 10 samples), float32, every dropout,
SpecAugment and the LoRA dropout at 0 so both packages are deterministic; the JAX weights
carried over by ``from_jax`` (``lora_b`` and the delay predictor's output bias set so the
bypass and the delays matter). Bars: the forward at atol 1e-4 (the beamformer's 41-tap
sums and two attention layers in other orders ahead of the encoder), one AdamW step's loss
at 1e-4 and its parameters at 2e-4 / 2e-3 (the bar of ``tests/test_torch_train.py``), the
on-device vest augmentation at 1e-5 with injected draws, and the runner's record exactly.
"""

import types

import numpy as np
import jax
import jax.numpy as jnp
import pandas as pd
import pytest
import torch
from scipy.io import wavfile

from wav2vec_heart_sounds_tpu.augment import jaxaug
from wav2vec_heart_sounds_tpu.augment.pipelines import (MULTI_PROB_NOISE, MULTI_PROB_REAL_NOISE,
                                                        MULTI_PROB_WANDER)
from wav2vec_heart_sounds_tpu.experiments import multichannel as jax_runner
from wav2vec_heart_sounds_tpu.models.classifier import ClassifierConfig as JaxClassifierConfig
from wav2vec_heart_sounds_tpu.models.classifier import Wav2VecClassifier as JaxClassifier
from wav2vec_heart_sounds_tpu.models.classifier import trainable_mask as jax_trainable_mask
from wav2vec_heart_sounds_tpu.models.wav2vec2 import Wav2Vec2Config as JaxConfig
from wav2vec_heart_sounds_tpu.train import losses as jax_losses
from wav2vec_heart_sounds_tpu.train.classifier import SupervisedTrainer as JaxTrainer
from wav2vec_heart_sounds_tpu_torch.augment import torchaug
from wav2vec_heart_sounds_tpu_torch.experiments import multichannel as runner
from wav2vec_heart_sounds_tpu_torch.models import from_jax as fj
from wav2vec_heart_sounds_tpu_torch.models.build import build_classifier
from wav2vec_heart_sounds_tpu_torch.models.classifier import (ClassifierConfig,
                                                              Wav2VecClassifier,
                                                              trainable_mask)
from wav2vec_heart_sounds_tpu_torch.models.wav2vec2 import Wav2Vec2Config, lora_sites
from wav2vec_heart_sounds_tpu_torch.train import losses
from wav2vec_heart_sounds_tpu_torch.train.classifier import SupervisedTrainer

M, T, FS, B = 3, 600, 1000, 4
QUIET = dict(hidden_dropout=0.0, attention_dropout=0.0, activation_dropout=0.0,
             feat_proj_dropout=0.0, mask_time_prob=0.0, lora_dropout=0.0)


def _configs(lora=True, freeze=False):
    jcfg = JaxClassifierConfig(num_channels=M, head_hidden=(8,), random_init=True, fs=FS,
                               lora=lora, freeze_encoder=freeze,
                               encoder=JaxConfig.tiny(**QUIET))
    cfg = ClassifierConfig(num_channels=M, head_hidden=(8,), random_init=True, fs=FS,
                           lora=lora, freeze_encoder=freeze, encoder=Wav2Vec2Config.tiny(**QUIET))
    return jcfg, cfg


def _wave(b=B, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(T) / FS
    x = np.sin(2 * np.pi * rng.uniform(30, 120, size=(b, 1, 1)) * t[None, :, None]
               + rng.uniform(0, 1, size=(1, 1, M)))
    return (x + 0.1 * rng.normal(size=(b, T, M))).astype(np.float32)


def _init(jcfg, seed=1):
    params = jax.device_get(JaxClassifier(jcfg).init(jax.random.key(seed),
                                                     jnp.asarray(_wave(1))))["params"]
    rng = np.random.default_rng(seed)
    for name, layer in params["encoder"].items():
        for proj in ("q_proj", "v_proj"):
            if name.startswith("layers_") and "lora_b" in layer["attention"][proj]:
                lb = layer["attention"][proj]["lora_b"]
                layer["attention"][proj]["lora_b"] = (0.1 * rng.normal(size=lb.shape)).astype(
                    np.float32)
    out = params["channel_mixer"]["delay_predictor"]["output_proj"]
    out["bias"] = np.asarray(4.0 + rng.normal(size=out["bias"].shape), np.float32)
    return params


@pytest.fixture(scope="module")
def lora_pair():
    jcfg, cfg = _configs()
    params = _init(jcfg)
    model = build_classifier(cfg, device="cpu")
    model.load_state_dict(fj.from_jax(params), strict=True)
    return jcfg, cfg, params, model


def test_multichannel_lora_classifier_matches_jax(lora_pair):
    jcfg, _, params, model = lora_pair
    x = _wave(seed=2)
    jm = JaxClassifier(jcfg)
    ref_logits = jm.apply({"params": params}, jnp.asarray(x))
    ref_feats, ref_logits2 = jm.apply({"params": params}, jnp.asarray(x),
                                      method=JaxClassifier.forward_with_features)
    with torch.inference_mode():
        logits = model(torch.from_numpy(x))
        feats, logits2 = model.forward_with_features(torch.from_numpy(x))
    assert feats.shape == (B, 32) and feats.dtype == torch.float32
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits), atol=1e-4)
    np.testing.assert_allclose(feats.numpy(), np.asarray(ref_feats), atol=1e-4)
    np.testing.assert_allclose(logits2.numpy(), np.asarray(ref_logits2), atol=1e-4)
    with torch.inference_mode():                          # the bypass changes the output
        for name, p in model.named_parameters():
            if name.endswith("lora_b"):
                p.zero_()
        plain = model(torch.from_numpy(x))
        model.load_state_dict(fj.from_jax(params), strict=True)
    assert not torch.allclose(plain, logits, atol=1e-3)


@pytest.mark.parametrize("lora,freeze", [(False, False), (True, False), (False, True),
                                         (True, True)])
def test_trainable_mask_matches_jax(lora, freeze):
    jcfg, cfg = _configs(lora, freeze)
    params = jax.device_get(JaxClassifier(jcfg).init(jax.random.key(0),
                                                     jnp.asarray(_wave(1))))["params"]
    theirs = {tuple(getattr(k, "key", k) for k in path): bool(v) for path, v in
              jax.tree_util.tree_leaves_with_path(jax_trainable_mask(params, jcfg))}
    ours = trainable_mask(build_classifier(cfg, device="cpu"), cfg)
    pairs = [(ours[key], theirs[path]) for path, key, _ in fj.layout(params)]
    assert len(pairs) == len(ours) == len(theirs)
    assert all(a == b for a, b in pairs)
    assert any(a for a, _ in pairs) and (lora or freeze) == (not all(a for a, _ in pairs))


def test_from_jax_round_trips_lora_and_beamformer_leaves(lora_pair):
    _, cfg, params, _ = lora_pair
    sd = fj.from_jax(params)
    port = Wav2VecClassifier(cfg)
    assert set(sd) == set(port.state_dict())
    for key, value in port.state_dict().items():
        assert tuple(sd[key].shape) == tuple(value.shape), key
    assert any(k.endswith("lora_a") for k in sd) and any("attn_1.query" in k for k in sd)
    original = {jax.tree_util.keystr(p): np.asarray(v)
                for p, v in jax.tree_util.tree_leaves_with_path(params)}
    back = {jax.tree_util.keystr(p): v
            for p, v in jax.tree_util.tree_leaves_with_path(fj.to_jax(sd, params))}
    assert set(back) == set(original)
    for path, value in original.items():
        np.testing.assert_array_equal(back[path], value, err_msg=path)


def test_lora_sites_collide_with_no_layer_site():
    from wav2vec_heart_sounds_tpu_torch.models.wav2vec2 import (SITE_ENCODER,
                                                                SITE_FEATURE_PROJECTION,
                                                                layer_sites)

    n = 12
    sites = [SITE_FEATURE_PROJECTION, SITE_ENCODER]
    sites += [s for i in range(n) for s in layer_sites(i)]
    sites += [s for i in range(n) for s in lora_sites(i, n)]
    assert len(set(sites)) == len(sites) == 2 + 6 * n


def _batches(n, seed):
    return [{"waveform": _wave(seed=seed + i), "label": np.arange(B, dtype=np.int32) % 2,
             "valid": np.ones(B, dtype=bool)} for i in range(n)]


def _leaf(tree, path):
    for key in path:
        tree = tree[key]
    return np.asarray(tree)


@pytest.mark.parametrize("criterion", [None, "contrastive-focal"])
def test_masked_adamw_step_matches_jax_trainer(lora_pair, criterion):
    """One AdamW step under the LoRA freeze mask, centres injected into both trainers."""
    jcfg, cfg, params, _ = lora_pair
    crit = jax_crit = None
    if criterion:
        crit = losses.ContrastiveFocalConfig(feature_dim=32)
        jax_crit = jax_losses.ContrastiveFocalConfig(feature_dim=32)
    centers = np.random.default_rng(3).normal(size=(2, 32)).astype(np.float32)
    batches = _batches(1, seed=4)
    jax_trainer = JaxTrainer(JaxClassifier(jcfg), {"params": params}, optimizer_name="adamw",
                             lr=1e-4, criterion=jax_crit, classifier_config=jcfg,
                             log=lambda s: None)
    if criterion:
        jax_trainer.state.loss_params = {"centers": jnp.asarray(centers)}
    jax_losses_seen, run = [], jax_trainer._run_epoch

    def record(*args):
        cm, loss = run(*args)
        jax_losses_seen.append(loss)
        return cm, loss

    jax_trainer._run_epoch = record
    jax_trainer.fit(batches, None, 1)

    model = build_classifier(cfg, device="cpu", train=True)
    model.load_state_dict(fj.from_jax(params), strict=True)
    trainer = SupervisedTrainer(model, optimizer_name="adamw", lr=1e-4, criterion=crit,
                                classifier_config=cfg, log=lambda s: None)
    if criterion:
        with torch.no_grad():
            trainer.loss_params["centers"].copy_(torch.from_numpy(centers))
    port_losses, prun = [], trainer._run_epoch

    def precord(*args):
        cm, loss = prun(*args)
        port_losses.append(loss)
        return cm, loss

    trainer._run_epoch = precord
    trainer.fit(batches, None, 1)

    np.testing.assert_allclose(port_losses, jax_losses_seen, atol=1e-4)
    trained = jax.device_get(jax_trainer.state.params)
    ours = fj.to_jax(model.state_dict(), params)
    mask = trainable_mask(model, cfg)
    moved = 0
    for path, key, _ in fj.layout(params):
        a, b, init = _leaf(ours, path), _leaf(trained, path), _leaf(params, path)
        if mask[key]:
            np.testing.assert_allclose(a, b, atol=2e-4, rtol=2e-3, err_msg=str(path))
            moved += int(not np.array_equal(a, init))
        else:
            np.testing.assert_array_equal(a, init, err_msg=str(path))     # frozen: untouched
            np.testing.assert_array_equal(b, init, err_msg=str(path))
    assert moved > 0
    assert not any(p.requires_grad for n, p in model.named_parameters() if not mask[n])
    if criterion:
        np.testing.assert_allclose(trainer.loss_params["centers"].detach().numpy(),
                                   np.asarray(jax_trainer.state.loss_params["centers"]),
                                   atol=2e-4, rtol=2e-3)


def test_contrastive_focal_loss_matches_jax():
    rng = np.random.default_rng(5)
    feats = rng.normal(size=(6, 16)).astype(np.float32)
    logits = rng.normal(size=(6, 2)).astype(np.float32)
    labels = np.array([0, 1, 1, 0, 1, 1], np.int32)
    centers = rng.normal(size=(2, 16)).astype(np.float32)
    cfg, jcfg = (losses.ContrastiveFocalConfig(feature_dim=16),
                 jax_losses.ContrastiveFocalConfig(feature_dim=16))
    single = np.array([0, 1, 1, 1, 1, 1], np.int32)               # a class without positives
    for lab in (labels, single):
        got = losses.contrastive_focal_loss({"centers": torch.from_numpy(centers)}, cfg,
                                            torch.from_numpy(feats), torch.from_numpy(logits),
                                            torch.from_numpy(lab))
        want = jax_losses.contrastive_focal_loss({"centers": jnp.asarray(centers)}, jcfg,
                                                 jnp.asarray(feats), jnp.asarray(logits),
                                                 jnp.asarray(lab))
        np.testing.assert_allclose(float(got), float(want), atol=1e-5)
    np.testing.assert_allclose(
        float(losses.center_loss(torch.from_numpy(centers), torch.from_numpy(feats),
                                 torch.from_numpy(labels))),
        float(jax_losses.center_loss(jnp.asarray(centers), jnp.asarray(feats),
                                     jnp.asarray(labels))), atol=1e-5)


class _InjectedRandom:
    """``jax.random`` for ``jaxaug``: every draw comes from a queue, in call order."""

    def __init__(self, values):
        self.values = list(values)

    def split(self, key, num=2):
        return [key] * num

    def fold_in(self, key, data):
        return key

    def uniform(self, key, shape=(), dtype=jnp.float32, minval=0.0, maxval=1.0):
        return minval + jnp.asarray(self.values.pop(0), dtype).reshape(shape) * (maxval - minval)

    def choice(self, key, a):
        return a[self.values.pop(0)]

    def normal(self, key, shape=(), dtype=jnp.float32):
        return jnp.asarray(self.values.pop(0), dtype).reshape(shape)

    def randint(self, key, shape, minval, maxval):
        return jnp.asarray(self.values.pop(0), jnp.int32).reshape(shape)


@pytest.mark.parametrize("pristine", [None, 0.25])
def test_vest_batch_augmentation_matches_jaxaug(monkeypatch, pristine):
    """Wander, white noise and recorded noise (gates forced open on some samples) and
    participation: the port's core vs ``jaxaug``'s with the same draws."""
    b, c, t, fs = 4, M, T, 4125
    rng = np.random.default_rng(6)
    x = _wave(b, seed=7) * 2.0                              # not normalised
    bank = rng.normal(size=(5, t)).astype(np.float32)
    u = lambda *shape: rng.random(shape, dtype=np.float32)  # noqa: E731
    wander = {"amp": u(2, b), "freq": u(2, b), "phase": u(2, b), "gate": u(b)}
    noise = {"gate": u(b), "std": 2, "scale": u(b * c),
             "normal": rng.normal(size=(b * c, t)).astype(np.float32)}
    recorded = {"index": rng.integers(0, 5, size=b), "gate": u(b)}
    wander["gate"][:2], noise["gate"][1:3], recorded["gate"][::2] = 0.0, 0.0, 0.0
    queue = [wander[k][i].reshape(b, 1) for i in range(2) for k in ("amp", "freq", "phase")]
    queue += [wander["gate"].reshape(b, 1, 1), noise["gate"].reshape(b, 1, 1), noise["std"],
              noise["scale"].reshape(b * c, 1), noise["normal"], recorded["index"],
              recorded["gate"].reshape(b, 1, 1)]
    draws = {"wander": {k: torch.from_numpy(v) for k, v in wander.items()},
             "noise": {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
                       for k, v in noise.items()},
             "recorded": {"index": torch.from_numpy(recorded["index"]),
                          "gate": torch.from_numpy(recorded["gate"])}}
    if pristine is not None:
        part = u(b)
        part[0], part[1] = 0.1, 0.9
        queue.append(part)
        draws["participate"] = torch.from_numpy(part >= pristine)
    stub = _InjectedRandom(queue)
    monkeypatch.setattr(jaxaug, "jax", types.SimpleNamespace(random=stub, lax=jax.lax))
    y = jaxaug._augment_multi_batch.__wrapped__(
        None, jnp.swapaxes(jnp.asarray(x), 1, 2).reshape(b * c, t), b, fs, MULTI_PROB_NOISE,
        MULTI_PROB_WANDER, MULTI_PROB_REAL_NOISE, jnp.asarray(bank))
    want = jnp.swapaxes(y.reshape(b, c, t), 1, 2)
    if pristine is not None:
        keep = jaxaug._participation(None, b, None, pristine)
        want = jnp.where(keep[:, None, None], want, jnp.asarray(x))
    assert not stub.values
    got = torchaug.apply_multi_pcg_batch(torch.from_numpy(x), fs, draws, torch.from_numpy(bank))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    if pristine is not None:
        off = ~draws["participate"]
        assert torch.equal(got[off], torch.from_numpy(x)[off])


def test_vest_batch_augmentation_draws_in_a_fixed_order():
    x = torch.from_numpy(_wave(seed=8))
    a = torchaug.augment_multi_pcg_batch(torch.Generator().manual_seed(2), x, FS)
    b = torchaug.augment_multi_pcg_batch(torch.Generator().manual_seed(2), x, FS)
    assert a.shape == x.shape and torch.equal(a, b)
    bank = torch.from_numpy(np.random.default_rng(9).normal(size=(3, T)).astype(np.float32))
    draws = torchaug.draw_multi_pcg_batch(torch.Generator(), B, M, T, "cpu", bank_size=3,
                                          row_mask=torch.tensor([1.0, 0.0, 1.0, 0.0]))
    assert set(draws) == {"wander", "noise", "recorded", "participate"}
    assert draws["noise"]["scale"].shape == (B * M,) and draws["noise"]["gate"].shape == (B,)
    y = torchaug.augment_multi_pcg_batch(torch.Generator().manual_seed(2), x, FS,
                                         row_mask=torch.tensor([1.0, 0.0, 1.0, 0.0]),
                                         noise_bank=bank)
    assert torch.equal(y[1], x[1]) and torch.equal(y[3], x[3])


@pytest.fixture(scope="module")
def vest_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("vest")
    fs = 2000
    t = np.arange(int(fs * 6.0)) / fs
    for pat, f0 in (("patientA", 80.0), ("patientB", 120.0)):
        sig = np.stack([np.sin(2 * np.pi * (f0 + 10 * c) * (t - 0.002 * c))
                        for c in range(9)], axis=1)
        wavfile.write(str(d / f"{pat}_rec.wav"), fs, (sig * 20000).astype(np.int16))
    pd.DataFrame([
        {"patient": "patientA", "label": 1, "split": "train"},
        {"patient": "patientB", "label": -1, "split": "train"},
        {"patient": "patientA", "label": 1, "split": "valid"},
        {"patient": "patientB", "label": -1, "split": "test"},
        {"patient": "patientA", "label": 1, "split": "test"},
    ]).to_csv(d / "split.csv", index=False)
    return d


def test_multichannel_run_matches_jax_runner(vest_dir, tmp_path, monkeypatch):
    """LoRA (``random_init=False``: offline, both builders keep their random init), the
    freeze mask, AdamW, the MLP and SVM records, from one initial state."""
    monkeypatch.setenv("W2VHS_NO_NATIVE", "1")
    captured = {}
    jax_build = jax_runner.build_classifier

    def capture_init(*args, **kwargs):
        model, variables = jax_build(*args, **kwargs)
        captured["init"] = jax.device_get(variables)
        return model, variables

    monkeypatch.setattr(jax_runner, "build_classifier", capture_init)
    port_build = runner.build_classifier

    def port_init(cfg, **kwargs):
        model = port_build(cfg, **kwargs)
        model.load_state_dict(fj.from_jax(captured["init"]["params"]), strict=True)
        captured["port"] = model
        return model

    monkeypatch.setattr(runner, "build_classifier", port_init)
    kw = dict(channels=[1, 2, 3], fs=FS, window_s=2.0, epochs=2, augment=False,
              random_init=False, fit_svm=True, batch_size=2, max_batches=2)
    csv = str(vest_dir / "split.csv")
    theirs = jax_runner.run(str(vest_dir), csv, encoder_config=JaxConfig.tiny(**QUIET), **kw)
    ours = runner.run(str(vest_dir), csv, encoder_config=Wav2Vec2Config.tiny(**QUIET),
                      results_json=str(tmp_path / "port.json"), device="cpu",
                      dtype=torch.float32, **kw)
    assert {"mlp", "svm"} <= set(ours)
    assert ours == theirs
    assert any(k.endswith("lora_a") for k in captured["port"].state_dict())
