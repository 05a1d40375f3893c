"""Rematerialisation (``Wav2Vec2Config.remat`` / ``remat_conv``) on the CPU.

One training step of a tiny classifier from one seed, without remat, with ``remat`` and with
``remat`` + ``remat_conv``: the loss and every parameter's gradient equal bit for bit, at
dropout rate 0 and at the default rates with SpecAugment (the recompute regenerates the same
Philox masks from the step seed), with LoRA on, on the decomposed FFN route, with K8
(``conv_fuse``) through its plain version, and on the stable-layer-norm family's encoder.
Forward hooks show that the remat arms run each layer's (and the conv stack's) forward twice. At
rate 0 the port's ``remat=True, remat_conv=True`` gradients agree with the JAX package's on the
same variables (its ``nn.remat`` encoder) at atol 1e-4 / rtol 1e-3, the gradient bar of
``tests/test_torch_attention_unpacked.py``. Eval, and a training forward without gradients, run
as before.
"""

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wav2vec_heart_sounds_tpu.models.classifier import ClassifierConfig as JaxClassifierConfig
from wav2vec_heart_sounds_tpu.models.classifier import Wav2VecClassifier as JaxClassifier
from wav2vec_heart_sounds_tpu.models.wav2vec2 import Wav2Vec2Config as JaxConfig
from wav2vec_heart_sounds_tpu.train.losses import cross_entropy as jax_cross_entropy
from wav2vec_heart_sounds_tpu_torch.models.build import build_classifier
from wav2vec_heart_sounds_tpu_torch.models.classifier import ClassifierConfig
from wav2vec_heart_sounds_tpu_torch.models.from_jax import from_jax
from wav2vec_heart_sounds_tpu_torch.models.wav2vec2 import Wav2Vec2Config, conv_fuse_layers
from wav2vec_heart_sounds_tpu_torch.train.losses import cross_entropy
from torch_vocoder_pairs import one_torch_thread  # noqa: F401,E402  (one intra-op thread)

NO_NOISE = dict(hidden_dropout=0.0, attention_dropout=0.0, activation_dropout=0.0,
                feat_proj_dropout=0.0, mask_time_prob=0.0)
# tests/test_torch_gated_route.py's encoder: conv_1 reaches 4096 frames, so K8 takes it.
GATED = dict(conv_dim=(128, 128, 32, 32), conv_kernel=(2, 3, 3, 3), conv_stride=(1, 2, 2, 2),
             qkv_fuse=False, conv_fuse=True)
CASES = {"rate 0": ({**NO_NOISE}, False, 1200),
         "rate 0.1": ({}, False, 1200),
         "lora": ({}, True, 1200),
         "decomposed ffn": ({"ffn_mega": False}, False, 1200),
         "conv_fuse": ({**GATED}, False, 8194),
         "stable layer norm": ({"feat_extract_norm": "layer", "conv_bias": True,
                                "do_stable_layer_norm": True}, False, 1200)}
ARMS = ({}, {"remat": True}, {"remat": True, "remat_conv": True})
BATCH = 3


def _waves(n, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).normal(0, 0.5, (BATCH, n))
                            .astype(np.float32))


def _config(fields, lora, arm):
    return ClassifierConfig(head_hidden=(16,), fs=4000, lora=lora, random_init=True,
                            encoder=Wav2Vec2Config.tiny(**fields, **arm))


def _step(cfg, x, calls=None):
    """(loss, {name: grad}) of one training step from seed 0 and step generator 7."""
    model = build_classifier(cfg, seed=0, device="cpu", train=True)
    if calls is not None:
        for name in ("feature_extractor", "layers.0", "layers.1"):
            module = model.encoder.get_submodule(name if "layers" not in name
                                                 else "encoder." + name)
            calls[name] = 0
            module.register_forward_pre_hook(
                lambda m, a, name=name: calls.__setitem__(name, calls[name] + 1))
    y = torch.arange(BATCH) % 2
    loss = cross_entropy(model(x, train=True, generator=torch.Generator().manual_seed(7)), y)
    loss.backward()
    return loss.detach(), {n: p.grad for n, p in model.named_parameters()}


@pytest.mark.parametrize("case", list(CASES))
def test_remat_step_is_bit_for_bit(case):
    fields, lora, n = CASES[case]
    x = _waves(n)
    if case == "conv_fuse":
        assert conv_fuse_layers(Wav2Vec2Config.tiny(**fields), n) == [False, True, False, False]
    steps, calls = [], []
    for arm in ARMS:
        counted = {}
        steps.append(_step(_config(fields, lora, arm), x, counted))
        calls.append(counted)
    loss, grads = steps[0]
    # SpecAugment off: masked_spec_embed takes no part in the step
    assert all((g is None) == (name == "encoder.masked_spec_embed" and case == "rate 0")
               for name, g in grads.items())
    for (other_loss, other), arm in zip(steps[1:], ARMS[1:]):
        assert torch.equal(other_loss, loss), arm
        assert other.keys() == grads.keys()
        for name, g in grads.items():
            assert (other[name] is None and g is None) or torch.equal(other[name], g), \
                (arm, name)
    assert calls[0] == {"feature_extractor": 1, "layers.0": 1, "layers.1": 1}
    assert calls[1] == {"feature_extractor": 1, "layers.0": 2, "layers.1": 2}
    assert calls[2] == {"feature_extractor": 2, "layers.0": 2, "layers.1": 2}


def test_remat_gradients_match_jax_remat():
    x = _waves(1200, seed=1)
    y = np.arange(BATCH) % 2
    jcfg = JaxClassifierConfig(num_classes=2, head_hidden=(16,), random_init=True, fs=4000,
                               encoder=JaxConfig.tiny(**NO_NOISE, remat=True, remat_conv=True))
    jmodel = JaxClassifier(jcfg)
    params = jmodel.init(jax.random.key(2), jnp.asarray(x.numpy()))["params"]

    def loss_fn(p):
        logits = jmodel.apply({"params": p}, jnp.asarray(x.numpy()), train=True,
                              rngs={"dropout": jax.random.key(3)})
        return jax_cross_entropy(logits, jnp.asarray(y))

    jax_loss, jax_grads = jax.value_and_grad(loss_fn)(params)
    want = from_jax(jax.device_get(jax_grads))
    cfg = ClassifierConfig(head_hidden=(16,), fs=4000, random_init=True,
                           encoder=Wav2Vec2Config.tiny(**NO_NOISE, remat=True, remat_conv=True))
    model = build_classifier(cfg, device="cpu", train=True)
    model.load_state_dict(from_jax(jax.device_get(params)), strict=True)
    loss = cross_entropy(model(x, train=True, generator=torch.Generator().manual_seed(0)),
                         torch.from_numpy(y))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jax_loss), atol=1e-4)
    grads = {n: p.grad for n, p in model.named_parameters() if p.grad is not None}
    assert set(want) - set(grads) == {"encoder.masked_spec_embed"}     # SpecAugment off
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), atol=1e-4, rtol=1e-3,
                                   err_msg=name)
    assert max(float(g.abs().max()) for g in grads.values()) > 1e-2      # not all zero


def test_eval_and_no_grad_run_without_recompute():
    x = _waves(1200, seed=2)
    base = ClassifierConfig(head_hidden=(16,), fs=4000, random_init=True,
                            encoder=Wav2Vec2Config.tiny())
    plain = build_classifier(base, seed=4, device="cpu")
    remat = build_classifier(replace(base, encoder=replace(base.encoder, remat=True,
                                                           remat_conv=True)),
                             seed=4, device="cpu")
    calls = []
    remat.encoder.encoder.layers[0].register_forward_pre_hook(lambda m, a: calls.append(1))
    with torch.no_grad():
        torch.testing.assert_close(remat(x), plain(x), rtol=0, atol=0)
        g1, g2 = torch.Generator().manual_seed(5), torch.Generator().manual_seed(5)
        torch.testing.assert_close(remat(x, train=True, generator=g1),
                                   plain(x, train=True, generator=g2), rtol=0, atol=0)
    assert len(calls) == 2
