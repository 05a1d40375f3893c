"""The stable-layer-norm wav2vec2 family (XLS-R, XLSR-53, the ``-lv60`` checkpoints) in the port.

On a tiny configuration of the family (a LayerNorm over channels on every conv layer, conv
biases, pre-norm encoder layers and the encoder's LayerNorm after the last one), float32, on
the CPU, where every op of the port takes its plain version:

* HF's ``Wav2Vec2Model`` at random init, written to disk as a checkpoint in three layouts
  (``Wav2Vec2Model`` safetensors, ``Wav2Vec2ForCTC`` ``.bin``, ``Wav2Vec2ForPreTraining``
  safetensors), loads strictly through :mod:`...models.hf_port`, and the port's eval output
  is HF's ``last_hidden_state``;
* a training step of the port's classifier (dropout, SpecAugment, its sites and Philox masks)
  against the benchmark's plain reference, ``benchmark/harness/reference.py::PlainModel``
  (held to HF by ``benchmark/tests/test_benchmark_architectures.py``): the loss and every
  leaf's gradient, at zero rates and at nonzero ones;
* the plain versions of the kernels' new forms against direct compositions of PyTorch ops:
  K2's and K4's pre-norm forms, K3b at head dim 80 and the positional conv at 80 channels a
  group;
* the card's routing of a pre-norm training step (each module's ``on_card`` patched to say
  yes, the kernel wrappers replaced by spies running the plain versions): every LayerNorm,
  dropout and residual add of the encoder reaches a kernel wrapper, each the stated number
  of times, and none of the post-norm wrappers.

XLS-R 1B's published keys build a 48 x 1280 stable-layer-norm encoder with conv biases and a
LayerNorm on every conv layer; the default configuration builds the parameters it always had.
"""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from benchmark.harness import reference
from benchmark.harness.configs import ModelConfig
from benchmark.harness.program import build_model, port_config
from benchmark.harness.reference import PlainModel, StepMasks
from benchmark.harness.weights import make_weights
from wav2vec_heart_sounds_tpu_torch.models import hf_port
from wav2vec_heart_sounds_tpu_torch.models.wav2vec2 import (ChannelLayerNorm, Wav2Vec2Config,
                                                            Wav2Vec2Model)
from wav2vec_heart_sounds_tpu_torch.ops import philox
from wav2vec_heart_sounds_tpu_torch.ops.kernels import attention, dropout, ffn, pos_conv, resid
from wav2vec_heart_sounds_tpu_torch.ops.kernels import megakernel as mk

SAMPLES = 1600
RATES = {"hidden_dropout": 0.1, "activation_dropout": 0.2, "feat_proj_dropout": 0.15,
         "attention_dropout": 0.1}
# XLS-R 1B's published config.json keys that the port reads (huggingface.co/facebook/
# wav2vec2-xls-r-1b).
XLSR_1B = {"hidden_size": 1280, "num_hidden_layers": 48, "num_attention_heads": 16,
           "intermediate_size": 5120, "conv_dim": [512] * 7,
           "conv_kernel": [10, 3, 3, 3, 3, 2, 2], "conv_stride": [5, 2, 2, 2, 2, 2, 2],
           "conv_bias": True, "feat_extract_norm": "layer", "do_stable_layer_norm": True,
           "num_conv_pos_embeddings": 128, "num_conv_pos_embedding_groups": 16,
           "layer_norm_eps": 1e-5, "hidden_act": "gelu", "feat_extract_activation": "gelu",
           "hidden_dropout": 0.1, "attention_dropout": 0.1, "feat_proj_dropout": 0.1,
           "activation_dropout": 0.0, "mask_time_prob": 0.075, "mask_time_length": 10}


def tiny_spec(rates: dict | None = None) -> dict:
    """A tiny configuration file of the family. ``layer_norm_eps`` is not torch's default,
    so a conv-layer norm that took it would show."""
    rates = rates or dict.fromkeys(RATES, 0.0)
    return {"conv_dim": [32, 32, 32], "conv_kernel": [10, 3, 3], "conv_stride": [5, 2, 2],
            "conv_bias": True, "feat_extract_norm": "layer", "do_stable_layer_norm": True,
            "feat_extract_activation": "gelu", "hidden_act": "gelu", "hidden_size": 32,
            "num_hidden_layers": 2, "num_attention_heads": 2, "intermediate_size": 64,
            "num_conv_pos_embeddings": 16, "num_conv_pos_embedding_groups": 2,
            "layer_norm_eps": 1e-3, **rates, "mask_time_prob": 0.05, "mask_time_length": 4,
            "classifier": {"hidden": [16], "num_classes": 2},
            "precision": {"compute": "float32", "ffn_route": "K4", "attention_route": "K3b",
                          "conv_fuse": False}}


@pytest.fixture(scope="module")
def transformers():
    os.environ.setdefault("USE_TF", "0")
    os.environ.setdefault("USE_FLAX", "0")
    return pytest.importorskip("transformers")


def _hf_config(transformers, spec: dict):
    keys = [k for k in spec if k not in ("classifier", "precision")]
    return transformers.Wav2Vec2Config(**{k: spec[k] for k in keys}, layerdrop=0.0,
                                       attn_implementation="eager")


# ---- the configuration --------------------------------------------------------------------

def test_xlsr_1b_keys_build_the_stable_layer_norm_encoder():
    cfg = hf_port.config_from_hf(XLSR_1B)
    assert (cfg.feat_extract_norm, cfg.conv_bias, cfg.do_stable_layer_norm) == \
        ("layer", True, True)
    assert (cfg.num_layers, cfg.hidden_size, cfg.num_heads, cfg.intermediate_size,
            cfg.pos_conv_groups) == (48, 1280, 16, 5120, 16)
    with torch.device("meta"):
        model = Wav2Vec2Model(cfg)
    names = dict(model.named_parameters())
    for i in range(7):
        p = f"feature_extractor.conv_layers.{i}"
        assert names[f"{p}.conv.bias"].shape == (512,)
        assert names[f"{p}.layer_norm.weight"].shape == (512,)
        norm = model.feature_extractor.conv_layers[i].layer_norm
        assert isinstance(norm, ChannelLayerNorm) and norm.eps == 1e-5
    assert len(model.encoder.layers) == 48 and model.encoder.stable
    assert sum(p.numel() for p in names.values()) > 960e6


def test_default_configuration_builds_the_parameters_it_always_had():
    """wav2vec2-base: no conv bias, GroupNorm on conv 0 only, post-norm; the keys in order."""
    cfg = Wav2Vec2Config()
    assert (cfg.feat_extract_norm, cfg.conv_bias, cfg.do_stable_layer_norm) == \
        ("group", False, False)
    with torch.device("meta"):
        names = [n for n, _ in Wav2Vec2Model(cfg).named_parameters()]
    fe = [n for n in names if n.startswith("feature_extractor.")]
    assert fe == [f"feature_extractor.conv_layers.{i}.conv.weight" for i in range(1)] + [
        "feature_extractor.conv_layers.0.layer_norm.weight",
        "feature_extractor.conv_layers.0.layer_norm.bias"] + [
        f"feature_extractor.conv_layers.{i}.conv.weight" for i in range(1, 7)]
    assert names[-1] == "encoder.layers.11.final_layer_norm.bias"
    hf_default = hf_port.config_from_hf({})
    assert all(getattr(hf_default, f) == getattr(cfg, f) for f in hf_port.ARCHITECTURE)


@pytest.mark.parametrize("field,value", [("feat_extract_norm", "batch"),
                                         ("hidden_act", "relu")])
def test_a_config_the_model_does_not_compute_still_raises(field, value):
    with pytest.raises(ValueError, match=field):
        hf_port.config_from_hf({**XLSR_1B, field: value})


def test_the_decomposed_ffn_route_is_refused_for_the_stable_encoder():
    """Pre-norm layers train their FFN through K4's pre-norm form alone, so the decomposed
    route (``ffn_mega=False``) would be a setting that does nothing: it raises, naming it."""
    cfg = Wav2Vec2Config.tiny(do_stable_layer_norm=True, ffn_mega=False)
    with pytest.raises(ValueError, match="ffn_mega"):
        Wav2Vec2Model(cfg)
    Wav2Vec2Model(Wav2Vec2Config.tiny(ffn_mega=False))


# ---- HF's checkpoints ---------------------------------------------------------------------

FORMS = ("model_safetensors", "ctc_bin", "pretraining_safetensors")


@pytest.mark.parametrize("form", FORMS)
def test_family_checkpoint_loads_strictly_and_computes_hfs_output(transformers, tmp_path, form):
    spec = tiny_spec()
    config = _hf_config(transformers, spec)
    torch.manual_seed(3)
    classes = {"model_safetensors": transformers.Wav2Vec2Model,
               "ctc_bin": transformers.Wav2Vec2ForCTC,
               "pretraining_safetensors": transformers.Wav2Vec2ForPreTraining}
    if form == "ctc_bin":
        config.vocab_size = 8
    hf = classes[form](config).eval()
    hf.save_pretrained(tmp_path, safe_serialization=form.endswith("safetensors"))
    assert (tmp_path / ("model.safetensors" if form.endswith("safetensors")
                        else "pytorch_model.bin")).is_file()
    cfg, sd = hf_port.load_pretrained_encoder(str(tmp_path))
    assert (cfg.feat_extract_norm, cfg.conv_bias, cfg.do_stable_layer_norm) == \
        ("layer", True, True)
    model = Wav2Vec2Model(cfg).eval()
    model.load_state_dict(sd, strict=True)
    encoder = hf if form == "model_safetensors" else hf.wav2vec2
    x = torch.from_numpy(np.random.default_rng(0).uniform(-1, 1, (2, SAMPLES))
                         .astype(np.float32))
    with torch.no_grad():
        theirs = encoder(x).last_hidden_state
        ours = model(x)
    # Both sides float32 on the same leaves; the orders of a few operations differ (HF scales
    # the queries before their product with the keys, the port the scores after it; the
    # port's LayerNorms take E[x^2] - E[x]^2): rounding of outputs of order 1, about 1e-6.
    # 2e-5 is tests/test_torch_wav2vec2.py's bar for the post-norm encoder.
    torch.testing.assert_close(ours, theirs, rtol=0, atol=2e-5)


# ---- a training step against the plain reference ------------------------------------------

def _step(spec: dict, seed: int):
    """One training forward and backward of the port's classifier and of ``PlainModel`` on
    the same leaves, waveforms and step draws: (loss, gradient by leaf) of each."""
    cfg = ModelConfig.from_file(spec)
    w = make_weights(cfg, 4_000_000_000 + seed, "cpu")
    gen = torch.Generator().manual_seed(seed)
    x = torch.rand(4, SAMPLES, generator=gen) * 2 - 1
    y = torch.randint(0, 2, (4,), generator=gen)
    model = build_model(port_config(cfg, spec, 16000), w, torch.float32, "cpu", train=True)
    loss = F.cross_entropy(model(x, train=True, generator=torch.Generator().manual_seed(seed)), y)
    loss.backward()
    ours = {n: p.grad for n, p in model.named_parameters()}
    (step_seed, starts), = reference.step_draws(seed, 1, 4, cfg.frames(SAMPLES),
                                                cfg.mask_time_prob, cfg.mask_time_length)
    assert starts.numel() > 0
    masks = StepMasks(step_seed, reference.time_mask(starts, cfg.frames(SAMPLES),
                                                     cfg.mask_time_length), 0)
    params = {n: v.clone().requires_grad_(True) for n, v in w.items()}
    ref_loss = F.cross_entropy(PlainModel(cfg, params).forward(x, masks), y)
    theirs = dict(zip(params, torch.autograd.grad(ref_loss, list(params.values()))))
    return float(loss.detach()), ours, float(ref_loss.detach()), theirs


@pytest.mark.parametrize("rates", [None, RATES], ids=["zero_rates", "nonzero_rates"])
def test_training_step_is_the_plain_reference(rates):
    """The loss within 1e-6 of the reference's, and every leaf's gradient within 1e-5 of its
    largest entry. Both sides are float32 on the same leaves, masks and spans; they differ
    in the order of operations (the port's LayerNorms take E[x^2] - E[x]^2 and it scales the
    attention scores after their product): gaps of 5.3e-7 of a leaf's largest gradient at
    most, measured, and the losses equal. The keys' biases, whose true gradient is 0 (softmax
    does not see them), read rounding noise of 1e-8 of the median leaf: each leaf's scale is
    at least a hundredth of the median leaf's. A wrong mask, site, norm or stream moves the
    gradients by 1e-2 and more."""
    loss, ours, ref_loss, theirs = _step(tiny_spec(rates), 11)
    assert abs(loss - ref_loss) <= 1e-6 * abs(ref_loss)
    assert ours.keys() == theirs.keys()
    scales = {n: float(v.abs().max()) for n, v in theirs.items()}
    floor = 1e-2 * float(np.median(list(scales.values())))
    for name, g in ours.items():
        torch.testing.assert_close(g, theirs[name], rtol=0, atol=1e-5 * max(scales[name], floor),
                                   msg=name)


def test_nonzero_rates_change_the_step():
    """The masks are live: the nonzero-rate step's loss is not the zero-rate step's."""
    assert abs(_step(tiny_spec(RATES), 11)[0] - _step(tiny_spec(), 11)[0]) > 1e-3


# ---- the plain versions of the kernels' new forms -----------------------------------------

def _randn(*shape, seed=0, scale=1.0):
    return torch.from_numpy((scale * np.random.default_rng(seed).normal(size=shape))
                            .astype(np.float32))


def _leaves(*tensors):
    return [t.detach().clone().requires_grad_(True) for t in tensors]


def _drop(h, seed, site, rate):
    keep = philox.keep_mask(seed, site, h.shape, rate)
    return torch.where(keep, h * philox.keep_scale(rate), 0.0)


def _close(got, want, rel=2e-6):
    for a, e in zip(got, want):
        assert a.shape == e.shape
        torch.testing.assert_close(a, e, rtol=0, atol=rel * max(float(e.abs().max()), 1.0))


def test_prenorm_tail_plain_version_is_its_composition():
    """K2's pre-norm form: ``s = x + drop(h)`` and ``LN(s)``, and the gradients of h, x and
    the LayerNorm's parameters from both outputs' cotangents (float32: the same operations
    but the statistics' form, within 2e-6)."""
    rows, d, rate, eps = 37, 1280, 0.1, 1e-5
    h, x, w, b = _leaves(_randn(rows, d), _randn(rows, d, seed=1),
                         1 + 0.1 * _randn(d, seed=2), 0.1 * _randn(d, seed=3))
    gs, gy = _randn(rows, d, seed=4), _randn(rows, d, seed=5)
    s, y = resid.dropout_add_layernorm_prenorm(h, x, w, b, 7, 3, rate, eps)
    got = [s, y, *torch.autograd.grad((s, y), (h, x, w, b), (gs, gy))]
    h2, x2, w2, b2 = _leaves(h, x, w, b)
    s2 = x2 + _drop(h2, 7, 3, rate)
    y2 = F.layer_norm(s2, (d,), w2, b2, eps)
    want = [s2, y2, *torch.autograd.grad((s2, y2), (h2, x2, w2, b2), (gs, gy))]
    _close([t.detach() for t in got], [t.detach() for t in want])


def test_ffn_prenorm_plain_version_is_its_composition():
    """K4's pre-norm form at XLS-R 1B's FFN ratio: ``s = r + drop(W2 drop(gelu(W1 x + b1))
    + b2)`` and the next ``LN(s)``, and every input's gradient from both cotangents."""
    rows, d, f, eps = 21, 64, 256, 1e-5
    x, r, w1, b1, w2, b2, g, bt = _leaves(
        _randn(rows, d), _randn(rows, d, seed=1), _randn(f, d, seed=2, scale=d ** -0.5),
        0.1 * _randn(f, seed=3), _randn(d, f, seed=4, scale=f ** -0.5), 0.1 * _randn(d, seed=5),
        1 + 0.1 * _randn(d, seed=6), 0.1 * _randn(d, seed=7))
    gs, gy = _randn(rows, d, seed=8), _randn(rows, d, seed=9)
    inputs = (x, r, w1, b1, w2, b2, g, bt)
    s, y = mk.ffn_block_prenorm(x, r, w1, b1, w2, b2, g, bt, 9, 4, 5, 0.2, 0.1, eps)
    got = [s, y, *torch.autograd.grad((s, y), inputs, (gs, gy))]
    x2, r2, w12, b12, w22, b22, g2, bt2 = ref_inputs = _leaves(*inputs)
    hid = _drop(F.gelu(F.linear(x2, w12, b12)), 9, 4, 0.2)
    s2 = r2 + _drop(F.linear(hid, w22, b22), 9, 5, 0.1)
    y2 = F.layer_norm(s2, (d,), g2, bt2, eps)
    want = [s2, y2, *torch.autograd.grad((s2, y2), ref_inputs, (gs, gy))]
    _close([t.detach() for t in got], [t.detach() for t in want], 1e-5)


def test_attention_plain_version_at_head_dim_80_is_its_composition():
    """K3b at XLS-R 1B's head dim 80 (a packed ``[B, 3H, T, d]`` view, 7 of 9 frames valid,
    rate 0.1): output and the packed gradient against softmax attention composed directly."""
    B, H, T, d, t = 2, 3, 9, 80, 7
    assert attention.kernel_takes(d, torch.bfloat16) and attention.kernel_takes(d, torch.float32)
    qkv, = _leaves(_randn(B, 3 * H, T, d))
    dout = _randn(B, H, T, d, seed=1)
    out = attention.attention_qkv_train(qkv, t, 0.1, 5, 6)
    got = [out, *torch.autograd.grad(out, qkv, dout)]
    qkv2, = _leaves(qkv)
    q, k, v = qkv2[:, :H], qkv2[:, H:2 * H], qkv2[:, 2 * H:]
    scores = (q @ k.transpose(2, 3)) / d ** 0.5
    scores = scores.masked_fill(torch.arange(T) >= t, float("-inf"))
    probs = _drop(torch.softmax(scores, dim=-1), 5, 6, 0.1)
    out2 = probs @ v
    want = [out2, *torch.autograd.grad(out2, qkv2, dout)]
    _close([a.detach() for a in got], [a.detach() for a in want], 1e-5)


def test_positional_conv_plain_version_at_80_a_group_is_its_composition():
    """The positional conv at 80 channels a group (XLS-R 1B's 1280 in 16 groups, here 2 of
    them): ``gelu(conv(x))`` group by group with the trailing frame dropped, and its
    gradients."""
    groups, c, k, t = 2, 80, 16, 11
    assert pos_conv.kernel_takes(16 * c, 16) and pos_conv.kernel_takes(16 * 32, 16)
    x, w, b = _leaves(_randn(2, t, groups * c), _randn(groups * c, c, k, seed=1,
                                                       scale=(c * k) ** -0.5),
                      0.1 * _randn(groups * c, seed=2))
    g = _randn(2, t, groups * c, seed=3)
    out = pos_conv.pos_conv_gelu(x, w, b, groups)
    got = [out, *torch.autograd.grad(out, (x, w, b), g)]
    x2, w2, b2 = _leaves(x, w, b)
    parts = [F.conv1d(x2[:, :, i * c:(i + 1) * c].transpose(1, 2), w2[i * c:(i + 1) * c],
                      b2[i * c:(i + 1) * c], padding=k // 2)[:, :, :t] for i in range(groups)]
    out2 = F.gelu(torch.cat(parts, dim=1)).transpose(1, 2)
    want = [out2, *torch.autograd.grad(out2, (x2, w2, b2), g)]
    _close([a.detach() for a in got], [a.detach() for a in want], 1e-5)


# ---- the card's routing of a pre-norm training step ---------------------------------------

# Wrapper -> (module, plain version run by its spy).
SPIED = {
    "dropout_kernel": (dropout, dropout.dropout_reference),
    "resid_fwd_kernel": (resid, resid.resid_fwd_reference),
    "resid_bwd_kernel": (resid, resid.resid_bwd_reference),
    "resid_prenorm_fwd_kernel": (resid, resid.resid_fwd_reference),
    "resid_prenorm_bwd_kernel": (
        resid, lambda g, gs, s, w, *a: resid.resid_bwd_reference(g, s, w, *a, g_stream=gs)),
    "ffn_mega_fwd_kernel": (mk, mk.ffn_mega_fwd_reference),
    "ffn_mega_bwd_kernel": (mk, mk.ffn_mega_bwd_reference),
    "ffn_prenorm_fwd_kernel": (
        mk, lambda x, r, *a: mk.ffn_mega_fwd_reference(x, *a, r=r)),
    "ffn_prenorm_bwd_kernel": (
        mk, lambda g, gs, *a: mk.ffn_mega_bwd_reference(g, *a, g_stream=gs)),
    "attention_qkv_fwd": (attention, attention.attention_qkv_reference),
    "attention_qkv_bwd": (attention, attention.attention_qkv_bwd_reference),
}
# A training step of the tiny family model (2 layers), forward + backward: K1 at the feature
# projection; K2's pre-norm form on the encoder's input (LN1 of layer 0) and at each layer's
# attention tail (LN2); K4's pre-norm form at each FFN (the next LN1, the encoder's LN after
# the last); K3b in each layer.
STABLE_STEP = {"dropout_kernel": (1, 1), "resid_prenorm_fwd_kernel": (3, 0),
               "resid_prenorm_bwd_kernel": (0, 3), "ffn_prenorm_fwd_kernel": (2, 0),
               "ffn_prenorm_bwd_kernel": (0, 2), "attention_qkv_fwd": (2, 0),
               "attention_qkv_bwd": (0, 2)}


def test_the_card_route_of_a_prenorm_step_reaches_the_kernels(monkeypatch):
    """With every module on the card's branch, the step reaches the kernel wrappers at the
    counts of ``STABLE_STEP`` and no post-norm wrapper, and its gradients are the plain
    route's bit for bit (the spies run the plain versions)."""
    spec = tiny_spec(RATES)
    _, plain, _, _ = _step(spec, 13)
    for module in (dropout, resid, ffn, mk, attention):
        monkeypatch.setattr(module, "on_card", lambda t: True)
    calls = dict.fromkeys(SPIED, 0)

    def spy(name, fn):
        def run(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return run

    for name, (module, fn) in SPIED.items():
        monkeypatch.setattr(module, name, spy(name, fn))
    cfg = ModelConfig.from_file(spec)
    w = make_weights(cfg, 4_000_000_013, "cpu")
    gen = torch.Generator().manual_seed(13)
    x = torch.rand(4, SAMPLES, generator=gen) * 2 - 1
    y = torch.randint(0, 2, (4,), generator=gen)
    model = build_model(port_config(cfg, spec, 16000), w, torch.float32, "cpu", train=True)
    loss = F.cross_entropy(model(x, train=True, generator=torch.Generator().manual_seed(13)), y)
    forward = dict(calls)
    loss.backward()
    backward = {n: calls[n] - forward[n] for n in calls}
    for name in SPIED:
        assert (forward[name], backward[name]) == STABLE_STEP.get(name, (0, 0)), name
    for name, p in model.named_parameters():
        assert torch.equal(p.grad, plain[name]), name
