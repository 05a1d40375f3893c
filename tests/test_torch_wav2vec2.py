"""PyTorch wav2vec2 / classifier port vs the JAX package on the same weights.

Float32 on CPU at atol 2e-5: the conv and matmul summation orders differ between XLA and
PyTorch, nothing else. The full-size case holds the port to the recorded HF torch
outputs at the JAX package's own bar (``tests/test_hf_full_parity.py``).
"""

import sys
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from wav2vec_heart_sounds_tpu.models import ClassifierConfig as JaxClassifierConfig
from wav2vec_heart_sounds_tpu.models import Wav2Vec2Config as JaxConfig
from wav2vec_heart_sounds_tpu.models import Wav2Vec2Model as JaxModel
from wav2vec_heart_sounds_tpu.models import Wav2VecClassifier as JaxClassifier
from wav2vec_heart_sounds_tpu.models import hf_port as jax_hf_port
from wav2vec_heart_sounds_tpu_torch.models import from_jax, hf_port
from wav2vec_heart_sounds_tpu_torch.models.build import build_classifier
from wav2vec_heart_sounds_tpu_torch.models.classifier import ClassifierConfig, Wav2VecClassifier
from wav2vec_heart_sounds_tpu_torch.models.wav2vec2 import (
    Wav2Vec2Config, Wav2Vec2Model, cascade_gelu)

sys.path.insert(0, str(Path(__file__).resolve().parent / "golden"))
import fullsize_sd  # noqa: E402

GOLDEN = Path(__file__).parent / "golden" / "wav2vec2_fullsize_parity.npz"
ATOL = 2e-5


def _wave(b, n, seed=0):
    return np.random.default_rng(seed).normal(0.0, 0.5, (b, n)).astype(np.float32)


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.mark.parametrize("length", [1000, 1337])
def test_tiny_encoder_matches_jax(length):
    x = _wave(3, length)
    jm = JaxModel(JaxConfig.tiny())
    params = jm.init(jax.random.key(0), jnp.asarray(x))["params"]
    ref = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    model = Wav2Vec2Model(Wav2Vec2Config.tiny()).eval()
    model.load_state_dict(from_jax.from_jax(params), strict=True)
    with torch.inference_mode():
        out = model(torch.from_numpy(x)).numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=ATOL)


def test_tiny_classifier_matches_jax():
    x = _wave(4, 1200, seed=1)
    jcfg = JaxClassifierConfig(num_classes=2, head_hidden=(16, 8), encoder=JaxConfig.tiny(),
                               random_init=True)
    jc = JaxClassifier(jcfg)
    params = jc.init(jax.random.key(1), jnp.asarray(x))["params"]
    ref_logits = np.asarray(jc.apply({"params": params}, jnp.asarray(x)))
    ref_feats = np.asarray(jc.apply({"params": params}, jnp.asarray(x),
                                    method=JaxClassifier.encode))
    cfg = ClassifierConfig(num_classes=2, head_hidden=(16, 8), encoder=Wav2Vec2Config.tiny())
    model = build_classifier(cfg, seed=0, device="cpu")
    model.load_state_dict(from_jax.from_jax(params), strict=True)
    with torch.inference_mode():
        logits = model(torch.from_numpy(x)).numpy()
        feats = model.encode(torch.from_numpy(x)).numpy()
        feats3 = model.encode(torch.from_numpy(x)[:, :, None]).numpy()   # [B, T, 1] input
    np.testing.assert_allclose(feats, ref_feats, atol=ATOL)
    np.testing.assert_allclose(logits, ref_logits, atol=ATOL)
    np.testing.assert_array_equal(feats3, feats)
    assert logits.dtype == np.float32


@pytest.mark.parametrize("kind", ["encoder", "classifier"])
def test_from_jax_round_trips_every_leaf(kind):
    x = jnp.zeros((1, 800))
    if kind == "encoder":
        params = JaxModel(JaxConfig.tiny()).init(jax.random.key(2), x)["params"]
        port = Wav2Vec2Model(Wav2Vec2Config.tiny())
    else:
        jcfg = JaxClassifierConfig(head_hidden=(8,), encoder=JaxConfig.tiny(), random_init=True)
        params = JaxClassifier(jcfg).init(jax.random.key(2), x)["params"]
        port = Wav2VecClassifier(ClassifierConfig(head_hidden=(8,),
                                                  encoder=Wav2Vec2Config.tiny()))
    sd = from_jax.from_jax(params)
    assert set(sd) == set(port.state_dict())
    for key, value in port.state_dict().items():
        assert tuple(sd[key].shape) == tuple(value.shape), key
    original, back = _leaves(params), _leaves(from_jax.to_jax(sd, params))
    assert len(sd) == len(original) and set(back) == set(original)
    for path, value in original.items():
        np.testing.assert_array_equal(back[path], value, err_msg=path)


def test_from_jax_refuses_lora_leaves():
    """LoRA leaves now have a place (``lora_a``/``lora_b`` on q/v, flax layout); a leaf
    with none is still refused, so no weight is silently dropped."""
    params = JaxModel(JaxConfig.tiny(lora_rank=4)).init(jax.random.key(0),
                                                          jnp.zeros((1, 800)))["params"]
    sd = from_jax.from_jax(params)
    port = Wav2Vec2Model(Wav2Vec2Config.tiny(lora_rank=4))
    assert set(sd) == set(port.state_dict())
    assert tuple(sd["encoder.layers.0.attention.v_proj.lora_a"].shape) == (32, 4)
    attention = params["layers_0"]["attention"]
    stray = {**params, "layers_0": {**params["layers_0"], "attention": {
        **attention, "q_proj": {**attention["q_proj"], "lora_c": np.zeros(4)}}}}
    with pytest.raises(NotImplementedError, match="lora_c"):
        from_jax.from_jax(stray)


def test_multichannel_classifier_not_ported():
    """Ported with the vest slice: a multichannel config gets the beamformer
    (``channel_mixer``) and collapses ``[B, T, C]`` to the encoder's mono input."""
    model = Wav2VecClassifier(ClassifierConfig(num_channels=3, head_hidden=(8,),
                                               encoder=Wav2Vec2Config.tiny()))
    assert hasattr(model, "channel_mixer")
    assert model.channel_mixer.delay_predictor.output_proj.out_features == 3
    with torch.inference_mode():
        logits = build_classifier(ClassifierConfig(num_channels=3, head_hidden=(8,),
                                                   encoder=Wav2Vec2Config.tiny()),
                                  device="cpu")(torch.from_numpy(_wave(2, 900))[:, :, None]
                                                .expand(2, 900, 3).contiguous())
    assert logits.shape == (2, 2) and bool(torch.isfinite(logits).all())


def test_gelu_follows_dtype():
    x = torch.linspace(-4, 4, 101)
    torch.testing.assert_close(cascade_gelu(x), torch.nn.functional.gelu(x))
    xb = x.to(torch.bfloat16)
    torch.testing.assert_close(cascade_gelu(xb),
                               torch.nn.functional.gelu(xb, approximate="tanh"))


def test_build_classifier_is_seeded_and_typed():
    cfg = ClassifierConfig(head_hidden=(8,), encoder=Wav2Vec2Config.tiny())
    a = build_classifier(cfg, seed=3, device="cpu", dtype=torch.bfloat16)
    b = build_classifier(cfg, seed=3, device="cpu", dtype=torch.bfloat16)
    for (name, pa), pb in zip(a.state_dict().items(), b.state_dict().values()):
        torch.testing.assert_close(pa, pb, rtol=0, atol=0)
        norm_or_f32 = "norm" in name or name.startswith("head.logits") or "masked_spec" in name
        assert pa.dtype == (torch.float32 if norm_or_f32 else torch.bfloat16), name
    with torch.inference_mode():
        logits = a(torch.from_numpy(_wave(2, 900)))
    assert logits.dtype == torch.float32 and bool(torch.isfinite(logits).all())


@pytest.fixture(scope="module")
def hf_sd():
    return fullsize_sd.make_state_dict()


@pytest.fixture(scope="module")
def fullsize_model(hf_sd):
    return hf_port.load_hf_state_dict(Wav2Vec2Model(), hf_sd).eval()


def test_hf_port_loads_fullsize_key_set(hf_sd, fullsize_model):
    pos = "encoder.pos_conv_embed.conv."
    expected = (set(hf_sd) - {pos + "parametrizations.weight.original0",
                              pos + "parametrizations.weight.original1"}) | {pos + "weight"}
    assert set(fullsize_model.state_dict()) == expected
    jax_kernel, _ = jax_hf_port._materialise_pos_conv(hf_sd)
    np.testing.assert_allclose(
        fullsize_model.state_dict()[pos + "weight"].numpy().transpose(2, 1, 0), jax_kernel,
        rtol=1e-6)
    legacy = {k.replace("parametrizations.weight.original0", "weight_g")
               .replace("parametrizations.weight.original1", "weight_v"): v
              for k, v in hf_sd.items()}
    torch.testing.assert_close(hf_port.convert_state_dict(legacy)[pos + "weight"],
                               fullsize_model.state_dict()[pos + "weight"])


@pytest.mark.parametrize("case", [0, 1])
def test_fullsize_matches_recorded_hf_torch(fullsize_model, case):
    x = fullsize_sd.make_inputs()[case]
    with torch.inference_mode():
        out = fullsize_model(torch.from_numpy(x)).numpy()
    ref = np.load(GOLDEN)[f"out:{case}"]
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=2e-4, rtol=1e-3)
