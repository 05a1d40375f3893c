"""The port's pretrained-encoder path against the JAX package's on checkpoints on disk.

A tiny wav2vec2 that is not wav2vec2-base (hidden 32, 3 layers, 2 heads, FFN 64, conv
(32, 32) / (10, 3) / (5, 2), positional conv 16 / 2) is written by ``transformers`` in each
layout the port reads: ``model.safetensors``, sharded safetensors, ``pytorch_model.bin``
with the legacy ``weight_g``/``weight_v`` keys, sharded ``pytorch_model.bin``, a
``Wav2Vec2ForCTC`` (``wav2vec2.`` prefix and ``lm_head``, legacy keys, the layout of the
real ``-960h`` checkpoints) and a hub-cache snapshot found by name under ``HF_HUB_CACHE``.
The port reads them without ``transformers``. For each: its config equals the JAX package's
``config_from_hf`` field by field; its state dict equals the in-memory conversion of the HF
model's and the JAX loader's params carried through ``from_jax``, bit for bit; and
``build_classifier`` of each package, asked for the default wav2vec2-base encoder, builds
the checkpoint's tiny one (the JAX ``build_classifier`` adopts its architecture) whose
encoder weights are the checkpoint's, with logits that agree at ``tests/
test_torch_wav2vec2.py``'s atol 2e-5 on the same variables. A name that is nowhere gives
``None`` (and ``build_classifier`` one printed line); a truncated or misfit checkpoint raises,
and so does a config the model does not compute, naming the field; the ``-lv60`` fields are
adopted.
"""

import json
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

from wav2vec_heart_sounds_tpu.models import hf_port as jax_hf_port  # noqa: E402
from wav2vec_heart_sounds_tpu.models.build import build_classifier as jax_build  # noqa: E402
from wav2vec_heart_sounds_tpu.models.classifier import (  # noqa: E402
    ClassifierConfig as JaxClassifierConfig)
from wav2vec_heart_sounds_tpu_torch.models import hf_port  # noqa: E402
from wav2vec_heart_sounds_tpu_torch.models.build import build_classifier  # noqa: E402
from wav2vec_heart_sounds_tpu_torch.models.classifier import ClassifierConfig  # noqa: E402
from wav2vec_heart_sounds_tpu_torch.models.from_jax import from_jax  # noqa: E402
from wav2vec_heart_sounds_tpu_torch.models.wav2vec2 import Wav2Vec2Config  # noqa: E402
from torch_vocoder_pairs import one_torch_thread  # noqa: F401,E402  (one intra-op thread)

TINY = dict(hidden_size=32, num_hidden_layers=3, num_attention_heads=2, intermediate_size=64,
            conv_dim=(32, 32), conv_kernel=(10, 3), conv_stride=(5, 2),
            num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=2)
HUB_NAME = "org/tiny-wav2vec2"
FORMS = ("safetensors", "safetensors_sharded", "legacy_bin", "bin_sharded", "ctc_legacy_bin",
         "hub_cache")
ATOL = 2e-5
COMMON_FIELDS = [f for f, _ in hf_port.FIELDS]


def _legacy(sd: dict) -> dict:
    return {k.replace("parametrizations.weight.original0", "weight_g")
             .replace("parametrizations.weight.original1", "weight_v"): v
            for k, v in sd.items()}


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """(HF model, {form: directory}, hub cache root)."""
    from transformers import Wav2Vec2Config as HFConfig
    from transformers import Wav2Vec2ForCTC, Wav2Vec2Model as HFModel

    root = tmp_path_factory.mktemp("checkpoints")
    torch.manual_seed(0)
    hf = HFModel(HFConfig(**TINY)).eval()
    dirs = {form: root / form for form in FORMS}
    hf.save_pretrained(dirs["safetensors"])
    hf.save_pretrained(dirs["safetensors_sharded"], max_shard_size="40KB")
    hf.save_pretrained(dirs["bin_sharded"], max_shard_size="40KB", safe_serialization=False)
    dirs["legacy_bin"].mkdir()
    hf.config.save_pretrained(dirs["legacy_bin"])
    torch.save(_legacy(hf.state_dict()), dirs["legacy_bin"] / "pytorch_model.bin")
    ctc = Wav2Vec2ForCTC(HFConfig(**TINY, vocab_size=12))
    ctc.wav2vec2.load_state_dict(hf.state_dict())
    dirs["ctc_legacy_bin"].mkdir()
    ctc.config.save_pretrained(dirs["ctc_legacy_bin"])
    torch.save(_legacy(ctc.state_dict()), dirs["ctc_legacy_bin"] / "pytorch_model.bin")
    hub = root / "hub"
    repo = hub / ("models--" + HUB_NAME.replace("/", "--"))
    (repo / "refs").mkdir(parents=True)
    (repo / "refs" / "main").write_text("0123abcd")
    shutil.copytree(dirs["safetensors"], repo / "snapshots" / "0123abcd")
    dirs["hub_cache"] = repo / "snapshots" / "0123abcd"
    for form in FORMS[:2]:
        assert not (dirs[form] / "pytorch_model.bin").exists()
    assert (dirs["safetensors_sharded"] / "model.safetensors.index.json").is_file()
    assert (dirs["bin_sharded"] / "pytorch_model.bin.index.json").is_file()
    assert "lm_head.weight" in ctc.state_dict()
    return hf, dirs, hub


@pytest.fixture
def hub_env(checkpoints, monkeypatch):
    monkeypatch.setenv("HF_HUB_CACHE", str(checkpoints[2]))


def _name(form, dirs):
    return HUB_NAME if form == "hub_cache" else str(dirs[form])


@pytest.mark.parametrize("form", FORMS)
def test_loader_matches_jax_loader(checkpoints, hub_env, form):
    hf, dirs, _ = checkpoints
    loaded = hf_port.load_pretrained_encoder(_name(form, dirs))
    assert loaded is not None
    cfg, sd = loaded
    jax_cfg, jax_params = jax_hf_port.load_pretrained_encoder(str(dirs[form]))
    for field in COMMON_FIELDS:
        assert getattr(cfg, field) == getattr(jax_cfg, field), field
    assert jax_hf_port.config_from_hf(hf.config).hidden_size == cfg.hidden_size == 32
    assert (cfg.num_layers, cfg.conv_dim, cfg.pos_conv_groups) == (3, (32, 32), 2)
    want = hf_port.convert_state_dict(hf.state_dict(), 32)
    carried = from_jax(jax_params)
    assert set(sd) == set(want) == set(carried)
    for key, value in want.items():
        assert sd[key].dtype == torch.float32
        torch.testing.assert_close(sd[key], value, rtol=0, atol=0, msg=key)
        torch.testing.assert_close(sd[key], carried[key], rtol=0, atol=0, msg=key)


def test_config_from_hf_takes_dicts_and_defaults(checkpoints):
    hf, dirs, _ = checkpoints
    on_disk = json.loads((dirs["safetensors"] / "config.json").read_text())
    assert "num_attention_heads" in on_disk
    assert hf_port.config_from_hf(on_disk) == hf_port.config_from_hf(hf.config)
    base = hf_port.config_from_hf({})          # every key missing: HF's defaults
    jax_base = jax_hf_port.config_from_hf(transformers.Wav2Vec2Config())
    for field in COMMON_FIELDS:
        assert getattr(base, field) == getattr(jax_base, field), field
    assert base.hidden_size == 768 and base.feat_proj_dropout == 0.0


@pytest.mark.parametrize("form", FORMS)
def test_build_classifier_adopts_the_checkpoint(checkpoints, hub_env, form):
    """Both ``build_classifier``s, asked for the default wav2vec2-base encoder, build the
    checkpoint's."""
    _, dirs, _ = checkpoints
    name = _name(form, dirs)
    cfg = ClassifierConfig(head_hidden=(16,), pretrained_name=name, fs=4000)
    assert cfg.encoder == Wav2Vec2Config() and not cfg.random_init
    model = build_classifier(cfg, seed=1, device="cpu")
    enc = model.encoder.config
    assert (enc.hidden_size, enc.num_layers, enc.num_heads, enc.intermediate_size,
            enc.conv_dim, enc.conv_kernel, enc.conv_stride, enc.pos_conv_kernel,
            enc.pos_conv_groups) == (32, 3, 2, 64, (32, 32), (10, 3), (5, 2), 16, 2)
    assert (enc.hidden_dropout, enc.feat_proj_dropout, enc.mask_time_prob) == (0.1, 0.1, 0.05)
    _, sd = hf_port.load_pretrained_encoder(name)
    state = model.encoder.state_dict()
    for key, value in sd.items():
        torch.testing.assert_close(state[key], value, rtol=0, atol=0, msg=key)

    jcfg = JaxClassifierConfig(head_hidden=(16,), pretrained_name=str(dirs[form]), fs=4000)
    jax_model, variables = jax_build(jcfg, jax.random.key(1), 1200, jnp.float32)
    assert jax_model.config.encoder.num_layers == 3
    carried = from_jax(jax.device_get(variables["params"]))
    for key, value in sd.items():         # the JAX build merged the same checkpoint
        torch.testing.assert_close(carried["encoder." + key], value, rtol=0, atol=0, msg=key)
    model.load_state_dict(carried, strict=True)
    x = np.random.default_rng(4).normal(0.0, 0.5, (3, 1200)).astype(np.float32)
    ref = np.asarray(jax_model.apply(variables, jnp.asarray(x)))
    with torch.inference_mode():
        logits = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(logits, ref, atol=ATOL)


def test_missing_checkpoint_gives_none_and_one_line(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("HF_HUB_CACHE", str(tmp_path / "empty"))
    assert hf_port.load_pretrained_encoder("org/absent") is None
    assert hf_port.load_pretrained_encoder(str(tmp_path / "no-such-dir")) is None
    model = build_classifier(ClassifierConfig(head_hidden=(8,), pretrained_name="org/absent",
                                              encoder=Wav2Vec2Config.tiny()), device="cpu")
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 1 and "no local checkpoint of org/absent" in lines[0]
    assert model.encoder.config == Wav2Vec2Config.tiny()


def _truncate(path, keep):
    data = path.read_bytes()
    path.write_bytes(data[:keep(len(data))])


@pytest.mark.parametrize("fault", ["safetensors_body", "safetensors_header", "bin",
                                   "misfit_config", "no_weights", "no_config", "shard_missing"])
def test_unreadable_or_misfit_checkpoint_raises(checkpoints, tmp_path, fault):
    _, dirs, _ = checkpoints
    source = {"bin": "legacy_bin", "shard_missing": "safetensors_sharded"}.get(fault,
                                                                              "safetensors")
    d = tmp_path / fault
    shutil.copytree(dirs[source], d)
    if fault == "safetensors_body":
        _truncate(d / "model.safetensors", lambda n: n - 100)
    elif fault == "safetensors_header":
        _truncate(d / "model.safetensors", lambda n: 20)
    elif fault == "bin":
        _truncate(d / "pytorch_model.bin", lambda n: n // 2)
    elif fault == "misfit_config":
        config = json.loads((d / "config.json").read_text())
        config["num_hidden_layers"] = 4
        (d / "config.json").write_text(json.dumps(config))
    elif fault == "no_weights":
        (d / "model.safetensors").unlink()
    elif fault == "no_config":
        (d / "config.json").unlink()
    else:
        index = json.loads((d / "model.safetensors.index.json").read_text())
        (d / sorted(set(index["weight_map"].values()))[-1]).unlink()
    with pytest.raises((ValueError, OSError, RuntimeError)):
        hf_port.load_pretrained_encoder(str(d))
    with pytest.raises((ValueError, OSError, RuntimeError)):
        build_classifier(ClassifierConfig(head_hidden=(8,), pretrained_name=str(d)),
                         device="cpu")


# The stable-layer-norm family's three keys, which the port now computes, and two values it
# does not compute.
LV60_CASES = [("feat_extract_norm", "layer"), ("do_stable_layer_norm", True), ("conv_bias", True),
              ("feat_extract_norm", "batch"), ("hidden_act", "relu")]


@pytest.mark.parametrize("field,value", LV60_CASES)
def test_lv60_config_raises_naming_the_field(checkpoints, tmp_path, field, value):
    """An ``-lv60`` key is adopted: the config takes it, and the tiny post-norm checkpoint's
    weights fit it where the key changes no parameter (the pre-norm encoder) and else raise
    naming the leaves they lack (every conv layer's LayerNorm, the conv biases). A value the
    model does not compute raises, naming the field."""
    _, dirs, _ = checkpoints
    d = tmp_path / "lv60"
    shutil.copytree(dirs["safetensors"], d)
    config = json.loads((d / "config.json").read_text())
    config[field] = value
    (d / "config.json").write_text(json.dumps(config))
    if (field, value) in LV60_CASES[:3]:
        assert getattr(hf_port.config_from_hf(config), field) == value
        if field == "do_stable_layer_norm":
            cfg, _ = hf_port.load_pretrained_encoder(str(d))
            assert cfg.do_stable_layer_norm
        else:
            lacks = "conv_layers.1.layer_norm" if field == "feat_extract_norm" else "conv.bias"
            with pytest.raises(ValueError, match=f"does not fit its config: missing .*{lacks}"):
                hf_port.load_pretrained_encoder(str(d))
        return
    with pytest.raises(ValueError, match=field):
        hf_port.load_pretrained_encoder(str(d))
    with pytest.raises(ValueError, match=field):
        hf_port.config_from_hf(config)
