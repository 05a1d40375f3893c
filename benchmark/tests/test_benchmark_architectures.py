"""The harness in HF ``Wav2Vec2Model``'s two architectures, chosen by the configuration
file's keys (``feat_extract_norm``, ``conv_bias``, ``do_stable_layer_norm``): the leaves
against HF's state dict, the plain reference against HF's modules (float32 on the CPU, tiny
widths, the installed ``transformers``), and the published configurations built exactly as
before those keys were read."""

import dataclasses
import json
import os

import pytest
import torch
import torch.nn.functional as F

from benchmark.harness import reference, weights
from benchmark.harness.cells import REPO
from benchmark.harness.configs import ModelConfig
from benchmark.harness.program import port_config
from benchmark.harness.reference import PlainModel, StepMasks
from benchmark.harness.weights import leaf_shapes, make_weights

# (feat_extract_norm, do_stable_layer_norm, conv_bias): wav2vec2-base / -large, XLS-R /
# -lv60, and the layer-norm feature encoder under post-norm layers.
ARCHITECTURES = [("group", False, False), ("layer", True, True), ("layer", False, True)]
IDS = ["group-postnorm", "layer-stable-bias", "layer-postnorm-bias"]
RATES = {"hidden_dropout": 0.1, "activation_dropout": 0.2, "feat_proj_dropout": 0.15,
         "attention_dropout": 0.0}
SAMPLES = 1600
POS = "encoder.pos_conv_embed.conv."


def tiny_spec(norm: str, stable: bool, bias: bool, rates: dict | None = None) -> dict:
    """A tiny configuration file of the architecture. ``layer_norm_eps`` is not torch's
    default, so that a feature-encoder norm taking it would show."""
    rates = rates or dict.fromkeys(RATES, 0.0)
    return {"conv_dim": [32, 32, 32], "conv_kernel": [10, 3, 3], "conv_stride": [5, 2, 2],
            "conv_bias": bias, "feat_extract_norm": norm, "do_stable_layer_norm": stable,
            "feat_extract_activation": "gelu", "hidden_act": "gelu", "hidden_size": 32,
            "num_hidden_layers": 2, "num_attention_heads": 2, "intermediate_size": 64,
            "num_conv_pos_embeddings": 16, "num_conv_pos_embedding_groups": 2,
            "layer_norm_eps": 1e-3, **rates, "mask_time_prob": 0.05, "mask_time_length": 4,
            "classifier": {"hidden": [16], "num_classes": 2},
            "precision": {"compute": "float32", "ffn_route": "K4", "attention_route": "K3b",
                          "conv_fuse": False}}


@pytest.fixture(scope="module")
def transformers():
    """The installed ``transformers``, on its torch side only (neither TensorFlow nor Flax)."""
    os.environ.setdefault("USE_TF", "0")
    os.environ.setdefault("USE_FLAX", "0")
    return pytest.importorskip("transformers")


def hf_model(transformers, spec: dict, w: dict | None = None):
    """HF's ``Wav2Vec2Model`` of ``spec``; with ``w``, the positional conv's weight norm taken
    off (its weight a plain leaf, as the port's and ours are) and ``w``'s encoder leaves
    loaded strictly."""
    keys = [k for k in spec if k not in ("classifier", "precision")]
    model = transformers.Wav2Vec2Model(transformers.Wav2Vec2Config(
        **{k: spec[k] for k in keys}, layerdrop=0.0, attn_implementation="eager"))
    if w is None:
        return model
    conv = model.encoder.pos_conv_embed.conv
    if torch.nn.utils.parametrize.is_parametrized(conv, "weight"):
        torch.nn.utils.parametrize.remove_parametrizations(conv, "weight")
    else:
        torch.nn.utils.remove_weight_norm(conv)
    model.load_state_dict({n.removeprefix("encoder."): v for n, v in w.items()
                           if n.startswith("encoder.")}, strict=True)
    return model


def hf_leaves(model) -> dict[str, tuple[int, ...]]:
    """HF's state dict as our leaf names and shapes: the positional conv's weight-norm pair
    counted as its one ``weight``."""
    out = {}
    for name, v in model.state_dict().items():
        if name.startswith(POS) and name != POS + "bias":
            if name.endswith(("weight_g", "original0")):
                continue
            name = POS + "weight"
        out["encoder." + name] = tuple(v.shape)
    return out


def draws(cfg: ModelConfig, rows: int, seed: int):
    """Waveforms, labels and a step's masks (a dropout seed past 2^31, SpecAugment spans)."""
    gen = torch.Generator().manual_seed(seed)
    x = torch.rand(rows, SAMPLES, generator=gen) * 2 - 1
    y = torch.randint(0, cfg.num_classes, (rows,), generator=gen)
    (step_seed, starts), = reference.step_draws(seed, 1, rows, cfg.frames(SAMPLES),
                                                cfg.mask_time_prob, cfg.mask_time_length)
    spec = reference.time_mask(starts, cfg.frames(SAMPLES), cfg.mask_time_length)
    return x, y, StepMasks(step_seed, spec, 0)


def loss_and_grads(encode, head_of, params: dict, x, y):
    """The encoder's output, the mean cross-entropy of the head on it, and every leaf's
    gradient by name."""
    out = encode(x)
    loss = F.cross_entropy(head_of(out), y)
    names = list(params)
    grads = torch.autograd.grad(loss, [params[n] for n in names])
    return out.detach(), float(loss.detach()), dict(zip(names, grads))


def plain_run(cfg, w, x, y, masks):
    params = {n: v.clone().requires_grad_(True) for n, v in w.items()}
    model = PlainModel(cfg, params)
    return loss_and_grads(lambda v: model.encode(v, masks), model.head, params, x, y)


def hf_run(hf, cfg, w, x, y, spec):
    """HF's encoder in training mode (SpecAugment's frames given) under our head."""
    hf.train()
    params = {"encoder." + n: p for n, p in hf.named_parameters()}
    head = {n: v.clone().requires_grad_(True) for n, v in w.items() if n.startswith("head.")}
    params.update(head)
    return loss_and_grads(lambda v: hf(v, mask_time_indices=spec).last_hidden_state,
                          PlainModel(cfg, head).head, params, x, y)


def assert_leaves_close(ours: dict, theirs: dict, rel: float) -> None:
    """Every leaf's gradient within ``rel`` of the largest entry of HF's gradient of it."""
    assert ours.keys() == theirs.keys()
    for name, g in ours.items():
        scale = float(theirs[name].abs().max())
        assert scale > 0, name
        torch.testing.assert_close(g, theirs[name], rtol=0, atol=rel * scale, msg=name)


@pytest.mark.parametrize("norm, stable, bias", ARCHITECTURES, ids=IDS)
def test_leaves_are_hfs_state_dict(transformers, norm, stable, bias):
    spec = tiny_spec(norm, stable, bias)
    cfg = ModelConfig.from_file(spec)
    ours = {n: s for n, s in leaf_shapes(cfg) if not n.startswith("head.")}
    assert ours == hf_leaves(hf_model(transformers, spec))
    served = {n: v.dtype for n, v in make_weights(ModelConfig.from_file(
        {**spec, "precision": {**spec["precision"], "compute": "bfloat16"}}), 3, "cpu").items()}
    fe = "encoder.feature_extractor.conv_layers"
    if bias:
        assert served[f"{fe}.2.conv.bias"] == torch.bfloat16
    assert served[f"{fe}.0.layer_norm.weight"] == torch.float32
    assert (f"{fe}.2.layer_norm.bias" in served) == (norm == "layer")


# Both sides compute in float32 from the same leaves, with the same operations but for the
# order of a few: HF scales the queries before their product with the keys and we scale the
# scores after it, and its SpecAugment writes in place where ours selects. The gaps are
# rounding, about 1e-6 of outputs of order 1 (LayerNorm's) and of each leaf's gradient, so
# 1e-5 of the largest entry holds them with room and fails any change of semantics (a norm
# moved, a bias left out, an eps of 1e-3 for 1e-5: 1e-4 and more).
ATOL, GRAD_REL = 1e-5, 1e-5


@pytest.mark.parametrize("norm, stable, bias", ARCHITECTURES, ids=IDS)
def test_encoder_output_is_hfs(transformers, norm, stable, bias):
    spec = tiny_spec(norm, stable, bias)
    cfg = ModelConfig.from_file(spec)
    w = make_weights(cfg, 4_000_000_011, "cpu")
    x, _, _ = draws(cfg, 3, 5)
    with torch.no_grad():
        theirs = hf_model(transformers, spec, w).eval()(x).last_hidden_state
        ours = PlainModel(cfg, w).encode(x)
    torch.testing.assert_close(ours, theirs, rtol=0, atol=ATOL)


@pytest.mark.parametrize("norm, stable, bias", ARCHITECTURES, ids=IDS)
def test_loss_and_gradients_are_hfs_at_zero_rates(transformers, norm, stable, bias):
    spec = tiny_spec(norm, stable, bias)
    cfg = ModelConfig.from_file(spec)
    w = make_weights(cfg, 4_000_000_013, "cpu")
    x, y, masks = draws(cfg, 4, 6)
    assert masks.spec.any()
    out, loss, grads = plain_run(cfg, w, x, y, masks)
    hf_out, hf_loss, hf_grads = hf_run(hf_model(transformers, spec, w), cfg, w, x, y,
                                       masks.spec)
    torch.testing.assert_close(out, hf_out, rtol=0, atol=ATOL)
    assert abs(loss - hf_loss) <= ATOL * abs(hf_loss)
    assert_leaves_close(grads, hf_grads, GRAD_REL)


class SiteDropout(torch.nn.Module):
    """An ``nn.Dropout``'s place taken by the reference's Philox mask at ``site``."""

    def __init__(self, plain: PlainModel, masks: StepMasks, site: int, rate: float):
        super().__init__()
        self.plain, self.masks, self.site, self.rate = plain, masks, site, rate

    def forward(self, x):
        return self.plain._drop(x, self.masks, self.site, self.rate)


def mask_sites(hf, cfg: ModelConfig, masks: StepMasks) -> None:
    """Each ``nn.Dropout`` of HF's model replaced at the site the reference states for it."""
    plain = PlainModel(cfg, {})
    enc = hf.encoder
    hf.feature_projection.dropout = SiteDropout(plain, masks, reference.SITE_FEATURE_PROJECTION,
                                                cfg.feat_proj_dropout)
    enc.dropout = SiteDropout(plain, masks, reference.SITE_ENCODER, cfg.hidden_dropout)
    for i, layer in enumerate(enc.layers):
        site = 2 + 4 * i
        layer.dropout = SiteDropout(plain, masks, site + 1, cfg.hidden_dropout)
        ffn = layer.feed_forward
        ffn.intermediate_dropout = SiteDropout(plain, masks, site + 2, cfg.activation_dropout)
        ffn.output_dropout = SiteDropout(plain, masks, site + 3, cfg.hidden_dropout)
    assert not [m for m in hf.modules() if isinstance(m, torch.nn.Dropout)]


@pytest.mark.parametrize("norm, stable, bias", ARCHITECTURES, ids=IDS)
def test_dropout_sites_are_hfs_modules(transformers, norm, stable, bias):
    spec = tiny_spec(norm, stable, bias, RATES)
    cfg = ModelConfig.from_file(spec)
    w = make_weights(cfg, 4_000_000_017, "cpu")
    x, y, masks = draws(cfg, 4, 7)
    hf = hf_model(transformers, spec, w)
    mask_sites(hf, cfg, masks)
    out, loss, grads = plain_run(cfg, w, x, y, masks)
    hf_out, hf_loss, hf_grads = hf_run(hf, cfg, w, x, y, masks.spec)
    still = dataclasses.replace(cfg, **dict.fromkeys(RATES, 0.0))
    with torch.no_grad():
        assert (out - PlainModel(still, w).encode(x, masks)).abs().max() > 100 * ATOL
    torch.testing.assert_close(out, hf_out, rtol=0, atol=ATOL)
    assert abs(loss - hf_loss) <= ATOL * abs(hf_loss)
    assert_leaves_close(grads, hf_grads, GRAD_REL)


# ---- the published configurations, built as the parent built them -----------------------

def parent_leaf_shapes(cfg: ModelConfig) -> list[tuple[str, tuple[int, ...]]]:
    """``weights.leaf_shapes`` as it was before the architecture keys were read."""
    out = []
    cin = (1,) + tuple(cfg.conv_dim[:-1])
    fe = "encoder.feature_extractor.conv_layers"
    for i, (ci, co, k) in enumerate(zip(cin, cfg.conv_dim, cfg.conv_kernel)):
        out.append((f"{fe}.{i}.conv.weight", (co, ci, k)))
        if i == 0:
            out += [(f"{fe}.0.layer_norm.weight", (co,)), (f"{fe}.0.layer_norm.bias", (co,))]
    c, d, f = cfg.conv_dim[-1], cfg.hidden_size, cfg.intermediate_size
    fp = "encoder.feature_projection"
    out += [(f"{fp}.layer_norm.weight", (c,)), (f"{fp}.layer_norm.bias", (c,)),
            (f"{fp}.projection.weight", (d, c)), (f"{fp}.projection.bias", (d,))]
    enc = "encoder.encoder"
    out += [(f"{enc}.pos_conv_embed.conv.weight",
             (d, d // cfg.pos_conv_groups, cfg.pos_conv_kernel)),
            (f"{enc}.pos_conv_embed.conv.bias", (d,)),
            (f"{enc}.layer_norm.weight", (d,)), (f"{enc}.layer_norm.bias", (d,))]
    for layer in range(cfg.num_layers):
        p = f"{enc}.layers.{layer}"
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            out += [(f"{p}.attention.{proj}.weight", (d, d)), (f"{p}.attention.{proj}.bias", (d,))]
        out += [(f"{p}.layer_norm.weight", (d,)), (f"{p}.layer_norm.bias", (d,)),
                (f"{p}.feed_forward.intermediate_dense.weight", (f, d)),
                (f"{p}.feed_forward.intermediate_dense.bias", (f,)),
                (f"{p}.feed_forward.output_dense.weight", (d, f)),
                (f"{p}.feed_forward.output_dense.bias", (d,)),
                (f"{p}.final_layer_norm.weight", (d,)), (f"{p}.final_layer_norm.bias", (d,))]
    out.append(("encoder.masked_spec_embed", (d,)))
    width = d
    for i, hidden in enumerate(cfg.head_hidden):
        out += [(f"head.dense_{i}.weight", (hidden, width)), (f"head.dense_{i}.bias", (hidden,))]
        width = hidden
    out += [("head.logits.weight", (cfg.num_classes, width)),
            ("head.logits.bias", (cfg.num_classes,))]
    return out


def parent_port_config(cfg: ModelConfig, spec: dict, fs: int):
    """``program.port_config`` as it was: the port's encoder config field by field."""
    from wav2vec_heart_sounds_tpu_torch.models.classifier import ClassifierConfig
    from wav2vec_heart_sounds_tpu_torch.models.wav2vec2 import Wav2Vec2Config

    routes = spec["precision"]
    encoder = Wav2Vec2Config(
        conv_dim=cfg.conv_dim, conv_kernel=cfg.conv_kernel, conv_stride=cfg.conv_stride,
        hidden_size=cfg.hidden_size, num_layers=cfg.num_layers, num_heads=cfg.num_heads,
        intermediate_size=cfg.intermediate_size, pos_conv_kernel=cfg.pos_conv_kernel,
        pos_conv_groups=cfg.pos_conv_groups, layer_norm_eps=cfg.layer_norm_eps,
        hidden_dropout=cfg.hidden_dropout, attention_dropout=cfg.attention_dropout,
        activation_dropout=cfg.activation_dropout, feat_proj_dropout=cfg.feat_proj_dropout,
        mask_time_prob=cfg.mask_time_prob, mask_time_length=cfg.mask_time_length,
        ffn_mega=routes["ffn_route"] == "K4", qkv_fuse=routes["attention_route"] == "K3b",
        conv_fuse=routes["conv_fuse"])
    return ClassifierConfig(num_classes=cfg.num_classes, num_channels=1,
                            head_hidden=cfg.head_hidden, random_init=True, fs=fs,
                            encoder=encoder)


@pytest.mark.parametrize("config", ["wav2vec2-base-cinc", "wav2vec2-large-cinc"])
def test_published_configurations_build_as_before(config, monkeypatch):
    spec = json.loads((REPO / "benchmark" / "configs" / f"{config}.json").read_text())
    cfg = ModelConfig.from_file(spec)
    assert (cfg.feat_extract_norm, cfg.conv_bias, cfg.do_stable_layer_norm) == \
        ("group", False, False)
    assert leaf_shapes(cfg) == parent_leaf_shapes(cfg)
    ours = make_weights(cfg, 3_999_999_989, "cpu")
    monkeypatch.setattr(weights, "leaf_shapes", parent_leaf_shapes)
    theirs = make_weights(cfg, 3_999_999_989, "cpu")
    assert list(ours) == list(theirs)
    for name, v in ours.items():
        assert v.dtype == theirs[name].dtype and torch.equal(v, theirs[name]), name
    new, old = port_config(cfg, spec, 16000), parent_port_config(cfg, spec, 16000)
    for field in dataclasses.fields(old):
        assert getattr(new, field.name) == getattr(old, field.name), field.name
    for field in dataclasses.fields(old.encoder):
        assert getattr(new.encoder, field.name) == getattr(old.encoder, field.name), field.name
