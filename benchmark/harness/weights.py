"""The model's weights, made by the benchmark from ``--seed`` on the device.

Leaves are named as HF's ``Wav2Vec2Model`` state dict names them, under ``encoder.``, with
the classification head under ``head.`` (``dense_<i>`` then ``logits``): the names the port
loads strictly, and the names the plain reference reads. Values come from ONE
``torch.randn`` call over every leaf (a ``torch.Generator`` on the device seeded with the
seed), shaped per leaf:

* products' and convolutions' weights: ``N(0, 1 / fan_in)``;
* their biases: ``N(0, 0.02^2)``; norm scales ``1 + N(0, 0.05^2)``, norm shifts
  ``N(0, 0.05^2)``;
* ``masked_spec_embed``: ``U(0, 1)`` (the normal draw through its CDF).

Each leaf is then rounded to the dtype it is served in (:func:`served_dtype`): the compute
dtype, but float32 for every norm, ``masked_spec_embed`` and the logits layer. So a conv
layer's bias (``conv_bias``) is served in the compute dtype and its LayerNorm
(``feat_extract_norm="layer"``) in float32. Both sides start from these rounded values.

The architecture keys add leaves and never move one: a conv layer's ``conv.bias`` follows
its ``conv.weight``, its ``layer_norm`` follows that, and the pre-norm encoder has the same
leaves as the post-norm one. So a group-norm configuration without conv biases draws what
it drew before these keys were read, bit for bit.
"""

from __future__ import annotations

import math

import torch

from .configs import ModelConfig


def leaf_shapes(cfg: ModelConfig) -> list[tuple[str, tuple[int, ...]]]:
    """(name, shape) of every leaf, in a fixed order."""
    out = []
    cin = (1,) + tuple(cfg.conv_dim[:-1])
    fe = "encoder.feature_extractor.conv_layers"
    for i, (ci, co, k) in enumerate(zip(cin, cfg.conv_dim, cfg.conv_kernel)):
        out.append((f"{fe}.{i}.conv.weight", (co, ci, k)))
        if cfg.conv_bias:
            out.append((f"{fe}.{i}.conv.bias", (co,)))
        if i == 0 or cfg.feat_extract_norm == "layer":
            out += [(f"{fe}.{i}.layer_norm.weight", (co,)), (f"{fe}.{i}.layer_norm.bias", (co,))]
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


def is_norm(name: str) -> bool:
    return "norm" in name.rsplit(".", 2)[-2]


def served_dtype(name: str, compute: torch.dtype) -> torch.dtype:
    """The dtype a leaf is served in: float32 for norms, the SpecAugment embedding and the
    logits layer, the compute dtype for every other leaf."""
    if is_norm(name) or name.endswith("masked_spec_embed") or name.startswith("head.logits."):
        return torch.float32
    return compute


def make_weights(cfg: ModelConfig, seed: int, device) -> dict[str, torch.Tensor]:
    """Every leaf of ``cfg`` from ``seed``, rounded to its served dtype, on ``device``."""
    shapes = leaf_shapes(cfg)
    sizes = [math.prod(shape) for _, shape in shapes]
    gen = torch.Generator(device=device).manual_seed(seed)
    draws = torch.randn(sum(sizes), generator=gen, device=device).split(sizes)
    out = {}
    for (name, shape), v in zip(shapes, draws):
        v = v.view(shape)
        leaf = name.rsplit(".", 1)[-1]
        if name.endswith("masked_spec_embed"):
            v = 0.5 * (1.0 + torch.erf(v / math.sqrt(2.0)))
        elif is_norm(name):
            v = 1.0 + 0.05 * v if leaf == "weight" else 0.05 * v
        elif leaf == "bias":
            v = 0.02 * v
        else:
            v = v / math.sqrt(math.prod(shape[1:]))
        out[name] = v.to(served_dtype(name, cfg.compute_dtype))
    return out
