"""The JAX package's flax parameter tree (as numpy) <-> this port's state dict.

A flax tree of ``Wav2Vec2Model`` (top key ``feature_encoder``), of ``Wav2VecClassifier``
(top keys ``encoder``, ``head`` and, for a multichannel classifier, ``channel_mixer``) or of
the fusion model ``EncoderFusion`` (top keys ``head`` and ``branch_0``, ``branch_1``, ...,
each a classifier tree) maps leaf by leaf to the port's keys: dense kernels ``[in, out]``
transpose to ``weight [out, in]``, conv kernels ``[k, in, out]`` to ``weight [out, in, k]``,
norm ``scale`` becomes ``weight``, LoRA ``lora_a``/``lora_b`` keep their flax layout, and the
delay predictor's attention kernels (``[32, 4, 8]`` for query/key/value, ``[4, 8, 32]``
for out, biases ``[4, 8]``) flatten to ``[32, 32]`` linears. The diffusion vocoders' trees
(``DiffWave``: top key ``mel_upsampler``; ``WaveGrad``: top key ``first_conv``) map the same
way onto their channels-first modules: a ``Dense`` over channels becomes a 1x1 conv
(``[in, out]`` -> ``[out, in, 1]``), an ``Embed`` table keeps its layout, and DiffWave's
upsampler kernel ``(3, 2f, 1, 1)`` becomes the ``ConvTranspose2d`` weight ``[1, 1, 3, 2f]``
unflipped (the JAX module flips it itself). :func:`to_jax` is the exact
inverse (it takes each leaf's shape from ``params_like``). The tree is plain nested dicts
of arrays; nothing here imports JAX.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

_DENSE, _CONV, _SAME, _DENSE_1X1, _UPSAMPLE = "dense", "conv", "same", "dense_1x1", "upsample"
_HEADS_IN, _HEADS_OUT, _FLAT = "heads_in", "heads_out", "flat"


def _norm(path, key):
    return [(path + ("scale",), key + ".weight", _SAME), (path + ("bias",), key + ".bias", _SAME)]


def _dense(path, key, kernel=_DENSE, bias=_SAME):
    return [(path + ("kernel",), key + ".weight", kernel), (path + ("bias",), key + ".bias", bias)]


def _enc_layout(n_conv: int, n_layers: int,
                lora: bool = False) -> list[tuple[tuple[str, ...], str, str]]:
    """(flax path, port key, transform) for every leaf of an encoder tree."""
    out = [(("feature_encoder", f"conv_{i}", "kernel"),
            f"feature_extractor.conv_layers.{i}.conv.weight", _CONV) for i in range(n_conv)]

    norm, dense = _norm, _dense
    out += norm(("feature_encoder", "group_norm"), "feature_extractor.conv_layers.0.layer_norm")
    out += norm(("feature_projection", "layer_norm"), "feature_projection.layer_norm")
    out += dense(("feature_projection", "projection"), "feature_projection.projection")
    out += [(("pos_conv_embed", "conv", "kernel"), "encoder.pos_conv_embed.conv.weight", _CONV),
            (("pos_conv_embed", "conv", "bias"), "encoder.pos_conv_embed.conv.bias", _SAME)]
    out += norm(("layer_norm",), "encoder.layer_norm")
    out.append((("masked_spec_embed",), "masked_spec_embed", _SAME))
    for i in range(n_layers):
        jp, tp = (f"layers_{i}",), f"encoder.layers.{i}"
        for proj, sub in (("q_proj", ("base",)), ("k_proj", ()), ("v_proj", ("base",)),
                          ("out_proj", ())):
            out += dense(jp + ("attention", proj) + sub, f"{tp}.attention.{proj}")
        if lora:
            out += [(jp + ("attention", proj, leaf), f"{tp}.attention.{proj}.{leaf}", _SAME)
                    for proj in ("q_proj", "v_proj") for leaf in ("lora_a", "lora_b")]
        out += norm(jp + ("layer_norm",), f"{tp}.layer_norm")
        out += dense(jp + ("intermediate_dense",), f"{tp}.feed_forward.intermediate_dense")
        out += dense(jp + ("output_dense",), f"{tp}.feed_forward.output_dense")
        out += norm(jp + ("final_layer_norm",), f"{tp}.final_layer_norm")
    return out


def _count(tree: dict, prefix: str) -> int:
    return sum(1 for k in tree if k.startswith(prefix))


def _has_lora(enc: dict) -> bool:
    return "layers_0" in enc and "lora_a" in enc["layers_0"]["attention"]["q_proj"]


def _mixer_layout(mixer: dict) -> list[tuple[tuple[str, ...], str, str]]:
    """The beamformer's delay predictor (``channel_mixer/delay_predictor``)."""
    jp, tp = ("channel_mixer", "delay_predictor"), "channel_mixer.delay_predictor"
    tree = mixer["delay_predictor"]
    out = _dense(jp + ("input_proj",), f"{tp}.input_proj")
    for i in range(_count(tree, "attn_")):
        for proj in ("query", "key", "value"):
            out += _dense(jp + (f"attn_{i}", proj), f"{tp}.attn_{i}.{proj}", _HEADS_IN, _FLAT)
        out += _dense(jp + (f"attn_{i}", "out"), f"{tp}.attn_{i}.out", _HEADS_OUT)
        for name in (f"norm1_{i}", f"norm2_{i}"):
            out += _norm(jp + (name,), f"{tp}.{name}")
        for name in (f"ff1_{i}", f"ff2_{i}"):
            out += _dense(jp + (name,), f"{tp}.{name}")
    return out + _dense(jp + ("output_proj",), f"{tp}.output_proj")


def _head_layout(head: dict) -> list[tuple[tuple[str, ...], str, str]]:
    """An MLP head: ``dense_0`` ... then ``logits``."""
    names = [f"dense_{i}" for i in range(_count(head, "dense_"))] + ["logits"]
    return [m for name in names for m in _dense(("head", name), f"head.{name}")]


def _diffwave_layout(params: dict) -> list[tuple[tuple[str, ...], str, str]]:
    up = params["mel_upsampler"]
    out = _dense(("input_projection",), "input_projection", _DENSE_1X1)
    out += _dense(("step_embedding", "proj1"), "step_embedding.proj1")
    out += _dense(("step_embedding", "proj2"), "step_embedding.proj2")
    for i in range(_count(up, "kernel_")):
        out += [(("mel_upsampler", f"kernel_{i}"), f"mel_upsampler.convs.{i}.weight", _UPSAMPLE),
                (("mel_upsampler", f"bias_{i}"), f"mel_upsampler.convs.{i}.bias", _SAME)]
    out.append((("label_embedding", "embedding"), "label_embedding.weight", _SAME))
    for i in range(_count(params, "residual_")):
        jp, tp = (f"residual_{i}",), f"residual_layers.{i}"
        out += _dense(jp + ("step_proj",), f"{tp}.step_proj")
        out += _dense(jp + ("dilated",), f"{tp}.dilated", _CONV)
        out += _dense(jp + ("label_proj",), f"{tp}.label_proj")
        for name in ("cond_proj", "out_proj"):
            out += _dense(jp + (name,), f"{tp}.{name}", _DENSE_1X1)
    for name in ("skip_projection", "output_projection"):
        out += _dense((name,), name, _DENSE_1X1)
    return out


def _wavegrad_layout(params: dict) -> list[tuple[tuple[str, ...], str, str]]:
    def conv(path, key):
        return _dense(path, key, _CONV)

    out = conv(("init_conv",), "init_conv") + conv(("first_conv",), "first_conv")
    out += conv(("last_conv",), "last_conv")
    for i in range(_count(params, "down_")):
        jp, tp = f"down_{i}", f"downs.{i}"
        out += conv((jp, "residual"), f"{tp}.residual")
        out += [m for j in range(3) for m in conv((jp, f"conv_{j}"), f"{tp}.convs.{j}")]
    for i in range(_count(params, "film_")):
        jp, tp = f"film_{i}", f"films.{i}"
        out.append(((jp, "label_embedding", "embedding"), f"{tp}.label_embedding.weight", _SAME))
        out += _dense((jp, "label_proj"), f"{tp}.label_proj")
        out += conv((jp, "input_conv"), f"{tp}.input_conv")
        out += conv((jp, "output_conv"), f"{tp}.output_conv")
    for i in range(_count(params, "up_")):
        out += [m for name in ("skip", "conv_a0", "conv_a1", "conv_b0", "conv_b1")
                for m in conv((f"up_{i}", name), f"ups.{i}.{name}")]
    return out


def layout(params: dict) -> list[tuple[tuple[str, ...], str, str]]:
    """Leaf mapping for a flax encoder, classifier, fusion, DiffWave or WaveGrad tree."""
    if "mel_upsampler" in params:
        return _diffwave_layout(params)
    if "first_conv" in params:
        return _wavegrad_layout(params)
    if "branch_0" in params:
        out = []
        for i in range(_count(params, "branch_")):
            name = f"branch_{i}"
            out += [((name,) + p, f"{name}.{k}", t) for p, k, t in layout(params[name])]
        return out + _head_layout(params["head"])
    if "encoder" not in params:
        return _enc_layout(_count(params["feature_encoder"], "conv_"), _count(params, "layers_"),
                           _has_lora(params))
    enc = params["encoder"]
    out = [(("encoder",) + p, "encoder." + k, t)
           for p, k, t in _enc_layout(_count(enc["feature_encoder"], "conv_"),
                                      _count(enc, "layers_"), _has_lora(enc))]
    out += _head_layout(params["head"])
    if "channel_mixer" in params:
        out += _mixer_layout(params["channel_mixer"])
    return out


def _leaves(tree: dict, prefix=()) -> dict[tuple[str, ...], np.ndarray]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_leaves(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def _to_port(a: np.ndarray, kind: str) -> np.ndarray:
    return {_DENSE: lambda x: x.T, _CONV: lambda x: x.transpose(2, 1, 0),
            _DENSE_1X1: lambda x: x.T[:, :, None], _UPSAMPLE: lambda x: x.transpose(2, 3, 0, 1),
            _SAME: lambda x: x, _HEADS_IN: lambda x: x.reshape(x.shape[0], -1).T,
            _HEADS_OUT: lambda x: x.reshape(-1, x.shape[-1]).T,
            _FLAT: lambda x: x.reshape(-1)}[kind](a)


def _to_flax(a: np.ndarray, kind: str, shape: tuple[int, ...]) -> np.ndarray:
    """Inverse of :func:`_to_port` onto a flax leaf of ``shape``."""
    if kind in (_HEADS_IN, _HEADS_OUT, _FLAT, _DENSE_1X1):
        return (a if kind == _FLAT else a.T).reshape(shape)
    return _to_port(a, kind)                   # the other transforms are involutions


def from_jax(params: dict) -> dict[str, torch.Tensor]:
    """Flax param tree -> float32 port state dict. Raises on leaves it cannot place, so no
    weight is silently dropped."""
    leaves = {p: np.asarray(v) for p, v in _leaves(params).items()}
    mapping = layout(params)
    unplaced = set(leaves) - {p for p, _, _ in mapping}
    if unplaced:
        raise NotImplementedError(f"flax leaves with no port counterpart: {sorted(unplaced)}")
    return {key: torch.tensor(np.asarray(_to_port(leaves[p], kind), dtype=np.float32))
            for p, key, kind in mapping}


def to_jax(state_dict: dict, params_like: dict) -> dict:
    """Port state dict -> flax param tree shaped like ``params_like`` (inverse of
    :func:`from_jax`)."""
    out: dict = {}
    like = _leaves(params_like)
    for path, key, kind in layout(params_like):
        a = state_dict[key]
        a = a.detach().cpu().float().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = np.ascontiguousarray(_to_flax(a, kind, np.shape(like[path])))
    return out
