"""The JAX package's flax parameter tree (as numpy) <-> this port's state dict.

A flax tree of ``Wav2Vec2Model`` (top key ``feature_encoder``) or of ``Wav2VecClassifier``
(top keys ``encoder`` and ``head``) maps leaf by leaf to the port's keys: dense kernels
``[in, out]`` transpose to ``weight [out, in]``, conv kernels ``[k, in, out]`` to
``weight [out, in, k]``, norm ``scale`` becomes ``weight``. :func:`to_jax` is the exact
inverse. The tree is plain nested dicts of arrays; nothing here imports JAX.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

_DENSE, _CONV, _SAME = "dense", "conv", "same"


def _enc_layout(n_conv: int, n_layers: int) -> list[tuple[tuple[str, ...], str, str]]:
    """(flax path, port key, transform) for every leaf of a LoRA-free encoder tree."""
    out = [(("feature_encoder", f"conv_{i}", "kernel"),
            f"feature_extractor.conv_layers.{i}.conv.weight", _CONV) for i in range(n_conv)]

    def norm(path, key):
        return [(path + ("scale",), key + ".weight", _SAME), (path + ("bias",), key + ".bias", _SAME)]

    def dense(path, key):
        return [(path + ("kernel",), key + ".weight", _DENSE), (path + ("bias",), key + ".bias", _SAME)]

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
        out += norm(jp + ("layer_norm",), f"{tp}.layer_norm")
        out += dense(jp + ("intermediate_dense",), f"{tp}.feed_forward.intermediate_dense")
        out += dense(jp + ("output_dense",), f"{tp}.feed_forward.output_dense")
        out += norm(jp + ("final_layer_norm",), f"{tp}.final_layer_norm")
    return out


def _count(tree: dict, prefix: str) -> int:
    return sum(1 for k in tree if k.startswith(prefix))


def layout(params: dict) -> list[tuple[tuple[str, ...], str, str]]:
    """Leaf mapping for a flax encoder or classifier tree."""
    if "encoder" not in params:
        return _enc_layout(_count(params["feature_encoder"], "conv_"), _count(params, "layers_"))
    enc, head = params["encoder"], params["head"]
    out = [(("encoder",) + p, "encoder." + k, t)
           for p, k, t in _enc_layout(_count(enc["feature_encoder"], "conv_"),
                                      _count(enc, "layers_"))]
    for name in [f"dense_{i}" for i in range(_count(head, "dense_"))] + ["logits"]:
        out += [(("head", name, "kernel"), f"head.{name}.weight", _DENSE),
                (("head", name, "bias"), f"head.{name}.bias", _SAME)]
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
            _SAME: lambda x: x}[kind](a)


def from_jax(params: dict) -> dict[str, torch.Tensor]:
    """Flax param tree -> float32 port state dict. Raises on leaves it cannot place
    (LoRA adapters, beamformer), so no weight is silently dropped."""
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
    for path, key, kind in layout(params_like):
        a = state_dict[key]
        a = a.detach().cpu().float().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = np.ascontiguousarray(_to_port(a, kind))   # each transform is an involution
    return out
