"""A configuration file (``benchmark/configs/<name>.json``) read into the sizes both sides use.

The file keeps the published ``config.json`` keys (HF's ``Wav2Vec2Config`` names) and adds
the classification head, the precision the port runs it in and the ``reduced`` and
``assumed`` lists. :class:`ModelConfig` is what the plain reference, the weights and the
FLOP count read; the port's own config object is read from the same keys in :mod:`.program`.

Three of HF's keys choose the architecture, as ``Wav2Vec2Model`` reads them:
``feat_extract_norm`` (``"group"``: GroupNorm on the first conv layer only, as in
wav2vec2-base and -large; ``"layer"``: LayerNorm over channels on every conv layer, as in
XLS-R and the ``-lv60`` models), ``conv_bias`` (a bias on every conv layer) and
``do_stable_layer_norm`` (pre-norm encoder layers with the encoder's LayerNorm after the
last one, in place of post-norm layers with it before the first). A key the file leaves out
takes HF's default, as ``config.json`` leaves out every key equal to it.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
# HF ``Wav2Vec2Config``'s defaults for the architecture keys read here.
HF_DEFAULTS = {"feat_extract_norm": "group", "conv_bias": False, "do_stable_layer_norm": False,
               "hidden_act": "gelu", "feat_extract_activation": "gelu"}


@dataclass(frozen=True)
class ModelConfig:
    conv_dim: tuple[int, ...]
    conv_kernel: tuple[int, ...]
    conv_stride: tuple[int, ...]
    hidden_size: int
    num_layers: int
    num_heads: int
    intermediate_size: int
    pos_conv_kernel: int
    pos_conv_groups: int
    layer_norm_eps: float
    hidden_dropout: float
    attention_dropout: float
    activation_dropout: float
    feat_proj_dropout: float
    mask_time_prob: float
    mask_time_length: int
    head_hidden: tuple[int, ...]
    num_classes: int
    compute_dtype: torch.dtype
    feat_extract_norm: str
    conv_bias: bool
    do_stable_layer_norm: bool

    @classmethod
    def from_file(cls, spec: dict) -> "ModelConfig":
        arch = {key: spec.get(key, default) for key, default in HF_DEFAULTS.items()}
        if arch["feat_extract_norm"] not in ("group", "layer"):
            raise ValueError(f"feat_extract_norm={arch['feat_extract_norm']!r}: the reference "
                             "computes 'group' and 'layer'")
        for key in ("hidden_act", "feat_extract_activation"):
            if arch[key] != "gelu":
                raise ValueError(f"{key}={arch[key]!r}: the reference computes 'gelu'")
        head = spec["classifier"]
        return cls(conv_dim=tuple(spec["conv_dim"]), conv_kernel=tuple(spec["conv_kernel"]),
                   conv_stride=tuple(spec["conv_stride"]), hidden_size=spec["hidden_size"],
                   num_layers=spec["num_hidden_layers"], num_heads=spec["num_attention_heads"],
                   intermediate_size=spec["intermediate_size"],
                   pos_conv_kernel=spec["num_conv_pos_embeddings"],
                   pos_conv_groups=spec["num_conv_pos_embedding_groups"],
                   layer_norm_eps=spec["layer_norm_eps"], hidden_dropout=spec["hidden_dropout"],
                   attention_dropout=spec["attention_dropout"],
                   activation_dropout=spec["activation_dropout"],
                   feat_proj_dropout=spec["feat_proj_dropout"],
                   mask_time_prob=spec["mask_time_prob"],
                   mask_time_length=spec["mask_time_length"],
                   head_hidden=tuple(head["hidden"]), num_classes=head["num_classes"],
                   compute_dtype=DTYPES[spec["precision"]["compute"]],
                   feat_extract_norm=arch["feat_extract_norm"],
                   conv_bias=arch["conv_bias"],
                   do_stable_layer_norm=arch["do_stable_layer_norm"])

    def frames(self, samples: int) -> int:
        """Encoder frames of a ``samples``-long input: the conv stack's output length."""
        for k, s in zip(self.conv_kernel, self.conv_stride):
            samples = (samples - k) // s + 1
        return samples
