"""A configuration file (``benchmark/configs/<name>.json``) read into the sizes both sides use.

The file keeps the published ``config.json`` keys (HF's ``Wav2Vec2Config`` names) and adds
the classification head, the precision the port runs it in and the ``reduced`` and
``assumed`` lists. :class:`ModelConfig` is what the plain reference and the FLOP count read;
the port's own config objects are made from it in :mod:`.program`.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


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

    @classmethod
    def from_file(cls, spec: dict) -> "ModelConfig":
        if spec["feat_extract_norm"] != "group" or spec["do_stable_layer_norm"] \
                or spec["conv_bias"] or spec["hidden_act"] != "gelu":
            raise ValueError("the port runs the group-norm, post-norm wav2vec2 without conv "
                             "bias and with GELU")
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
                   compute_dtype=DTYPES[spec["precision"]["compute"]])

    def frames(self, samples: int) -> int:
        """Encoder frames of a ``samples``-long input: the conv stack's output length."""
        for k, s in zip(self.conv_kernel, self.conv_stride):
            samples = (samples - k) // s + 1
        return samples
