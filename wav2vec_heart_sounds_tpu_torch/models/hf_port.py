"""HF Wav2Vec2 checkpoints on disk -> this port's :class:`.wav2vec2.Wav2Vec2Model`.

Port of ``wav2vec_heart_sounds_tpu/models/hf_port.py`` that needs neither ``transformers``
nor ``safetensors``: :func:`load_pretrained_encoder` finds a checkpoint (a directory, or a
hub name in the local HF hub cache; it never downloads), reads its ``config.json`` and its
weights (``model.safetensors`` parsed here, ``pytorch_model.bin`` through ``torch.load``,
either one sharded through its ``*.index.json``), keeps the encoder's keys as
``Wav2Vec2Model.from_pretrained`` does (the ``wav2vec2.`` prefix of a ``Wav2Vec2ForCTC`` or
pretraining checkpoint stripped, ``lm_head``, ``quantizer`` and ``project_*`` dropped) and
returns the port's config with the state dict.

The port's parameter names are HF's ``Wav2Vec2Model`` keys, so conversion is the identity
except for the weight-normed positional conv (legacy ``weight_g``/``weight_v`` or
``parametrizations`` keys), which is materialised as ``g * v / ||v||`` (norm over dims
(0, 1), torch ``weight_norm(dim=2)``) in float64, as in the JAX package.

The three architecture keys of the stable-layer-norm family (the ``-lv60`` checkpoints,
XLSR-53, XLS-R: ``feat_extract_norm="layer"``, ``conv_bias``, ``do_stable_layer_norm``) are
adopted like the shapes; the conv biases and every conv layer's LayerNorm load under their HF
keys. Unlike the JAX loader, which turns every exception into ``None``, only a checkpoint that
is not there gives ``None``: one that cannot be read, that does not fit its config, or whose
config asks for an architecture the model does not compute (another feature-encoder norm,
another activation) raises.
"""

from __future__ import annotations

import json
import math
import os
from pathlib import Path

import numpy as np
import torch

from .wav2vec2 import Wav2Vec2Config, Wav2Vec2Model

_POS = "encoder.pos_conv_embed.conv."
_WEIGHT_NORM_KEYS = (("weight_g", "weight_v"),
                     ("parametrizations.weight.original0", "parametrizations.weight.original1"))

# HF ``Wav2Vec2Config``'s defaults for the keys read here: ``save_pretrained`` leaves out of
# config.json every key equal to them.
HF_DEFAULTS = {
    "conv_dim": (512, 512, 512, 512, 512, 512, 512),
    "conv_kernel": (10, 3, 3, 3, 3, 2, 2),
    "conv_stride": (5, 2, 2, 2, 2, 2, 2),
    "hidden_size": 768, "num_hidden_layers": 12, "num_attention_heads": 12,
    "intermediate_size": 3072, "num_conv_pos_embeddings": 128,
    "num_conv_pos_embedding_groups": 16, "layer_norm_eps": 1e-5,
    "hidden_dropout": 0.1, "attention_dropout": 0.1, "activation_dropout": 0.1,
    "feat_proj_dropout": 0.0, "mask_time_prob": 0.05, "mask_time_length": 10,
    "feat_extract_norm": "group", "do_stable_layer_norm": False, "conv_bias": False,
    "hidden_act": "gelu", "feat_extract_activation": "gelu",
}
# Port field <- HF key: the JAX package's ``config_from_hf``.
FIELDS = (("conv_dim", "conv_dim"), ("conv_kernel", "conv_kernel"),
          ("conv_stride", "conv_stride"), ("hidden_size", "hidden_size"),
          ("num_layers", "num_hidden_layers"), ("num_heads", "num_attention_heads"),
          ("intermediate_size", "intermediate_size"),
          ("pos_conv_kernel", "num_conv_pos_embeddings"),
          ("pos_conv_groups", "num_conv_pos_embedding_groups"),
          ("layer_norm_eps", "layer_norm_eps"), ("hidden_dropout", "hidden_dropout"),
          ("attention_dropout", "attention_dropout"),
          ("activation_dropout", "activation_dropout"),
          ("feat_proj_dropout", "feat_proj_dropout"), ("mask_time_prob", "mask_time_prob"),
          ("mask_time_length", "mask_time_length"))
# The stable-layer-norm family's architecture keys (port field = HF key), which the JAX
# package does not compute.
FAMILY_FIELDS = ("feat_extract_norm", "conv_bias", "do_stable_layer_norm")
# The architecture fields ``build_classifier`` takes from a checkpoint (as the JAX one does);
# dropouts, SpecAugment, LoRA, routes and remat stay the caller's.
ARCHITECTURE = ("conv_dim", "conv_kernel", "conv_stride", "hidden_size", "num_layers",
                "num_heads", "intermediate_size", "pos_conv_kernel", "pos_conv_groups",
                "layer_norm_eps") + FAMILY_FIELDS
# HF keys and the values the model computes; any other value names an architecture it does
# not compute.
COMPUTED = {"feat_extract_norm": ("group", "layer"), "hidden_act": ("gelu",),
            "feat_extract_activation": ("gelu",)}
# Roots of a ``Wav2Vec2Model`` state dict; a head model's other keys are dropped.
ENCODER_ROOTS = ("feature_extractor", "feature_projection", "encoder", "masked_spec_embed")
BASE_PREFIX = "wav2vec2."
WEIGHT_FILES = ("model.safetensors", "pytorch_model.bin")
SAFETENSORS_DTYPES = {"F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16}


def config_from_hf(hf_config) -> Wav2Vec2Config:
    """The port's config of an HF ``Wav2Vec2Config``: a ``config.json`` dict or an object with
    those attributes, a missing key taking HF's default. Raises ``ValueError``, naming the
    field, for an architecture the model does not compute."""
    def get(key):
        if isinstance(hf_config, dict):
            return hf_config.get(key, HF_DEFAULTS[key])
        return getattr(hf_config, key, HF_DEFAULTS[key])

    for key, values in COMPUTED.items():
        if get(key) not in values:
            raise ValueError(f"checkpoint config {key}={get(key)!r}: the model computes only "
                             + " or ".join(f"{key}={v!r}" for v in values))
    kw = {field: get(key) for field, key in FIELDS}
    kw.update({field: get(field) for field in FAMILY_FIELDS})
    for field in ("conv_dim", "conv_kernel", "conv_stride"):
        kw[field] = tuple(kw[field])
    return Wav2Vec2Config(**kw)


def _numpy(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu()
        return (v.float() if v.dtype in (torch.float16, torch.bfloat16) else v).numpy()
    return np.asarray(v)


def convert_state_dict(sd: dict, hidden_size: int = 768) -> dict[str, torch.Tensor]:
    """HF state dict -> float32 port state dict (weight norm materialised)."""
    sd = {k: _numpy(v) for k, v in sd.items()}
    for g_key, v_key in _WEIGHT_NORM_KEYS:
        if _POS + g_key in sd:
            g = sd.pop(_POS + g_key).astype(np.float64)
            v = sd.pop(_POS + v_key).astype(np.float64)
            break
    else:
        raise KeyError(f"no weight-normed positional conv under {_POS!r}")
    norm = np.sqrt(np.sum(v ** 2, axis=(0, 1), keepdims=True))
    sd[_POS + "weight"] = g * v / np.maximum(norm, 1e-12)            # [out, in/groups, k]
    if "masked_spec_embed" not in sd:   # HF omits it when spec-augment is off in the config
        sd["masked_spec_embed"] = np.random.default_rng(0).uniform(0, 1, hidden_size)
    return {k: torch.tensor(np.asarray(v, dtype=np.float32)) for k, v in sd.items()}


def load_hf_state_dict(model: Wav2Vec2Model, sd: dict) -> Wav2Vec2Model:
    """Load an HF-layout state dict into ``model`` (strict: every key must match)."""
    model.load_state_dict(convert_state_dict(sd, model.config.hidden_size), strict=True)
    return model


def hub_cache() -> Path:
    """The local HF hub cache: ``HF_HUB_CACHE``, else ``HF_HOME/hub``, else
    ``~/.cache/huggingface/hub``."""
    home = os.environ.get("HF_HOME") or os.path.join(os.path.expanduser("~"), ".cache",
                                                     "huggingface")
    return Path(os.environ.get("HF_HUB_CACHE") or os.path.join(home, "hub"))


def resolve(name: str) -> Path | None:
    """The checkpoint directory of ``name``: ``name`` itself when it is a directory, else the
    snapshot that ``refs/main`` names under ``models--org--name`` in :func:`hub_cache`;
    ``None`` when there is neither."""
    if os.path.isdir(name):
        return Path(name)
    repo = hub_cache() / ("models--" + name.replace("/", "--"))
    ref = repo / "refs" / "main"
    if not ref.is_file():
        return None
    snapshot = repo / "snapshots" / ref.read_text().strip()
    return snapshot if snapshot.is_dir() else None


def read_safetensors(path: Path) -> dict[str, torch.Tensor]:
    """A ``.safetensors`` file's tensors: an 8-byte little-endian header length, the JSON
    header (``dtype``, ``shape``, ``data_offsets`` from the end of the header; its
    ``__metadata__`` skipped), then the data. F32, F16 and BF16; a truncated or inconsistent
    file raises ``ValueError``."""
    out = {}
    with open(path, "rb") as fh:
        size = os.fstat(fh.fileno()).st_size
        head = fh.read(8)
        n = int.from_bytes(head, "little") if len(head) == 8 else -1
        if n < 0 or 8 + n > size:
            raise ValueError(f"{path}: truncated safetensors header")
        try:
            header = json.loads(fh.read(n))
        except ValueError as exc:
            raise ValueError(f"{path}: unreadable safetensors header ({exc})") from None
        if not isinstance(header, dict):
            raise ValueError(f"{path}: the safetensors header is not a JSON object")
        start = 8 + n
        for key, meta in header.items():
            if key == "__metadata__":
                continue
            dtype = SAFETENSORS_DTYPES.get(meta["dtype"])
            if dtype is None:
                raise ValueError(f"{path}: {key} has dtype {meta['dtype']}; this reader takes "
                                 f"{', '.join(SAFETENSORS_DTYPES)}")
            shape, (begin, end) = meta["shape"], meta["data_offsets"]
            count = math.prod(shape)
            if end - begin != count * dtype.itemsize or begin < 0 or start + end > size:
                raise ValueError(f"{path}: {key} lies outside the file or does not match its "
                                 f"shape {shape}")
            buf = bytearray(end - begin)
            fh.seek(start + begin)
            fh.readinto(buf)
            out[key] = (torch.frombuffer(buf, dtype=dtype).reshape(shape) if count
                        else torch.empty(shape, dtype=dtype))
    return out


def read_bin(path: Path) -> dict[str, torch.Tensor]:
    """A ``pytorch_model.bin`` state dict (``torch.load``, tensors only, on the CPU)."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(sd, dict) or not all(isinstance(v, torch.Tensor) for v in sd.values()):
        raise ValueError(f"{path}: not a state dict of tensors")
    return sd


def read_weights(directory: Path) -> dict[str, torch.Tensor]:
    """Every tensor of the checkpoint in ``directory``: ``model.safetensors``, else
    ``pytorch_model.bin``, else either one's shards through its ``.index.json``."""
    readers = {"model.safetensors": read_safetensors, "pytorch_model.bin": read_bin}
    for name in WEIGHT_FILES:
        if (directory / name).is_file():
            return readers[name](directory / name)
        index = directory / (name + ".index.json")
        if index.is_file():
            weight_map = json.loads(index.read_text())["weight_map"]
            sd = {}
            for shard in sorted(set(weight_map.values())):
                sd.update(readers[name](directory / shard))
            if set(weight_map) - set(sd):
                raise ValueError(f"{index}: the shards lack {sorted(set(weight_map) - set(sd))}")
            return sd
    raise FileNotFoundError(f"{directory} holds none of {', '.join(WEIGHT_FILES)} or their "
                            f"sharded indexes")


def encoder_keys(sd: dict) -> dict:
    """The ``Wav2Vec2Model`` keys of a checkpoint's state dict, as ``from_pretrained`` takes
    them: the ``wav2vec2.`` prefix stripped, the head's keys (``lm_head``, ``quantizer``,
    ``project_q``, ``project_hid``, ...) dropped."""
    out = {}
    for key, value in sd.items():
        key = key.removeprefix(BASE_PREFIX)
        if key.split(".", 1)[0] in ENCODER_ROOTS:
            out[key] = value
    return out


def load_pretrained_encoder(name: str = "facebook/wav2vec2-base-960h"
                            ) -> tuple[Wav2Vec2Config, dict[str, torch.Tensor]] | None:
    """``(config, port state dict)`` of the HF checkpoint ``name`` (a directory or a hub name
    in the local cache), or ``None`` when no checkpoint of that name is on this machine.
    Never downloads. A checkpoint that cannot be read or does not fit its config raises."""
    directory = resolve(name)
    if directory is None:
        return None
    config_path = directory / "config.json"
    if not config_path.is_file():
        raise FileNotFoundError(f"{directory} holds no config.json")
    cfg = config_from_hf(json.loads(config_path.read_text()))
    sd = convert_state_dict(encoder_keys(read_weights(directory)), cfg.hidden_size)
    with torch.device("meta"):
        want = {k: tuple(v.shape) for k, v in Wav2Vec2Model(cfg).state_dict().items()}
    got = {k: tuple(v.shape) for k, v in sd.items()}
    if got != want:
        wrong = sorted(k for k in set(got) & set(want) if got[k] != want[k])
        raise ValueError(f"checkpoint {name} does not fit its config: missing "
                         f"{sorted(set(want) - set(got))}, unexpected "
                         f"{sorted(set(got) - set(want))}, other shapes {wrong}")
    return cfg, sd
