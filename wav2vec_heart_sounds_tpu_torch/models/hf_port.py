"""HF ``transformers`` Wav2Vec2 state dict -> this port's :class:`.wav2vec2.Wav2Vec2Model`.

The port's parameter names are HF's ``Wav2Vec2Model`` keys, so conversion is the identity
except for the weight-normed positional conv, which is materialised as
``g * v / ||v||`` (norm over dims (0, 1), torch ``weight_norm(dim=2)``) in float64, as in
``wav2vec_heart_sounds_tpu/models/hf_port.py``. Needs no ``transformers``: any mapping of
HF keys to arrays or tensors will do.
"""

from __future__ import annotations

import numpy as np
import torch

from .wav2vec2 import Wav2Vec2Model

_POS = "encoder.pos_conv_embed.conv."
_WEIGHT_NORM_KEYS = (("weight_g", "weight_v"),
                     ("parametrizations.weight.original0", "parametrizations.weight.original1"))


def _numpy(v) -> np.ndarray:
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


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
