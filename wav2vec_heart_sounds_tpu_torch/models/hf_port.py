"""HF ``transformers`` Wav2Vec2 state dict -> this port's :class:`.wav2vec2.Wav2Vec2Model`.

The port's parameter names are HF's ``Wav2Vec2Model`` keys, so conversion is the identity
except for the weight-normed positional conv, which is materialised as
``g * v / ||v||`` (norm over dims (0, 1), torch ``weight_norm(dim=2)``) in float64, as in
``wav2vec_heart_sounds_tpu/models/hf_port.py``. Needs no ``transformers``: any mapping of
HF keys to arrays or tensors will do.
"""

from __future__ import annotations

import importlib.util
import os

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


def _hub_dir(name: str) -> str:
    home = os.environ.get("HF_HOME") or os.path.join(os.path.expanduser("~"), ".cache",
                                                     "huggingface")
    hub = os.environ.get("HF_HUB_CACHE") or os.path.join(home, "hub")
    return os.path.join(hub, "models--" + name.replace("/", "--"))


def load_pretrained_encoder(name: str = "facebook/wav2vec2-base-960h"
                            ) -> dict[str, torch.Tensor] | None:
    """The HF checkpoint ``name`` from the local HF cache as a port state dict, or None when
    the checkpoint or ``transformers`` is not on this machine. Never downloads."""
    if importlib.util.find_spec("transformers") is None or not os.path.isdir(_hub_dir(name)):
        return None
    try:
        from transformers import Wav2Vec2Model as HFWav2Vec2Model

        hf = HFWav2Vec2Model.from_pretrained(name, local_files_only=True)
    except Exception:
        return None
    return convert_state_dict(hf.state_dict(), hf.config.hidden_size)
