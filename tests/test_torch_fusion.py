"""The two-branch PCG+ECG fusion model (``big_rnn:2:wav2vec``): the port vs the JAX package.

``EncoderFusion`` built by the port's ``build_two_branch`` and loaded with ``from_jax`` from
the JAX package's fusion tree (``head``, ``branch_0``, ``branch_1``; tiny branches) gives
the JAX logits at f32 atol 1e-5, and ``to_jax`` gives the tree back exactly. In training
both branches share the step's dropout seed, as the JAX model shares its dropout rngs
between branches with identical module paths, and each branch draws its own SpecAugment
spans. Training the fusion model (every parameter, the branches too) is held to the JAX
trainer by the ``pcg_ecg`` run in ``tests/test_torch_experiment.py``.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from wav2vec_heart_sounds_tpu.models.classifier import ClassifierConfig as JaxClassifierConfig
from wav2vec_heart_sounds_tpu.models.classifier import Wav2VecClassifier
from wav2vec_heart_sounds_tpu.models.fusion import two_branch_pcg_ecg
from wav2vec_heart_sounds_tpu.models.wav2vec2 import Wav2Vec2Config as JaxConfig
from wav2vec_heart_sounds_tpu_torch.models import wav2vec2
from wav2vec_heart_sounds_tpu_torch.models.build import build_two_branch
from wav2vec_heart_sounds_tpu_torch.models.classifier import ClassifierConfig
from wav2vec_heart_sounds_tpu_torch.models.fusion import EncoderFusion
from wav2vec_heart_sounds_tpu_torch.models.from_jax import from_jax, to_jax
from wav2vec_heart_sounds_tpu_torch.models.wav2vec2 import Wav2Vec2Config

FS, WIN = 1000, 1000
NO_NOISE = dict(hidden_dropout=0.0, attention_dropout=0.0, activation_dropout=0.0,
                feat_proj_dropout=0.0, mask_time_prob=0.0)


def _cfgs(port: bool, **noise):
    encoder = (Wav2Vec2Config if port else JaxConfig).tiny(**noise)
    cls = ClassifierConfig if port else JaxClassifierConfig
    return [cls(num_classes=2, head_hidden=(8,), random_init=True, fs=FS, encoder=encoder)
            for _ in range(2)]


@pytest.fixture(scope="module")
def jax_fusion():
    """The JAX package's ``build_two_branch`` (random init), with each branch's init jitted."""
    branches = []
    for cfg, key in zip(_cfgs(False, **NO_NOISE), jax.random.split(jax.random.key(2))):
        model = Wav2VecClassifier(cfg, dtype=jnp.float32)
        branches.append((model, jax.jit(model.init)(key, jnp.zeros((1, WIN), jnp.float32))))
    fusion, variables = two_branch_pcg_ecg(*branches)
    return fusion, jax.device_get(variables)


def _port_fusion(variables, **noise) -> EncoderFusion:
    model = build_two_branch(*_cfgs(True, **{**NO_NOISE, **noise}), seed=3, device="cpu",
                             train=True)
    model.load_state_dict(from_jax(variables["params"]), strict=True)
    return model


def _pairs(n, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(WIN) / FS
    pcg = (np.sin(2 * np.pi * rng.uniform(30, 200, size=(n, 1)) * t)
           + 0.2 * rng.normal(size=(n, WIN)))
    ecg = np.sin(2 * np.pi * 1.2 * t) + 0.05 * rng.normal(size=(n, WIN))
    return np.stack([pcg, ecg], axis=2).astype(np.float32)


def test_logits_match_jax_through_from_jax(jax_fusion):
    fusion, variables = jax_fusion
    x = _pairs(3, 0)
    ref = np.asarray(jax.jit(fusion.apply)(variables, jnp.asarray(x)))
    port = _port_fusion(variables).eval()
    assert port.head.dtype == torch.float32 and port.feature_dim == 2 * 32
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5)
    with pytest.raises(ValueError, match=r"\[B, T, 2\]"):
        port(torch.from_numpy(x[:, :, :1]))


def test_to_jax_round_trip(jax_fusion):
    _, variables = jax_fusion
    params = variables["params"]
    back = to_jax(_port_fusion(variables).state_dict(), params)
    leaves = jax.tree_util.tree_leaves_with_path(params)
    assert len(leaves) == len(jax.tree_util.tree_leaves(back))
    for path, leaf in leaves:
        node = back
        for key in path:
            node = node[key.key]
        np.testing.assert_array_equal(node, np.asarray(leaf), err_msg=str(path))


def test_branches_share_the_step_seed_and_draw_their_own_spans(jax_fusion, monkeypatch):
    _, variables = jax_fusion
    port = _port_fusion(variables, hidden_dropout=0.1, mask_time_prob=0.3)
    sites, spans = [], []
    real_dropout, real_mask = wav2vec2.dropout, wav2vec2.sample_time_mask

    def spy_dropout(x, seed, site, rate):
        sites.append((seed, site))
        return real_dropout(x, seed, site, rate)

    def spy_mask(generator, *args):
        mask = real_mask(generator, *args)
        spans.append(mask)
        return mask

    monkeypatch.setattr(wav2vec2, "dropout", spy_dropout)
    monkeypatch.setattr(wav2vec2, "sample_time_mask", spy_mask)
    x = torch.from_numpy(_pairs(2, 5))
    port(x, train=True, generator=torch.Generator().manual_seed(4))
    assert len({seed for seed, _ in sites}) == 1                # one step seed ...
    per_branch = len(sites) // 2
    assert sites[:per_branch] == sites[per_branch:]            # ... at the same sites
    assert len(spans) == 2 and not torch.equal(spans[0], spans[1])
