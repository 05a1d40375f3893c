"""The port's reverse-diffusion samplers vs the JAX package's scan samplers, on the CPU.

Same weights (``tests/torch_vocoder_pairs.py``) and the JAX sampler's own draws, taken from
the key splits of ``samplers.py:71-73`` (the initial noise from the first split, each step's
from ``split(key, steps)``) and injected. DiffWave at the tiny config: the fast 6-step path
(fractional steps) and the full 50 steps; WaveGrad at its one width, sub-sampled to 3 steps
over 4 frames. Bar: 1e-4 absolute on audio clamped to [-1, 1] after every step (float32
rounding through 50 chained model calls; a clamp can only shrink a difference). Also the
shape ``(B, hop * frames)``, the 4 kHz rate, the clamp, and a 2-D conditioner with a scalar
label sampled from a ``torch.Generator``.
"""

import numpy as np
import jax
import pytest
import torch

from wav2vec_heart_sounds_tpu.models.diffusion import samplers as jax_samplers
from wav2vec_heart_sounds_tpu_torch.models.diffusion import samplers
from torch_vocoder_pairs import (FRAMES, TINY, diffwave_pair, make_batch,  # noqa: F401
                                 make_wavegrad_pair, one_torch_thread)


def _jax_draws(key, shape, steps: int):
    """The JAX sampler's draws for ``key``: initial noise ``[B, T]``, step noise ``[S, B, T]``."""
    key, init_key = jax.random.split(key)
    noise_keys = jax.random.split(key, steps)
    return (np.array(jax.random.normal(init_key, shape)),
            np.stack([np.array(jax.random.normal(k, shape)) for k in noise_keys]))


def _check(audio, sr, want, hop: int) -> None:
    assert sr == 4000
    assert tuple(audio.shape) == (2, hop * FRAMES)
    assert float(audio.abs().max()) <= 1.0
    np.testing.assert_allclose(audio.numpy(), np.asarray(want), atol=1e-4, rtol=0)


@pytest.mark.parametrize("fast,steps", [(True, 6), (False, 50)])
def test_diffwave_sample_matches_jax(fast, steps):
    jmodel, params, model = diffwave_pair(TINY)
    b = make_batch(TINY["n_mels"], TINY["hop_length"], seed=4)
    key = jax.random.key(5)
    want, sr = jax_samplers.diffwave_sample(jmodel, {"params": params}, b["con_spec"],
                                            b["label"], key, fast=fast)
    draws = _jax_draws(key, b["ref_audio"].shape, steps)
    audio, sr = samplers.diffwave_sample(model, b["con_spec"], b["label"], None, fast=fast,
                                         draws=draws)
    _check(audio, sr, want, TINY["hop_length"])


def test_wavegrad_sample_matches_jax():
    jmodel, params, model = make_wavegrad_pair()
    b = make_batch(128, 300, seed=4)
    key = jax.random.key(6)
    want, sr = jax_samplers.wavegrad_sample(jmodel, {"params": params}, b["con_spec"],
                                            b["label"], key, num_steps=3)
    audio, sr = samplers.wavegrad_sample(model, b["con_spec"], b["label"], None, num_steps=3,
                                         draws=_jax_draws(key, b["ref_audio"].shape, 3))
    _check(audio, sr, want, 300)


def test_sampler_takes_one_conditioner_and_a_generator():
    _, _, model = diffwave_pair(TINY)
    con = make_batch(TINY["n_mels"], TINY["hop_length"])["con_spec"][0]     # [n_mels, frames]
    runs = [samplers.diffwave_sample(model, con, 1, torch.Generator().manual_seed(0))
            for _ in range(2)]
    (audio, sr), (again, _) = runs
    assert sr == 4000 and tuple(audio.shape) == (1, TINY["hop_length"] * FRAMES)
    assert float(audio.abs().max()) <= 1.0 and torch.equal(audio, again)
    batch = torch.as_tensor(np.stack([con, con]))
    two, _ = samplers.diffwave_sample(model, batch, 1, torch.Generator().manual_seed(0))
    assert tuple(two.shape) == (2, TINY["hop_length"] * FRAMES)
    assert not torch.equal(two[0], two[1])                 # each row its own noise
