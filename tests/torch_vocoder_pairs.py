"""Shared fixtures of the generative tests (``tests/test_torch_{stft,diffusion,samplers,
generative_train,synthetic}.py``): the tiny DiffWave configs, seeded batches, JAX/port model
pairs on the same weights, the JAX loss strategies' own draws, and ``one_torch_thread``."""

from functools import lru_cache

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from wav2vec_heart_sounds_tpu.models.diffusion import diffwave as jax_diffwave
from wav2vec_heart_sounds_tpu.models.diffusion import wavegrad as jax_wavegrad
from wav2vec_heart_sounds_tpu_torch.models.diffusion import diffwave, wavegrad
from wav2vec_heart_sounds_tpu_torch.models.from_jax import from_jax, to_jax

@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Each test module that imports this fixture runs in one intra-op thread, restored after
    the module; being module-scoped and autouse, it also covers the module's other fixtures
    (WaveGrad's init among them). The suite runs in several workers on a few cores, where
    PyTorch's OpenMP threads spin against each other on these small shapes, and WaveGrad's
    orthogonal init in several threads took minutes a worker."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


TINY = dict(residual_layers=4, residual_channels=8, n_mels=16, hop_length=64, step_hidden=32)
ODD_HOP = dict(TINY, hop_length=75)
FRAMES, B = 4, 2


def make_batch(n_mels: int, hop: int, seed: int = 0, frames: int = FRAMES) -> dict:
    rng = np.random.default_rng(seed)
    return {"ref_audio": rng.normal(size=(B, hop * frames)).astype(np.float32) * 0.5,
            "con_spec": rng.uniform(0, 1, size=(B, n_mels, frames)).astype(np.float32),
            "label": np.asarray([0, 1], np.int32)}


def diffwave_pair(fields: dict, seed: int = 0):
    """(JAX module, its params with a drawn output projection, a fresh port model on them).
    The JAX side is built once a process for each (fields, seed): its init is jitted, and the
    JAX samplers cache their compiled loops by module."""
    jmodel, params = _jax_diffwave(tuple(sorted(fields.items())), seed)
    params = jax.tree_util.tree_map(np.array, params)
    model = diffwave.DiffWave(diffwave.DiffWaveConfig(**fields))
    model.load_state_dict(from_jax(params), strict=True)
    return jmodel, params, model


@lru_cache(maxsize=None)
def _jax_diffwave(fields: tuple, seed: int):
    jcfg = jax_diffwave.DiffWaveConfig(**dict(fields))
    jmodel = jax_diffwave.DiffWave(jcfg)
    b = make_batch(jcfg.n_mels, jcfg.hop_length)
    params = jax.device_get(jax.jit(jmodel.init)(
        jax.random.key(seed), jnp.asarray(b["ref_audio"]), jnp.zeros((B,), jnp.int32),
        jnp.asarray(b["con_spec"]), jnp.asarray(b["label"]))["params"])
    params = jax.tree_util.tree_map(np.asarray, params)
    rng = np.random.default_rng(seed + 7)
    out = params["output_projection"]
    out["kernel"] = rng.normal(size=out["kernel"].shape).astype(np.float32) * 0.3
    out["bias"] = np.asarray([0.05], np.float32)
    return jmodel, params


def make_wavegrad_pair():
    """(JAX module, params from the port's seeded init, the port's model)."""
    model = wavegrad.build_wavegrad(seed=3, device="cpu")
    for layer in (model.last_conv, *(f.output_conv for f in model.films)):   # biases not 0
        layer.bias.data.normal_(0.0, 0.1, generator=torch.Generator().manual_seed(4))
    jmodel = jax_wavegrad.WaveGrad(jax_wavegrad.WaveGradConfig())
    shapes = jax.eval_shape(jmodel.init, jax.random.key(0), jnp.zeros((1, 1200)),
                            jnp.zeros((1, 128, 4)), jnp.ones((1,)), jnp.zeros((1,), jnp.int32))
    like = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes["params"])
    params = to_jax(model.state_dict(), like)
    return jmodel, params, model


def jax_draws_diffwave(key, shape, steps):
    k_t, k_n = jax.random.split(key)
    return (np.array(jax.random.randint(k_t, (shape[0],), 0, steps)),
            np.array(jax.random.normal(k_n, shape)))


def jax_draws_wavegrad(key, shape, steps):
    k_s, k_u, k_n = jax.random.split(key, 3)
    return (np.array(jax.random.randint(k_s, (shape[0],), 1, steps + 1)),
            np.array(jax.random.uniform(k_u, (shape[0],))),
            np.array(jax.random.normal(k_n, shape)))
