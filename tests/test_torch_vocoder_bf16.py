"""The vocoders at a bfloat16 compute dtype keep float32 parameters, as flax's ``dtype=`` does.

``build_diffwave`` / ``build_wavegrad(..., dtype=torch.bfloat16)`` against the JAX modules
built with ``dtype=jnp.bfloat16`` (``param_dtype`` float32) on the same float32 weights
(``from_jax``): every port parameter is float32 after the build and after one
``GenerativeTrainer.train_step``; the bf16 forwards agree; and one trainer step of the tiny
DiffWave (the JAX trainer's own draws injected) moves every parameter as the JAX trainer
does. Stored in bf16, a parameter of order 0.1 has an ulp of ~5e-4, so Adam's first step of
~lr = 2e-4 would round to 0 or to one ulp.

Bars, measured on a CPU, with a margin: both sides round to bf16 at each layer's output,
at slightly different points. The forwards within 6e-2 of the JAX output's largest value
(measured: DiffWave 1.4e-2, WaveGrad 3.3e-2; each side's bf16 forward is itself 1.2e-2 and
3.2e-2 from its float32 forward). The loss at 1e-3 relative (measured 2.4e-5). Each
parameter's update within 5e-2 of the JAX update's norm, both weighted element by element by
the JAX gradient's magnitude (``|mu|``, Adam's first moment): measured 1.1e-2 at most, and
0.96-1.0 when the parameters are stored in bf16, which rounds the update away. The weight is
there because Adam's first update is lr * sign(g): where the two bf16 gradients are too near
0 to agree on a sign the element moves the other way (one such element of a 16-element bias
gives an unweighted L2 gap of 0.5).
"""

import numpy as np
import jax
import jax.numpy as jnp
import optax
import torch

from wav2vec_heart_sounds_tpu.models.diffusion import diffwave as jax_diffwave
from wav2vec_heart_sounds_tpu.models.diffusion import wavegrad as jax_wavegrad
from wav2vec_heart_sounds_tpu.train import generative as jax_generative
from wav2vec_heart_sounds_tpu_torch.models.diffusion import diffwave, wavegrad
from wav2vec_heart_sounds_tpu_torch.models.from_jax import from_jax, to_jax
from wav2vec_heart_sounds_tpu_torch.train import generative
from torch_vocoder_pairs import (TINY, diffwave_pair, jax_draws_diffwave,  # noqa: F401
                                 jax_draws_wavegrad, make_batch, make_wavegrad_pair,
                                 one_torch_thread)

FORWARD_BAR, LOSS_BAR, UPDATE_BAR = 6e-2, 1e-3, 5e-2


def _bf16_diffwave():
    """(the JAX bf16 DiffWave, its float32 params, the port's bf16 DiffWave on them)."""
    _, params, _ = diffwave_pair(TINY)
    jmodel = jax_diffwave.DiffWave(jax_diffwave.DiffWaveConfig(**TINY), dtype=jnp.bfloat16)
    model = diffwave.build_diffwave(diffwave.DiffWaveConfig(**TINY), device="cpu",
                                    dtype=torch.bfloat16)
    model.load_state_dict(from_jax(params), strict=True)
    return jmodel, params, model


def _adam_first_moment(opt_state):
    (adam,) = [s for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda s: isinstance(s, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)]
    return adam.mu


def _all_float32(model) -> list[str]:
    return [n for n, p in model.named_parameters() if p.dtype != torch.float32]


def test_diffwave_bf16_forward_and_parameters_match_jax():
    jmodel, params, model = _bf16_diffwave()
    assert _all_float32(model) == []
    b = make_batch(TINY["n_mels"], TINY["hop_length"], seed=4)
    step = np.asarray([3, 41], np.int32)
    want = np.asarray(jmodel.apply({"params": params}, jnp.asarray(b["ref_audio"]),
                                   jnp.asarray(step), jnp.asarray(b["con_spec"]),
                                   jnp.asarray(b["label"])), np.float32)
    with torch.no_grad():
        got = model(torch.from_numpy(b["ref_audio"]), torch.from_numpy(step).long(),
                    torch.from_numpy(b["con_spec"]), torch.from_numpy(b["label"]).long())
    assert got.dtype == torch.float32                  # the out-projection is float32
    scale = np.abs(want).max()
    assert scale > 0.1 and np.abs(got.numpy() - want).max() <= FORWARD_BAR * scale


def test_wavegrad_bf16_forward_and_parameters_match_jax(tmp_path):
    _, params, model32 = make_wavegrad_pair()
    jmodel = jax_wavegrad.WaveGrad(jax_wavegrad.WaveGradConfig(), dtype=jnp.bfloat16)
    model = wavegrad.build_wavegrad(seed=5, device="cpu", dtype=torch.bfloat16)
    model.load_state_dict(model32.state_dict(), strict=True)
    assert _all_float32(model) == []
    rng = np.random.default_rng(6)
    audio = (0.5 * rng.normal(size=(2, 1200))).astype(np.float32)
    con = rng.uniform(0, 1, (2, 128, 4)).astype(np.float32)
    level, label = np.asarray([0.3, 0.9], np.float32), np.asarray([0, 1], np.int32)
    want = np.asarray(jmodel.apply({"params": params}, *map(jnp.asarray, (audio, con, level,
                                                                           label))), np.float32)
    with torch.no_grad():
        got = model(*map(torch.from_numpy, (audio, con, level)), torch.from_numpy(label).long())
    assert got.dtype == torch.float32                  # last_conv is float32
    scale = np.abs(want).max()
    assert scale > 0.1 and np.abs(got.numpy() - want).max() <= FORWARD_BAR * scale

    trainer = generative.GenerativeTrainer(model, generative.wavegrad_loss, str(tmp_path),
                                           log=lambda line: None)
    batch = {"ref_audio": audio, "con_spec": con, "label": label}
    assert np.isfinite(trainer.train_step(batch, jax_draws_wavegrad(jax.random.key(7),
                                                                    audio.shape, 1000)))
    assert _all_float32(model) == []


def test_one_train_step_updates_float32_parameters_as_jax(tmp_path):
    jmodel, params, model = _bf16_diffwave()
    before = {n: p.detach().float().clone() for n, p in model.named_parameters()}
    theirs = jax_generative.GenerativeTrainer(jmodel, {"params": params},
                                              jax_generative.diffwave_loss,
                                              str(tmp_path / "jax"), seed=3, log=lambda s: None)
    ours = generative.GenerativeTrainer(model, generative.diffwave_loss, str(tmp_path / "port"),
                                        seed=3, log=lambda s: None)
    batch = make_batch(TINY["n_mels"], TINY["hop_length"], seed=8)
    _, sub = jax.random.split(jax.random.key(3))      # the JAX trainer's first key
    draws = jax_draws_diffwave(sub, batch["ref_audio"].shape, 50)
    want_loss = theirs.train_step(batch)
    got_loss = ours.train_step(batch, draws)
    np.testing.assert_allclose(got_loss, want_loss, rtol=LOSS_BAR)
    assert _all_float32(model) == []
    trained = jax.device_get(theirs.params)
    weights = jax.device_get(_adam_first_moment(theirs.opt_state))
    start, ported = to_jax(before, trained), to_jax(model.state_dict(), trained)
    for path, after in jax.tree_util.tree_leaves_with_path(trained):
        got, begin, weight = ported, start, weights
        for k in path:
            got, begin, weight = got[k.key], begin[k.key], weight[k.key]
        want = np.asarray(after) - np.asarray(begin)
        weight = np.abs(np.asarray(weight))
        gap = np.sum(weight * np.abs(np.asarray(got) - np.asarray(begin) - want)) \
            / np.sum(weight * np.abs(want))
        assert gap <= UPDATE_BAR, (jax.tree_util.keystr(path), gap)
