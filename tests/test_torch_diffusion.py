"""The port's diffusion vocoders vs the JAX package's, on the CPU, on the same weights.

Schedules, fast-step alignment and posterior sigmas are numpy on both sides and must be
equal. DiffWave runs at ``tests/test_generative.py``'s tiny config and at an odd hop (75:
upsample factors 5 and 15, whose transposed convs give one extra column each), its weights
from the JAX init through ``from_jax``, the zero-init output projection replaced by a drawn
one so the output is not 0. WaveGrad has one width (15,956,161 parameters); its weights come
from the port's seeded init through ``to_jax`` (shapes from ``jax.eval_shape``, which costs
nothing, where the JAX init costs ~15 s), at T = 1200 and with one extra mel frame. Bars,
float32: the step embedding at 1e-5, forwards at 1e-4 absolute (and 1e-4 relative), both
losses at 1e-5 relative with the JAX strategy's own draws injected, and each parameter's
gradient within 1e-3 of its norm (the L2 norm of the difference). DiffWave's gradients sit
within 1e-6 of theirs; WaveGrad's float32 rounding, amplified through its U-net and FiLM
products, leaves some a few 1e-4 apart, as PyTorch alone differs by 1.6e-4 in a gradient norm
between the card and the CPU (``chip_smoke.py`` phase 18).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from wav2vec_heart_sounds_tpu.models.diffusion import diffwave as jax_diffwave
from wav2vec_heart_sounds_tpu.models.diffusion import samplers as jax_samplers
from wav2vec_heart_sounds_tpu.models.diffusion import schedules as jax_schedules
from wav2vec_heart_sounds_tpu.models.diffusion import wavegrad as jax_wavegrad
from wav2vec_heart_sounds_tpu.train import generative as jax_generative
from wav2vec_heart_sounds_tpu_torch.models.diffusion import diffwave, samplers, schedules
from wav2vec_heart_sounds_tpu_torch.models.diffusion import wavegrad
from wav2vec_heart_sounds_tpu_torch.models.from_jax import from_jax
from wav2vec_heart_sounds_tpu_torch.train import generative
from torch_vocoder_pairs import (ODD_HOP, TINY, diffwave_pair, jax_draws_diffwave,  # noqa: F401
                                 jax_draws_wavegrad, make_batch, make_wavegrad_pair,
                                 one_torch_thread)


@pytest.fixture(scope="module")
def wavegrad_pair():
    return make_wavegrad_pair()


def _close(got: torch.Tensor, want, atol: float, rtol: float, what: str) -> None:
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=atol, rtol=rtol,
                               err_msg=what)


@pytest.mark.parametrize("ours,theirs", [
    (diffwave.DiffWaveConfig(), jax_diffwave.DiffWaveConfig()),
    (wavegrad.WaveGradConfig(), jax_wavegrad.WaveGradConfig())], ids=["diffwave", "wavegrad"])
def test_schedules_equal_jax(ours, theirs):
    ours, theirs = ours.training_schedule(), theirs.training_schedule()
    assert ours.betas == theirs.betas
    for name in ("alphas", "alpha_cumprod", "training_noise_levels", "continuous_noise_levels"):
        a, b = getattr(ours, name), getattr(theirs, name)
        np.testing.assert_array_equal(*((a(), b()) if callable(a) else (a, b)), err_msg=name)


def test_alignment_sigmas_and_step_table_equal_jax():
    cfg = diffwave.DiffWaveConfig()
    infer = schedules.NoiseSchedule(tuple(cfg.inference_betas))
    jinfer = jax_schedules.NoiseSchedule(tuple(cfg.inference_betas))
    np.testing.assert_array_equal(
        samplers.align_fast_steps(cfg.training_schedule(), infer),
        jax_samplers.align_fast_steps(jax_diffwave.DiffWaveConfig().training_schedule(), jinfer))
    sched = wavegrad.WaveGradConfig().training_schedule()
    for order in (np.arange(1000)[::-1], np.asarray([999, 500, 0]), np.arange(6)[::-1]):
        np.testing.assert_array_equal(
            samplers._sigmas(sched.alpha_cumprod, np.asarray(sched.betas), order),
            jax_samplers._sigmas(sched.alpha_cumprod, np.asarray(sched.betas), order))
    for num_steps, dim in ((50, 128), (7, 16)):
        np.testing.assert_array_equal(schedules.step_embedding_table(num_steps, dim),
                                      jax_schedules.step_embedding_table(num_steps, dim))


@pytest.mark.parametrize("step", [np.asarray([0, 49, 7], np.int32),
                                  np.asarray([0.0, 3.25, 48.5], np.float32)])
def test_step_embedding_matches_jax(step):
    jmod = jax_schedules.DiffusionStepEmbedding(50, hidden=32)
    params = jax.device_get(jmod.init(jax.random.key(1), jnp.asarray(step))["params"])
    ours = schedules.DiffusionStepEmbedding(50, hidden=32)
    ours.load_state_dict({f"{name}.{key}": torch.tensor(np.asarray(params[name][leaf]).T)
                          for name in ("proj1", "proj2")
                          for key, leaf in (("weight", "kernel"), ("bias", "bias"))})
    want = jmod.apply({"params": params}, jnp.asarray(step))
    _close(ours(torch.as_tensor(step)), want, 1e-5, 1e-5, "step embedding")


def test_noise_level_encoding_matches_jax():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(3, 10, 64)).astype(np.float32)             # [B, T, C]
    level = rng.uniform(0, 1, 3).astype(np.float32)
    want = jax_schedules.noise_level_encoding(jnp.asarray(x), jnp.asarray(level))
    got = schedules.noise_level_encoding(torch.as_tensor(x).transpose(1, 2),
                                         torch.as_tensor(level))
    _close(got.transpose(1, 2), want, 1e-6, 1e-6, "noise level encoding")


@pytest.mark.parametrize("fields", [TINY, ODD_HOP], ids=["hop64", "hop75"])
@pytest.mark.parametrize("step_kind", ["int", "float"])
def test_diffwave_forward_matches_jax(fields, step_kind):
    jmodel, params, model = diffwave_pair(fields)
    if fields is ODD_HOP:
        assert model.config.upsample_factors() == (5, 15)
    b = make_batch(fields["n_mels"], fields["hop_length"], seed=1)
    step = (np.asarray([3, 41], np.int32) if step_kind == "int"
            else np.asarray([0.5, 37.25], np.float32))
    want = jmodel.apply({"params": params}, jnp.asarray(b["ref_audio"]), jnp.asarray(step),
                        jnp.asarray(b["con_spec"]), jnp.asarray(b["label"]))
    got = model(torch.as_tensor(b["ref_audio"]), torch.as_tensor(step),
                torch.as_tensor(b["con_spec"]), torch.as_tensor(b["label"]).long())
    assert got.shape == b["ref_audio"].shape and float(np.abs(np.asarray(want)).max()) > 0.1
    _close(got, want, 1e-4, 1e-4, "DiffWave forward")


@pytest.mark.parametrize("extra_frame", [False, True])
def test_wavegrad_forward_matches_jax(wavegrad_pair, extra_frame):
    jmodel, params, model = wavegrad_pair
    b = make_batch(128, 300, seed=2)
    con = b["con_spec"]
    if extra_frame:                  # a centred STFT's extra frame: cropped to T // hop
        con = np.concatenate([con, con[:, :, :1]], axis=2)
    level = np.asarray([0.3, 0.9], np.float32)
    want = jax.jit(jmodel.apply)({"params": params}, jnp.asarray(b["ref_audio"]),
                                 jnp.asarray(con), jnp.asarray(level), jnp.asarray(b["label"]))
    got = model(torch.as_tensor(b["ref_audio"]), torch.as_tensor(con), torch.as_tensor(level),
                torch.as_tensor(b["label"]).long())
    assert got.shape == b["ref_audio"].shape and float(np.abs(np.asarray(want)).max()) > 0.1
    _close(got, want, 1e-4, 1e-4, "WaveGrad forward")


def test_wavegrad_trees_round_trip(wavegrad_pair):
    _, params, model = wavegrad_pair
    back = from_jax(params)
    assert back.keys() == model.state_dict().keys()
    for key, value in model.state_dict().items():
        assert torch.equal(back[key], value), key


@pytest.mark.parametrize("mode,matches", [("nearest-exact", True), ("nearest", False)])
def test_nearest_exact_is_the_jax_resize(wavegrad_pair, monkeypatch, mode, matches):
    """``jax.image.resize(method="nearest")`` is torch's ``nearest-exact``: at 23 -> 11 and
    23 -> 7 (the DBlocks' ``T // factor``) torch's default ``nearest`` picks other samples,
    while at 23 -> 46 and 23 -> 115 all agree. A WaveGrad built on ``nearest`` runs, and
    misses the forward's bar."""
    interpolate = torch.nn.functional.interpolate

    def resize_as(x, size, mode=None):
        return interpolate(x, size=size, mode=mode_built)

    mode_built = mode
    monkeypatch.setattr(wavegrad.F, "interpolate", resize_as)
    x = np.random.default_rng(5).normal(size=(2, 23, 3)).astype(np.float32)   # [B, T, C]
    same = []
    for size in (11, 7, 46, 115):
        want = jax_wavegrad._resize(jnp.asarray(x), size)
        got = wavegrad._resize(torch.as_tensor(x).transpose(1, 2), size).transpose(1, 2)
        same.append(np.array_equal(got.numpy(), np.asarray(want)))
    assert same == ([True] * 4 if matches else [False, False, True, True])
    jmodel, params, model = wavegrad_pair
    b = make_batch(128, 300, seed=2)
    level = np.asarray([0.3, 0.9], np.float32)
    want = jax.jit(jmodel.apply)({"params": params}, *(jnp.asarray(v) for v in (
        b["ref_audio"], b["con_spec"], level, b["label"])))
    got = model(*(torch.as_tensor(v) for v in (b["ref_audio"], b["con_spec"], level,
                                               b["label"].astype(np.int64))))
    assert np.allclose(got.detach().numpy(), np.asarray(want), atol=1e-4, rtol=1e-4) == matches


def _grads_match(model, jgrads, what):
    want = from_jax(jax.tree_util.tree_map(np.asarray, jgrads))
    for name, p in model.named_parameters():
        gap = float((p.grad - want[name]).norm() / want[name].norm())
        assert gap <= 1e-3, f"{what} {name}: gradient {gap:.3e} of its norm away"


@pytest.mark.parametrize("which", ["diffwave", "wavegrad"])
def test_loss_and_gradients_match_jax(which, request):
    if which == "diffwave":
        jmodel, params, model = diffwave_pair(TINY)
        b = make_batch(TINY["n_mels"], TINY["hop_length"], seed=3)
        draws = jax_draws_diffwave(jax.random.key(11), b["ref_audio"].shape, 50)
        jloss, ploss = jax_generative.diffwave_loss, generative.diffwave_loss
    else:
        jmodel, params, model = request.getfixturevalue("wavegrad_pair")
        b = make_batch(128, 300, seed=3)
        draws = jax_draws_wavegrad(jax.random.key(11), b["ref_audio"].shape, 1000)
        jloss, ploss = jax_generative.wavegrad_loss, generative.wavegrad_loss
    batch = {k: jnp.asarray(v) for k, v in b.items()}
    want, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jloss(jmodel, p, batch, jax.random.key(11))))(params)
    model.zero_grad()
    got = ploss(model, {k: torch.as_tensor(v).long() if k == "label" else torch.as_tensor(v)
                        for k, v in b.items()}, None, draws)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    _grads_match(model, jgrads, which)
