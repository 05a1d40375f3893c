"""K7 and the beamformer: the port's plain versions and modules vs the JAX package.

``delay_channel`` on CPU tensors runs the plain forward and the plain analytic backward
(the formulas of ``csrc/sinc_delay.cu``: ``dd``, ``dx`` over the padded axis, the fold of
the reflect padding). They are held to the Pallas kernel in interpret mode and to the
JAX package's materialised reference, and to the port's own materialised reference under
autograd, with integer delays included (the ``|z| < 1e-6`` branch of ``sinc'``). Bars as
``tests/test_pallas_beamformer.py``: forward 1e-5, ``dd`` and ``dx`` atol 2e-4 / rtol 1e-3.

``DelayPredictor`` and ``TimeVaryingSincBeamformer`` run against the JAX modules on
weights carried over by ``from_jax`` (3 microphones, T = 600, float32, delays inside the
taps): atol 1e-4 on the delays and the output, and on the input gradient (up to ~300) atol
1e-5 of its largest value, rtol 1e-3 (two attention layers, 41-tap sums and ``sinc'``'s
cancellation near integer delays, in other orders).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from wav2vec_heart_sounds_tpu.models.beamformer import DelayPredictor as JaxDelayPredictor
from wav2vec_heart_sounds_tpu.models.beamformer import (
    TimeVaryingSincBeamformer as JaxBeamformer)
from wav2vec_heart_sounds_tpu.models.classifier import ClassifierConfig as JaxClassifierConfig
from wav2vec_heart_sounds_tpu.models.classifier import Wav2VecClassifier as JaxClassifier
from wav2vec_heart_sounds_tpu.models.wav2vec2 import Wav2Vec2Config as JaxConfig
from wav2vec_heart_sounds_tpu.ops.pallas import beamformer as jax_bf
from wav2vec_heart_sounds_tpu_torch.models.build import build_classifier
from wav2vec_heart_sounds_tpu_torch.models.classifier import ClassifierConfig
from wav2vec_heart_sounds_tpu_torch.models.from_jax import from_jax
from wav2vec_heart_sounds_tpu_torch.models.wav2vec2 import Wav2Vec2Config
from wav2vec_heart_sounds_tpu_torch.ops.kernels import sinc_delay

K = 41
WINDOW = tuple(float(w) for w in np.hamming(K).astype(np.float32))
M, T, FS = 3, 600, 4125


def _inputs(rows=3, t=300, seed=0, high=20.0):
    """Delays uniform in [0, high] with 15% integers (0 included)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(rows, t)).astype(np.float32)
    d = rng.uniform(0.0, high, size=(rows, t)).astype(np.float32)
    hit = rng.random((rows, t)) < 0.15
    d[hit] = rng.integers(0, int(high) + 1, size=int(hit.sum())).astype(np.float32)
    g = rng.normal(size=(rows, t)).astype(np.float32)
    return x, d, g


def _port_grads(fn, x, d, g):
    xt, dt = (torch.from_numpy(a).requires_grad_() for a in (x, d))
    y = fn(xt, dt, K, WINDOW)
    y.backward(torch.from_numpy(g))
    return y.detach().numpy(), xt.grad.numpy(), dt.grad.numpy()


def _jax_grads(fn, x, d, g):
    y, vjp = jax.vjp(fn, jnp.asarray(x), jnp.asarray(d))
    gx, gd = vjp(jnp.asarray(g))
    return np.asarray(y), np.asarray(gx), np.asarray(gd)


@pytest.mark.parametrize("seed", [0, 1])
def test_plain_sinc_delay_matches_jax(seed):
    x, d, g = _inputs(seed=seed)
    ours = _port_grads(sinc_delay.delay_channel, x, d, g)
    kernel = _jax_grads(lambda a, b: jax_bf.sinc_delay(a, b, K, WINDOW, True), x, d, g)
    reference = _jax_grads(lambda a, b: jax_bf.delay_channel_reference(
        a, b, K, jnp.asarray(WINDOW, jnp.float32)), x, d, g)
    port_reference = _port_grads(sinc_delay.delay_channel_reference, x, d, g)
    for theirs in (kernel, reference, port_reference):
        np.testing.assert_allclose(ours[0], theirs[0], atol=1e-5)
        np.testing.assert_allclose(ours[1], theirs[1], atol=2e-4, rtol=1e-3)   # dx
        np.testing.assert_allclose(ours[2], theirs[2], atol=2e-4, rtol=1e-3)   # dd


def test_delays_beyond_the_taps_match_float64():
    """Delays in [20.5, 41.25] (integers included): the factor-free form against the
    JAX package's materialised form in float64, at integer delays (float32: 0 / 0) against
    its float64 value 1e-9 away. Past the taps the weights alternate in sign and their sum
    nearly cancels (|y| reaches ~70 for unit inputs), so the bars scale with the largest
    value: atol 2e-4 of it, rtol 1e-3. ``dd`` at the integers is a limit that float64
    cannot take either; it is checked finite."""
    x, d, g = _inputs(seed=3)
    rng = np.random.default_rng(4)
    d = rng.uniform(20.5, 41.25, size=d.shape).astype(np.float32)
    hit = rng.random(d.shape) < 0.15
    d[hit] = rng.integers(21, 42, size=int(hit.sum())).astype(np.float32)
    ours = _port_grads(sinc_delay.delay_channel, x, d, g)
    assert all(np.isfinite(a).all() for a in ours)
    d64 = torch.from_numpy(d).double()
    d64 = torch.where(d64 == torch.round(d64), d64 + 1e-9, d64)

    def f64(a, b, k, w):
        return sinc_delay.delay_channel_reference(a.double(), b.double(), k, w)

    xt = torch.from_numpy(x).double().requires_grad_()
    dt = d64.requires_grad_()
    y = f64(xt, dt, K, WINDOW)
    y.backward(torch.from_numpy(g).double())
    refs = (y.detach().numpy(), xt.grad.numpy(), dt.grad.numpy()[~hit])
    for got, ref in zip((ours[0], ours[1], ours[2][~hit]), refs):
        np.testing.assert_allclose(got, ref, atol=2e-4 * np.abs(ref).max(), rtol=1e-3)


@pytest.mark.parametrize("seed", [5, 6])
def test_plain_forward_beyond_the_taps_is_float64_rounded_once(seed):
    """Delays beyond the taps (|round(d)| > 20, up to the beamformer's 41.25 samples, with
    integers), unit-normal rows, as the card's K7 checks draw them. There the weights
    alternate in sign and their sum cancels (condition factor ~100-300), and the elements
    that missed the card's 1e-5 / 1e-5 bar were small |y|. The plain forward (float64 weights
    and sums beyond the taps, one rounding) must give y and s within one float32 ulp of the
    same function evaluated in float64 (float64 copies of x and d, the same taps) at every
    such sample, the smallest |y| included."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(size=(4, 2000)).astype(np.float32))
    d = rng.uniform(20.5, 41.25, size=x.shape).astype(np.float32)
    hit = rng.random(d.shape) < 0.05
    d[hit] = rng.integers(21, 42, size=int(hit.sum())).astype(np.float32)
    d = torch.from_numpy(d)
    y, s = sinc_delay.sinc_fwd_reference(x, d, WINDOW)
    y64, s64 = sinc_delay.sinc_fwd_reference(x.double(), d.double(), WINDOW)
    assert y.dtype == s.dtype == torch.float32 and y64.dtype == torch.float64
    small = y64.abs() < 1.0
    assert small.sum() > 100                                  # the elements that missed
    for got, ref in ((y, y64), (s, s64)):
        ulp = np.spacing(ref.abs().float().numpy())
        assert (np.abs(got.double().numpy() - ref.numpy()) <= ulp).all()


def test_entry_points_and_fold():
    """Forward ``(y, s)``, ``grad_d`` and ``grad_x`` + fold, one by one, vs the JAX kernels'
    pieces (``_norm_sum`` for s)."""
    x, d, g = _inputs(rows=2, t=257, seed=2)
    xt, dt, gt = map(torch.from_numpy, (x, d, g))
    y, s = sinc_delay.sinc_fwd_reference(xt, dt, WINDOW)
    xpad = jnp.pad(jnp.asarray(x), [(0, 0), (K // 2, K // 2)], mode="reflect")
    np.testing.assert_allclose(s.numpy(), np.asarray(jax_bf._norm_sum(xpad, jnp.asarray(d), K,
                                                                      WINDOW)), atol=1e-5)
    gx, gd = jax_bf._sinc_delay_bwd(K, WINDOW, True, (jnp.asarray(x), jnp.asarray(d)),
                                    jnp.asarray(g))
    dd = sinc_delay.sinc_grad_d_reference(xt, dt, gt, WINDOW)
    dxpad = sinc_delay.sinc_grad_x_reference(dt, gt, s, WINDOW)
    assert dxpad.shape == (2, 257 + K - 1)
    np.testing.assert_allclose(dd.numpy(), np.asarray(gd), atol=2e-4, rtol=1e-3)
    np.testing.assert_allclose(sinc_delay.fold_reflect(dxpad, K // 2).numpy(), np.asarray(gx),
                               atol=2e-4, rtol=1e-3)


def test_zero_and_integer_delays():
    x, _, _ = _inputs(rows=1, t=300, seed=3)
    xt = torch.from_numpy(x)
    y = sinc_delay.delay_channel(xt, torch.zeros_like(xt), K, WINDOW)
    torch.testing.assert_close(y, xt, atol=1e-5, rtol=0)
    y = sinc_delay.delay_channel(xt, torch.full_like(xt, 7.0), K, WINDOW)
    torch.testing.assert_close(y[:, :250], xt[:, 7:257], atol=1e-5, rtol=0)


def test_kernel_wrappers_refuse_cpu_tensors():
    x = torch.zeros(2, 100)
    with pytest.raises(ValueError, match="CUDA"):
        sinc_delay.sinc_fwd_kernel(x, x, WINDOW)
    with pytest.raises(ValueError, match="taps"):
        sinc_delay.delay_channel(x, x, K - 1, WINDOW)


def test_window_arg_is_built_once_per_window():
    """The taps' ctypes array is cached per window (a tuple is its own key), float32-rounded
    as the plain version's taps; an even tap count is refused."""
    taps, count = sinc_delay._window_arg(WINDOW)
    assert count == K and list(taps) == sinc_delay._taps(WINDOW)
    again = sinc_delay._window_arg(tuple(sinc_delay._taps(WINDOW)))
    assert again[0] is sinc_delay._window_arg(tuple(sinc_delay._taps(WINDOW)))[0]
    assert list(again[0]) == list(taps)
    with pytest.raises(ValueError, match="odd number of taps"):
        sinc_delay._window_arg((0.5, 1.0))


@pytest.fixture(scope="module")
def vest_pair():
    """A JAX multichannel classifier (tiny encoder) and the port's, on the same weights;
    the delay predictor's output bias is raised so most delays land inside the taps
    (0 to 20 samples, where the JAX package's float32 form is well conditioned)."""
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, T, M)).astype(np.float32)
    jcfg = JaxClassifierConfig(num_channels=M, head_hidden=(8,), random_init=True, fs=FS,
                               encoder=JaxConfig.tiny())
    params = jax.device_get(JaxClassifier(jcfg).init(jax.random.key(5), jnp.asarray(x)))["params"]
    out = params["channel_mixer"]["delay_predictor"]["output_proj"]
    out["bias"] = np.asarray(9.0 + 2.0 * rng.normal(size=out["bias"].shape), np.float32)
    out["kernel"] = np.asarray(out["kernel"]) * 3.0
    model = build_classifier(ClassifierConfig(num_channels=M, head_hidden=(8,), fs=FS,
                                              random_init=True, encoder=Wav2Vec2Config.tiny()),
                             device="cpu")
    model.load_state_dict(from_jax(params), strict=True)
    return params, model, np.swapaxes(x, 1, 2)               # [B, M, T]


def test_delay_predictor_matches_jax(vest_pair):
    params, model, x = vest_pair
    ref = JaxDelayPredictor(M).apply({"params": params["channel_mixer"]["delay_predictor"]},
                                     jnp.asarray(x))
    with torch.no_grad():
        got = model.channel_mixer.delay_predictor(torch.from_numpy(x))
    assert got.shape == (2, M, T)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4)
    ref = np.asarray(ref)
    assert 0.0 < ref.min() and ref.max() < 20.0                  # live, inside the taps


def test_beamformer_matches_jax_with_input_gradient(vest_pair):
    params, model, x = vest_pair
    g = np.random.default_rng(6).normal(size=(2, T)).astype(np.float32)
    module = JaxBeamformer(M, FS)
    ref, vjp = jax.vjp(lambda a: module.apply({"params": params["channel_mixer"]}, a),
                       jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    got = model.channel_mixer(xt)
    got.backward(torch.from_numpy(g))
    assert got.dtype == torch.float32 and got.shape == (2, T)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), atol=1e-4, rtol=1e-4)
    want = np.asarray(vjp(jnp.asarray(g))[0])
    np.testing.assert_allclose(xt.grad.numpy(), want, atol=1e-5 * np.abs(want).max(), rtol=1e-3)


def test_bf16_delays_round_before_the_float32_delay():
    """bfloat16 compute: the predictor's delays come out in bfloat16 (a 0.25-sample step
    near 40), K7 and the sum of squares stay float32."""
    model = build_classifier(ClassifierConfig(num_channels=M, head_hidden=(8,), fs=FS,
                                              random_init=True, encoder=Wav2Vec2Config.tiny()),
                             device="cpu", dtype=torch.bfloat16)
    x = torch.from_numpy(np.random.default_rng(7).normal(size=(2, M, T)).astype(np.float32))
    with torch.no_grad():
        delays = model.channel_mixer.delay_predictor(x)
        out = model.channel_mixer(x)
    assert delays.dtype == torch.bfloat16 and out.dtype == torch.float32
    assert bool(torch.isfinite(out).all())
