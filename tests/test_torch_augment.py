"""On-device augmentation: ``augment/torchaug.py`` vs the JAX package's ``augment/jaxaug.py``.

The two draw from different generators, so each JAX transform runs with its random draws
injected: ``jax.random`` inside ``jaxaug`` is replaced by a stub that hands out, in call
order, the same unit draws the port's ``draws`` dict carries. Each transform's
deterministic core (the two standalone transforms, ``baseline_wander`` and ``amplitude_warp``,
too) then agrees within 1e-5 (float32; the EQ's partial fractions are
float64 host math in the port and float32 in JAX), and so does the whole stage
composition. Rows that do not participate are bit-identical to the input, and the
participation fraction under ``pristine_prob`` stays within four binomial standard
deviations. The first-order band-pass design and the dynamic biquad are held to SciPy.
"""

import types

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from scipy import signal as sps

from wav2vec_heart_sounds_tpu.augment import jaxaug
from wav2vec_heart_sounds_tpu.ops import iir as jax_iir
from wav2vec_heart_sounds_tpu_torch.augment import torchaug
from wav2vec_heart_sounds_tpu_torch.augment.pipelines import AugmentConfig
from wav2vec_heart_sounds_tpu_torch.ops import iir

B, T, FS = 5, 800, 4000


class _InjectedRandom:
    """``jax.random`` for ``jaxaug``: every draw comes from a queue, in call order."""

    def __init__(self, values):
        self.values = list(values)

    def split(self, key, num=2):
        return [key] * num

    def fold_in(self, key, data):
        return key

    def uniform(self, key, shape=(), dtype=jnp.float32, minval=0.0, maxval=1.0):
        u = jnp.asarray(self.values.pop(0), dtype).reshape(shape)
        return minval + u * (maxval - minval)

    def choice(self, key, a):
        return a[self.values.pop(0)]

    def normal(self, key, shape=(), dtype=jnp.float32):
        return jnp.asarray(self.values.pop(0), dtype).reshape(shape)


@pytest.fixture
def inject(monkeypatch):
    def install(values):
        stub = _InjectedRandom(values)
        monkeypatch.setattr(jaxaug, "jax", types.SimpleNamespace(random=stub, lax=jax.lax))
        return stub

    return install


def _x(seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(T) / FS
    return (np.sin(2 * np.pi * rng.uniform(30, 200, size=(B, 1)) * t)
            + 0.1 * rng.normal(size=(B, T))).astype(np.float32)


def _noise(rng):
    return {"gate": rng.random(B, dtype=np.float32), "std": int(rng.integers(0, 3)),
            "scale": rng.random(B, dtype=np.float32),
            "normal": rng.normal(size=(B, T)).astype(np.float32)}


def _envelope(rng):
    return {"gate": rng.random(B, dtype=np.float32),
            **{k: rng.random((2, B), dtype=np.float32) for k in ("amp", "freq", "phase")}}


def _eq(rng):
    return {"gate": rng.random(B, dtype=np.float32),
            "low": rng.random(torchaug.EQ_BANDS, dtype=np.float32),
            "high": rng.random(torchaug.EQ_BANDS, dtype=np.float32)}


def _queue(stage, d):
    """The stage's draws in ``jaxaug``'s call order (the gate last: ``_apply`` runs after
    the transform it blends)."""
    if stage in ("noise1", "noise2"):
        return [d["std"], d["scale"].reshape(B, 1), d["normal"], d["gate"].reshape(B, 1)]
    if stage == "envelope":
        return [d[k][i].reshape(B, 1) for i in range(2) for k in ("amp", "freq", "phase")] \
            + [d["gate"].reshape(B, 1)]
    return [v for i in range(torchaug.EQ_BANDS) for v in (d["low"][i], d["high"][i])] \
        + [d["gate"].reshape(B, 1)]


def _torch(d):
    return {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v for k, v in d.items()}


def _close(got, want, atol=1e-5):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol, rtol=0)


def test_white_noise_core(inject):
    x, d = _x(), _noise(np.random.default_rng(1))
    inject(_queue("noise1", d)[:3])
    _close(torchaug.add_white_noise(torch.from_numpy(x), _torch(d)),
           jaxaug.add_white_noise(None, jnp.asarray(x)))


def test_sinusoidal_envelope_core(inject):
    x, d = _x(1), _envelope(np.random.default_rng(2))
    inject(_queue("envelope", d)[:-1])
    _close(torchaug.sinusoidal_envelope(torch.from_numpy(x), FS, _torch(d)),
           jaxaug.sinusoidal_envelope(None, jnp.asarray(x), FS))


@pytest.mark.parametrize("fs", [FS, 1000])
def test_parametric_eq_core(inject, fs):
    x, d = _x(2), _eq(np.random.default_rng(3))
    inject(_queue("eq", d)[:-1])
    _close(torchaug.parametric_eq(torch.from_numpy(x), fs, _torch(d)),
           jaxaug.parametric_eq(None, jnp.asarray(x), fs, *torchaug.EQ_RANGE))


def test_baseline_wander_core(inject):
    x, d = _x(7), _envelope(np.random.default_rng(8))
    inject(_queue("envelope", d)[:-1])
    _close(torchaug.baseline_wander(torch.from_numpy(x), FS, _torch(d)),
           jaxaug.baseline_wander(None, jnp.asarray(x), FS))


@pytest.mark.parametrize("num_points,kernel", [(12, 65), (5, 33)])
def test_amplitude_warp_core(inject, num_points, kernel):
    x = _x(9)
    amps = np.random.default_rng(10).random((B, num_points), dtype=np.float32)
    inject([amps])
    _close(torchaug.amplitude_warp(torch.from_numpy(x), {"amps": torch.from_numpy(amps)},
                                   num_points, kernel),
           jaxaug.amplitude_warp(None, jnp.asarray(x), num_points, kernel))


def test_blend_core(inject):
    x, y = _x(3), _x(4)
    gate = np.random.default_rng(4).random(B, dtype=np.float32)
    inject([gate.reshape(B, 1)])
    _close(torchaug._blend(torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(gate), 0.5),
           jaxaug._apply(None, jnp.asarray(x), jnp.asarray(y), 0.5))


@pytest.mark.parametrize("pristine", [None, 0.25])
def test_whole_batch_matches_the_jax_composition(inject, pristine):
    """Every stage on (the EQ at probability 1, the envelope at 0.75, noise at 0.3 / 4 with
    its gates forced open on two rows), then participation: the port's core vs
    ``jaxaug``'s jitted body with the same draws."""
    cfg = AugmentConfig(prob_banding=1.0)
    rng = np.random.default_rng(5)
    x = _x(5)
    draws = {"noise1": _noise(rng), "envelope": _envelope(rng), "eq": _eq(rng),
             "noise2": _noise(rng)}
    for stage in ("noise1", "noise2"):
        draws[stage]["gate"][:2] = 0.0                     # two rows take the noise
    queue = [v for stage in ("noise1", "envelope", "eq", "noise2")
             for v in _queue(stage, draws[stage])]
    port_draws = {k: _torch(v) for k, v in draws.items()}
    if pristine is not None:
        u = rng.random(B, dtype=np.float32)
        u[0], u[1] = 0.1, 0.9                              # one pristine row, one augmented
        queue.append(u)
        port_draws["participate"] = torch.from_numpy(u >= pristine)
    inject(queue)
    want = jaxaug._augment_pcg_batch.__wrapped__(None, jnp.asarray(x), FS, cfg.prob_noise,
                                                 cfg.prob_wandering_volume, cfg.prob_banding)
    if pristine is not None:
        part = jaxaug._participation(None, B, None, pristine)
        want = jnp.where(part[:, None], want, jnp.asarray(x))
    got = torchaug.apply_pcg_batch(torch.from_numpy(x), FS, cfg, port_draws)
    _close(got, want)
    if pristine is not None:
        keep = ~port_draws["participate"]
        assert bool(keep.any()) and torch.equal(got[keep], torch.from_numpy(x)[keep])


def test_non_participating_rows_pass_through_bit_identically():
    x = torch.from_numpy(_x(6)) * 3.0                     # not normalised: a change would show
    row_mask = torch.tensor([1.0, 0.0, 1.0, 0.0, 0.0])
    y = torchaug.augment_pcg_batch(torch.Generator().manual_seed(0), x, FS,
                                   AugmentConfig(prob_noise=1.0), row_mask=row_mask)
    off = row_mask < 0.5
    assert torch.equal(y[off], x[off])
    assert not torch.equal(y[~off], x[~off]) and float(y[~off].abs().max()) <= 1.0


def test_participation_fraction_is_binomial():
    rows, p = 4000, 0.25
    x = torch.from_numpy(np.random.default_rng(7).normal(size=(rows, 64)).astype(np.float32))
    gen = torch.Generator().manual_seed(1)
    y = torchaug.augment_pcg_batch(gen, x, FS, AugmentConfig(), pristine_prob=p)
    pristine = (y == x).all(dim=1).float().mean().item()
    assert abs(pristine - p) <= 4 * np.sqrt(p * (1 - p) / rows)


def test_draws_come_in_a_fixed_order_from_the_generator():
    x = torch.from_numpy(_x(8))
    cfg = AugmentConfig()
    a = torchaug.augment_pcg_batch(torch.Generator().manual_seed(3), x, FS, cfg)
    b = torchaug.augment_pcg_batch(torch.Generator().manual_seed(3), x, FS, cfg)
    c = torchaug.augment_pcg_batch(torch.Generator().manual_seed(4), x, FS, cfg)
    assert torch.equal(a, b) and not torch.equal(a, c)
    off = AugmentConfig(prob_noise=0.0, prob_wandering_volume=0.0, prob_banding=0.0)
    draws = torchaug.draw_pcg_batch(torch.Generator(), B, T, "cpu", off)
    assert draws == {}                                     # zero-probability stages draw nothing


@pytest.mark.parametrize("low,high", [(2 / 2000, 500 / 2000), (0.1, 0.4), (0.3, 0.31)])
def test_butter1_bandpass_and_dynamic_biquad(low, high):
    b, a = iir.butter1_bandpass_coeffs(low, high)
    sb, sa = sps.butter(1, [low, high], btype="band")
    np.testing.assert_allclose(b, sb, atol=1e-12)
    np.testing.assert_allclose(a, sa, atol=1e-12)
    jb, ja = jax_iir.butter1_bandpass_coeffs(jnp.float32(low), jnp.float32(high))
    np.testing.assert_allclose(np.asarray(jb), b, atol=1e-6)
    np.testing.assert_allclose(np.asarray(ja), a, atol=1e-6)
    x = _x(9)
    want = sps.lfilter(sb, sa, x.astype(np.float64), axis=-1)
    got = iir.biquad_dynamic(torch.from_numpy(x), b, a)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
