"""PyTorch preprocessing port vs the JAX twin (``signal/jaxproc.py``) and the NumPy oracle.

The port is held to ``jaxproc`` at max-abs < 1e-4 (float32, same algorithm, different
summation order) and to the float64 oracle at the ``tests/test_equivalence.py`` bar
(corr > 0.999, max-abs < 5e-3). Inputs carry spikes so the despike loop does real work.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from wav2vec_heart_sounds_tpu import signal as sig
from wav2vec_heart_sounds_tpu.signal import jaxproc
from wav2vec_heart_sounds_tpu_torch.ops import despike, iir, normalize, resample
from wav2vec_heart_sounds_tpu_torch.signal import torchproc

JAX_ATOL = 1e-4
CORR = 0.999
MAXABS = 5e-3


def _oracle_close(oracle: np.ndarray, port: np.ndarray):
    n = min(len(oracle), len(port))
    a, b = np.asarray(oracle)[:n], np.asarray(port)[:n]
    assert np.corrcoef(a, b)[0, 1] > CORR
    assert np.max(np.abs(a - b)) < MAXABS


def _mix(fs, seconds, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(int(fs * seconds)) / fs
    return (np.sin(2 * np.pi * 90 * t) + 0.5 * np.sin(2 * np.pi * 300 * t)
            + 0.05 * rng.normal(size=t.size))


def _spiky_batch(fs, seconds, rows=3, seed=0) -> np.ndarray:
    x = np.stack([_mix(fs, seconds, seed + r) for r in range(rows)])
    n = x.shape[1]
    x[0, n // 8] = 40.0
    x[1, n // 3] = -25.0
    x[1, (2 * n) // 3] = 30.0
    return x.astype(np.float32)


def _jax(fn, x, *args):
    return np.asarray(fn(jnp.asarray(x), *args))


def _port(fn, x, *args):
    return fn(torch.from_numpy(np.ascontiguousarray(x)), *args).numpy()


@pytest.mark.parametrize("fs_in,fs_out", [(2000, 16000), (2000, 4125), (44100, 16000)])
def test_resample_matches_jaxproc_and_scipy(fs_in, fs_out):
    x = _spiky_batch(fs_in, 1.0)
    ref = _jax(jaxproc.resample, x, fs_in, fs_out)
    out = _port(resample.resample, x, fs_in, fs_out)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=JAX_ATOL)
    _oracle_close(sig.resample(x[2].astype(np.float64), fs_in, fs_out), out[2])


# 4.0 s at fs=1000 gives 8 half-second windows (even: the median is the midpoint of the two
# middle values); 3.5 s gives 7 (odd); 64000 samples at 16 kHz is the serving path's case.
@pytest.mark.parametrize("fs,seconds", [(1000, 4.0), (1000, 3.5), (16000, 4.0)])
def test_remove_spikes_matches_jaxproc(fs, seconds):
    x = _spiky_batch(fs, seconds)
    ref = _jax(jaxproc.remove_spikes, x, fs)
    out = _port(despike.remove_spikes, x, fs)
    np.testing.assert_allclose(out, ref, atol=JAX_ATOL)
    assert np.abs(out - x).max() > 20.0          # the spikes were removed
    _oracle_close(sig.remove_spikes(x[1].astype(np.float64), fs), out[1])


def test_median_is_midpoint_for_even_counts():
    v = torch.tensor([[1.0, 2.0, 3.0, 4.0]])
    assert despike.median_last(v).item() == 2.5
    assert torch.median(v, dim=-1).values.item() == 2.0       # the trap the port avoids
    rng = np.random.default_rng(0)
    for w in (7, 8):
        a = rng.normal(size=(64, w)).astype(np.float32)
        np.testing.assert_array_equal(despike.median_last(torch.from_numpy(a)).numpy(),
                                      np.asarray(jnp.median(jnp.asarray(a), axis=1,
                                                            keepdims=True)))


def test_remove_spikes_fixed_point_matches_full_loop():
    """A spike whose sign flips on both sides is never flattened (empty span): JAX spins
    to max_iterations, the port stops at the fixed point with the same output."""
    fs = 1000
    x = _mix(fs, 2.0, 9).astype(np.float32)[None]
    x[0, 700] = 30.0
    x[0, 699] = x[0, 701] = -0.5
    ref = _jax(jaxproc.remove_spikes, x, fs)
    out = _port(despike.remove_spikes, x, fs)
    np.testing.assert_array_equal(out, ref)
    assert out[0, 700] == 30.0


@pytest.mark.parametrize("fs,low,high", [(16000, 25.0, 450.0), (4125, 25.0, 450.0),
                                         (4125, 2.0, 40.0)])
def test_bandpass_cascade_matches_jaxproc_and_oracle(fs, low, high):
    x = np.stack([_mix(fs, 4.0, s) for s in range(2)]).astype(np.float32)
    ref = _jax(jaxproc.bandpass_cascade, x, fs, low, high)
    out = _port(iir.bandpass_cascade, x, fs, low, high)
    np.testing.assert_allclose(out, ref, atol=JAX_ATOL)
    _oracle_close(sig.bandpass_cascade(x[0].astype(np.float64), fs, low, high, order=2),
                  out[0])


def test_butterworth_uses_fs_normalised_cutoff():
    from scipy import signal as sps

    sos = iir.design_butter(450.0, 16000, "lowpass", 2)
    np.testing.assert_allclose(np.asarray(sos), sps.butter(2, 450.0 / 16000, output="sos"))


@pytest.mark.parametrize("T", [1, 63, 64, 65, 1000, 5000])
def test_blocked_scan_matches_serial_recurrence(T):
    rng = np.random.default_rng(T)
    x = rng.normal(size=(2, T))
    p, r = 0.995 * np.exp(0.3j), 0.2 - 0.7j
    y = np.zeros((2, T), np.complex128)
    state = np.zeros(2, np.complex128)
    for n in range(T):
        state = p * state + r * x[:, n]
        y[:, n] = state
    out = iir.first_order_scan_real(torch.tensor(x, dtype=torch.float32), p, r).numpy()
    np.testing.assert_allclose(out, y.real, atol=5e-5)


def test_abs_max_normalise_matches_jaxproc_and_oracle():
    x = (np.stack([_mix(1000, 2.0, s) for s in range(2)]) * 7 + 3).astype(np.float32)
    x[1, 10] = np.nan
    ref = _jax(jaxproc.abs_max_normalise, x)
    out = _port(normalize.abs_max_normalise, x)
    np.testing.assert_allclose(out, ref, atol=JAX_ATOL)
    _oracle_close(sig.abs_max_normalise(x[0].astype(np.float64)), out[0])


def test_fit_length_pads_and_crops():
    x = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    assert normalize.fit_length(x, 5).tolist() == [[0, 1, 2, 0, 0], [3, 4, 5, 0, 0]]
    assert normalize.fit_length(x, 2).tolist() == [[0, 1], [3, 4]]


@pytest.mark.parametrize("fs_out", [16000, 4125])
def test_preprocess_pcg_matches_jaxproc_and_oracle(fs_out):
    fs_in = 2000
    x = _spiky_batch(fs_in, 4.0)
    ref = _jax(jaxproc.preprocess_pcg, x, fs_in, fs_out)
    out = _port(torchproc.preprocess_pcg, x, fs_in, fs_out)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=JAX_ATOL)
    for row in range(x.shape[0]):
        _oracle_close(sig.preprocess_pcg(x[row].astype(np.float64), fs_in, fs_out), out[row])
    single = _port(torchproc.preprocess_pcg, x[0], fs_in, fs_out)
    np.testing.assert_allclose(single, out[0], atol=1e-6)
