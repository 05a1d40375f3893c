"""The port's ctypes bindings of the C++ host library (``native.py``) and their routing.

The port builds the same ``native/fastproc.cpp`` as the JAX package into its own
``build/native/``, so on the same inputs every function (``resample``, ``remove_spikes``, both
preprocessing chains and the batch entry) equals the JAX package's ``native`` bit for bit, and
the NumPy oracle at ``tests/test_native.py``'s bars (resample 1e-10, despike 1e-12, chains
1e-9, the batch entry 1e-12 against the single-record chain). ``data/common.py``'s
``pcg_chain`` / ``ecg_chain`` take the library, equal to the JAX package's ``data/common``
on one record, and the oracle under ``W2VHS_NO_NATIVE=1`` or when the library cannot build.
"""

import numpy as np
import pytest

from wav2vec_heart_sounds_tpu import native as jax_native
from wav2vec_heart_sounds_tpu.data import common as jax_common
from wav2vec_heart_sounds_tpu_torch import native
from wav2vec_heart_sounds_tpu_torch.data import common
from wav2vec_heart_sounds_tpu_torch.signal import despike, preprocess, resample


def _mix(fs, seconds=4.0, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(int(fs * seconds)) / fs
    return (np.sin(2 * np.pi * 90 * t) + 0.5 * np.sin(2 * np.pi * 300 * t)
            + 0.05 * rng.normal(size=t.size))


def _spiky(seed):
    x = _mix(2000, 4.0, seed)
    x[500], x[2777], x[100] = 40.0, -25.0, np.nan          # NaN interpolation included
    return x


def test_the_library_builds_here_into_build_native():
    assert native.available() and jax_native.available()
    assert native._load()._name.startswith(native.BUILD_DIR)


@pytest.mark.parametrize("fs_in,fs_out", [(2000, 4125), (2000, 16000), (44100, 16000)])
def test_resample_equals_jax_native_and_oracle(fs_in, fs_out):
    x = _mix(fs_in, 2.0)
    got = native.resample(x, fs_in, fs_out)
    np.testing.assert_array_equal(got, jax_native.resample(x, fs_in, fs_out))
    np.testing.assert_allclose(got, resample.resample(x, fs_in, fs_out), atol=1e-10)


def test_despike_equals_jax_native_and_oracle():
    x = _mix(1000, 4.0, 1)
    x[500], x[2777] = 40.0, -25.0
    got = native.remove_spikes(x, 1000)
    np.testing.assert_array_equal(got, jax_native.remove_spikes(x, 1000))
    np.testing.assert_allclose(got, despike.remove_spikes(x, 1000), atol=1e-12)


@pytest.mark.parametrize("chain", ["preprocess_pcg", "preprocess_ecg"])
def test_chains_equal_jax_native_and_oracle(chain):
    x = _spiky(2)
    got = getattr(native, chain)(x, 2000, 4125)
    np.testing.assert_array_equal(got, getattr(jax_native, chain)(x, 2000, 4125))
    np.testing.assert_allclose(got, getattr(preprocess, chain)(x, 2000, 4125), atol=1e-9)


def test_batch_equals_jax_native_and_single_records():
    batch = np.stack([_mix(2000, 3.0, s) for s in range(4)])
    got = native.preprocess_pcg_batch(batch, 2000, 4125)
    np.testing.assert_array_equal(got, jax_native.preprocess_pcg_batch(batch, 2000, 4125))
    for row, out in zip(batch, got):
        np.testing.assert_allclose(out, native.preprocess_pcg(row, 2000, 4125), atol=1e-12)


@pytest.mark.parametrize("chain,oracle", [("pcg_chain", "preprocess_pcg"),
                                          ("ecg_chain", "preprocess_ecg")])
def test_data_common_routes_through_the_library_or_the_oracle(monkeypatch, chain, oracle):
    x = _spiky(3)
    got = getattr(common, chain)(x, 2000, 4125)
    np.testing.assert_array_equal(got, getattr(native, oracle)(x, 2000, 4125))
    np.testing.assert_array_equal(got, getattr(jax_common, chain)(x, 2000, 4125))

    def refuse(*args, **kwargs):
        raise AssertionError("the library ran under W2VHS_NO_NATIVE=1")

    monkeypatch.setattr(native, oracle, refuse)
    monkeypatch.setenv("W2VHS_NO_NATIVE", "1")
    np.testing.assert_array_equal(getattr(common, chain)(x, 2000, 4125),
                                  getattr(preprocess, oracle)(x, 2000, 4125))


def test_without_the_library_every_function_is_the_oracle(monkeypatch):
    monkeypatch.setattr(native, "_load", lambda: None)
    assert not native.available()
    x = _spiky(4)
    np.testing.assert_array_equal(native.resample(x, 2000, 4125),
                                  resample.resample(x, 2000, 4125))
    np.testing.assert_array_equal(native.preprocess_ecg(x, 2000, 4125),
                                  preprocess.preprocess_ecg(x, 2000, 4125))
    np.testing.assert_array_equal(common.pcg_chain(x, 2000, 4125),
                                  preprocess.preprocess_pcg(x, 2000, 4125))
