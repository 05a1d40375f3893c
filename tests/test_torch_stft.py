"""The port's batched STFT / mel / log-mel (``ops/stft.py``) vs the JAX package's and the
NumPy oracle (``signal/spectrogram.py``), on the CPU.

Both registry recipes (DiffWave: n_fft 1024 / hop 256 / 80 mels; WaveGrad: win 1200 in an
n_fft of 2048 / hop 300 / 128 mels) with the PCG (500 Hz) and ECG (200 Hz) ``f_max``, on a
``[2, 3, T]`` batch of seeded noise plus tones. Bars, float32, against the JAX twin and,
row by row, against the float64 oracle: the magnitude and the mel at 1e-5 of each output's
largest value (both sides sit within 3e-7 of it), the log-mel in [0, 1] at 1e-4 absolute:
its log turns a mel bin's relative error into an absolute one, and at the ECG ``f_max`` a
bin near 1e-3 of the largest puts the JAX twin itself 4.9e-5 from the oracle (WaveGrad's
recipe; the port 1.8e-5).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from wav2vec_heart_sounds_tpu.models import registry as jax_registry
from wav2vec_heart_sounds_tpu.ops import stft as jax_stft
from wav2vec_heart_sounds_tpu_torch.models import registry
from wav2vec_heart_sounds_tpu_torch.ops import stft
from wav2vec_heart_sounds_tpu_torch.signal import spectrogram
from torch_vocoder_pairs import one_torch_thread  # noqa: F401


def _signal(n: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 4000.0
    tones = np.sin(2 * np.pi * 60 * t) + 0.5 * np.sin(2 * np.pi * 230 * t)
    return (tones[None, None] + 0.3 * rng.normal(size=(2, 3, n))).astype(np.float32)


@pytest.mark.parametrize("signal", ["pcg", "ecg"])
@pytest.mark.parametrize("name", ["diffwave", "wavegrad"])
def test_stft_and_log_mel_match_jax_and_oracle(name, signal):
    cfg, jcfg = registry.get_spec(name).mel(signal), jax_registry.get_spec(name).mel(signal)
    assert vars(cfg) == vars(jcfg)
    x = _signal(cfg.hop_length * 12 + 37)
    got = {fn: getattr(stft, fn)(torch.as_tensor(x), cfg).numpy()
           for fn in ("stft_magnitude", "mel_spectrogram", "log_mel")}
    frames = 1 + x.shape[-1] // cfg.hop_length
    assert got["stft_magnitude"].shape == (2, 3, cfg.n_fft // 2 + 1, frames)
    assert got["log_mel"].shape == (2, 3, cfg.n_mels, frames)
    for fn, value in got.items():
        want = np.asarray(getattr(jax_stft, fn)(jnp.asarray(x), jcfg))
        atol = 1e-4 if fn == "log_mel" else 1e-5 * float(np.abs(want).max())
        np.testing.assert_allclose(value, want, atol=atol, rtol=0, err_msg=f"{fn} vs JAX")
    oracle = {
        "stft_magnitude": lambda row: spectrogram.stft_magnitude(row, cfg.n_fft, cfg.hop_length,
                                                                 cfg.win),
        "mel_spectrogram": lambda row: spectrogram.mel_spectrogram(row, cfg),
        "log_mel": lambda row: spectrogram.log_mel(row, cfg)}
    for fn, ref in oracle.items():
        want = np.stack([np.stack([ref(row) for row in rows]) for rows in x])
        atol = 1e-4 if fn == "log_mel" else 1e-5 * float(np.abs(want).max())
        np.testing.assert_allclose(got[fn], want, atol=atol, rtol=0, err_msg=f"{fn} vs oracle")
