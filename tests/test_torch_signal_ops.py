"""The rest of ``signal/jaxproc.py``'s surface in the port, and the profiler hook.

``signal/torchproc.py::preprocess_ecg`` against ``jaxproc.preprocess_ecg`` at max-abs < 1e-4
(float32, same algorithm, different summation order) and against the float64 NumPy oracle at
the ``tests/test_equivalence.py`` bar (corr > 0.999, max-abs < 5e-3), as
``tests/test_torch_preprocess.py`` holds the PCG chain. ``ops/normalize.py``'s three
normalisers and ``ops/segment.py::segment`` against ``jaxproc``'s at 1e-6 (the windows are
gathered samples, equal bit for bit). ``utils/observe.py::trace`` writes a Chrome trace under
its log dir and is a no-op without one.
"""

import json

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from wav2vec_heart_sounds_tpu import signal as sig
from wav2vec_heart_sounds_tpu.signal import jaxproc
from wav2vec_heart_sounds_tpu_torch.config import WindowSpec
from wav2vec_heart_sounds_tpu_torch.ops import normalize, segment
from wav2vec_heart_sounds_tpu_torch.signal import torchproc
from wav2vec_heart_sounds_tpu_torch.utils.observe import trace

JAX_ATOL, CORR, MAXABS, EXACT = 1e-4, 0.999, 5e-3, 1e-6


def _ecg(fs, seconds, rows, seed=0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    t = np.arange(int(fs * seconds)) / fs
    beats = np.sin(2 * np.pi * rng.uniform(0.9, 1.6, size=(rows, 1)) * t) ** 15
    return (beats + 0.3 * np.sin(2 * np.pi * 0.2 * t) + 0.05 * rng.normal(size=(rows, t.size))
            ).astype(np.float32)


@pytest.mark.parametrize("fs_in,fs_out", [(2000, 4125), (2000, 500), (1000, 16000)])
def test_preprocess_ecg_matches_jaxproc_and_oracle(fs_in, fs_out):
    x = _ecg(fs_in, 3.0, rows=3)
    want = np.asarray(jaxproc.preprocess_ecg(jnp.asarray(x), fs_in, fs_out))
    got = torchproc.preprocess_ecg(torch.from_numpy(x), fs_in, fs_out).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=JAX_ATOL, rtol=0)
    for row, port in zip(x, got):
        oracle = sig.preprocess_ecg(row.astype(np.float64), fs_in, fs_out)
        n = min(len(oracle), len(port))
        assert np.corrcoef(oracle[:n], port[:n])[0, 1] > CORR
        assert np.abs(oracle[:n] - port[:n]).max() < MAXABS
    one = torchproc.preprocess_ecg(torch.from_numpy(x[1]), fs_in, fs_out).numpy()
    np.testing.assert_allclose(one, got[1], atol=EXACT, rtol=0)       # [T] as one row


@pytest.mark.parametrize("name,kwargs", [("minmax_normalise", {}),
                                         ("minmax_normalise", {"lo": 0.0, "hi": 2.0}),
                                         ("z_normalise", {}), ("kpeak_normalise", {}),
                                         ("kpeak_normalise", {"k": 5, "lo": -0.5, "hi": 3.0})])
def test_normalisers_match_jaxproc(name, kwargs):
    rng = np.random.default_rng(4)
    x = (rng.normal(size=(3, 700)) * rng.uniform(0.1, 5.0, size=(3, 1)) + 0.7).astype(np.float32)
    want = np.asarray(getattr(jaxproc, name)(jnp.asarray(x), **kwargs))
    got = getattr(normalize, name)(torch.from_numpy(x), **kwargs).numpy()
    np.testing.assert_allclose(got, want, atol=EXACT, rtol=EXACT)


@pytest.mark.parametrize("shape,spec", [((2, 5000), WindowSpec(1.0)),
                                        ((4321,), WindowSpec(0.5, 0.1, 0.0)),
                                        ((3, 600), WindowSpec(1.0))])   # under one window
def test_segment_matches_jaxproc(shape, spec):
    x = np.random.default_rng(5).normal(size=shape).astype(np.float32)
    want = np.asarray(jaxproc.segment(jnp.asarray(x), 1000, spec))
    got = segment.segment(torch.from_numpy(x), 1000, spec).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=EXACT, rtol=0)


def test_trace_writes_a_chrome_trace_and_is_a_noop_without_a_log_dir(tmp_path):
    with trace(None):
        torch.ones(3).sum()
    with trace(str(tmp_path), "step"):
        (torch.ones(64, 64) @ torch.ones(64, 64)).sum()
    assert [p.name for p in tmp_path.iterdir()] == ["step"]
    events = json.loads((tmp_path / "step" / "trace.json").read_text())["traceEvents"]
    assert any("matmul" in e.get("name", "") or "mm" in e.get("name", "") for e in events)
