"""The traffic generator: seeded, the same sizes for every seed, cut as the port cuts."""

import json

import numpy as np
import pytest
import torch

from benchmark.harness import reference, traffic
from benchmark.harness.cells import REPO


def real(name):
    return json.loads((REPO / "benchmark" / "traffic" / f"{name}.json").read_text())


def test_train_windows_repeat_for_a_seed_and_differ_across_seeds():
    t = {**real("cinc-train-raw2k"), "count": 48}
    a, la = traffic.train_windows(t, 2 ** 31 + 9, "cpu")
    b, lb = traffic.train_windows(t, 2 ** 31 + 9, "cpu")
    c, lc = traffic.train_windows(t, 2 ** 31 + 10, "cpu")
    assert a.shape == (48, 8000) and a.dtype == np.float32
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(la, lb)
    assert np.abs(a - c).max() > 0.1 and (la != lc).any()
    np.testing.assert_allclose(np.abs(a).max(axis=1), 1.0, rtol=1e-6)
    assert la.sum() == lc.sum() == 24                 # balanced, whatever the seed


def test_score_corpus_repeats_for_a_seed_with_one_set_of_lengths(tiny):
    t = tiny.cell("tiny-score").traffic
    a = traffic.score_corpus(t, 3, "cpu")
    b = traffic.score_corpus(t, 3, "cpu")
    c = traffic.score_corpus(t, 4, "cpu")
    np.testing.assert_array_equal(a["waves"], b["waves"])
    assert sorted(a["lengths"]) == sorted(c["lengths"])           # the same work
    assert len(a["waves"]) == len(c["waves"])
    assert not np.array_equal(a["lengths"], c["lengths"])          # in another order
    assert (a["recording_labels"] == 1).sum() == (c["recording_labels"] == 1).sum()


def test_the_real_corpus_lengths():
    t = real("cinc-score-corpus")
    lengths = traffic.recording_lengths(t) / t["fs_wire"]
    assert len(lengths) == 3240 and lengths.min() == 5.0 and lengths.max() == 120.0
    assert np.median(lengths) == pytest.approx(20.0, rel=1e-3)
    windows = sum(len(traffic.window_starts(int(n), t["fs_wire"], t["window"]))
                  for n in traffic.recording_lengths(t))
    assert 15000 < windows < 30000


def test_windows_are_cut_as_the_port_cuts_them(tiny):
    from wav2vec_heart_sounds_tpu_torch.config import WindowSpec
    from wav2vec_heart_sounds_tpu_torch.signal.segment import segment, window_starts

    t = tiny.cell("tiny-score").traffic
    spec = WindowSpec(**t["window"])
    for n in (600, 1500, 2299, 2300, 5000, 7777, 120000):
        assert traffic.window_starts(n, 1000, t["window"]) == window_starts(n, 1000, spec)
    c = traffic.score_corpus(t, 8, "cpu")
    for rec in range(t["count"]):
        count = c["offsets"][rec + 1] - c["offsets"][rec]
        assert count == len(segment(np.zeros(int(c["lengths"][rec]), np.float32), 1000, spec))
        assert (c["patients"][c["offsets"][rec]:c["offsets"][rec + 1]] == rec).all()


def spiked_mix(name):
    """(float64 wire windows, the mix) of a cut-down real traffic mix."""
    t = real(name)
    if t["layout"] == "windows":
        return traffic.train_windows({**t, "count": 256}, 77, "cpu")[0].astype(np.float64), t
    return traffic.score_corpus({**t, "count": 120}, 78, "cpu")["waves"].astype(np.float64), t


@pytest.mark.parametrize("name", ["cinc-train-raw2k", "cinc-score-corpus"])
def test_planted_spikes_trip_the_despike_stage_and_are_removed(name):
    """The share of windows the mix plants spikes in has, in the resampled window, exactly
    ``per_window`` frames whose peak passes three times the median frame peak, every other
    window none; despiking (the reference's, and the port's on the CPU) removes them all,
    flattening the same samples."""
    from scipy.signal import resample_poly
    from wav2vec_heart_sounds_tpu_torch.ops.despike import remove_spikes
    from wav2vec_heart_sounds_tpu_torch.ops.resample import resample

    waves, t = spiked_mix(name)
    spec, fs = t["signal"]["spikes"], t["fs_model"]
    up = fs // t["fs_wire"]

    def frames_over(x):
        peaks = np.abs(x[:, :len(x[0]) // (fs // 2) * (fs // 2)]).reshape(
            len(x), -1, fs // 2).max(axis=2)
        return (peaks > 3.0 * np.median(peaks, axis=1, keepdims=True)).sum(axis=1)

    y = resample_poly(waves, up, 1, axis=-1)
    over = frames_over(y)
    assert (over > 0).sum() == round(spec["window_share"] * len(waves))
    assert set(over[over > 0]) == {spec["per_window"]}
    ours = reference.despike(y, fs)
    assert frames_over(ours).max() == 0
    port = remove_spikes(resample(torch.as_tensor(waves, dtype=torch.float32),
                                  t["fs_wire"], fs), fs).numpy()
    np.testing.assert_array_equal(port == np.float32(reference.SPIKE_FLOOR),
                                  ours == reference.SPIKE_FLOOR)
    assert ((ours == reference.SPIKE_FLOOR).any(axis=1) == (over > 0)).all()
