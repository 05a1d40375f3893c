"""The benchmark's one traffic generator: seeded synthetic PCG recordings, cut into windows.

A traffic file (``benchmark/traffic/<name>.json``) holds only parameters; this module turns
them and ``--seed`` into host arrays, which are all the program receives. Two layouts:

* ``windows`` (training): ``count`` independent windows of ``window_s`` seconds at
  ``fs_wire``, each scaled to a peak of 1 (the wire contract), labels balanced by
  ``abnormal_share``;
* ``recordings`` (scoring): ``count`` recordings whose lengths are a fixed set (the
  quantiles of a clipped log-normal, the same for every seed, dealt out in a seeded order),
  each scaled to its own peak of 1 and cut into overlapping windows by the segmentation
  rule copied below (the port's ``WindowSpec`` and ``window_starts``).

The signal is PCG-like: a steady two-tone floor, S1 and S2 as Gaussian-windowed tones at a
seeded heart rate, white noise, and for abnormal recordings a systolic murmur tone. Without
spikes no 500 ms frame's peak reaches three times the median frame peak. Friction spikes
(``signal.spikes``) are planted in a fixed number of windows, ``round(window_share * N)``
of the ``N`` windows in a seeded choice, ``per_window`` in each: Gaussian pulses of
``amplitude`` times the item's floor, each in another 500 ms frame of the window (the
despike stage's frame), at least ``margin_s`` inside it and inside the part of the window
that no other window overlaps. So the despike stage finds each spike's frame over its
threshold and flattens it: ``per_window`` iterations of its loop in every batch that holds
a spiked window.

Samples are drawn on ``device`` (the card in a run) from a ``torch.Generator`` seeded with
the run's seed, in chunks of rows, then copied to the host.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from scipy.special import ndtri

CHUNK_SAMPLES = 1 << 25          # samples synthesised per device call


def window_len(window_s: float, fs: float) -> int:
    return int(round(window_s * fs))


def hop_len(window_s: float, overlap_s: float, fs: float) -> int:
    return max(1, int(round((window_s - overlap_s) * fs)))


def window_starts(n_samples: int, fs: float, window: dict) -> list[int]:
    """Start indices of each window of a recording (a copy of the port's
    ``signal/segment.py::window_starts`` with ``WindowSpec``'s arithmetic)."""
    first = int(round(window["start_pad_s"] * fs))
    if n_samples <= first:
        return []
    win = window_len(window["window_s"], fs)
    last = max(first, n_samples - win)
    starts = list(range(first, last + 1, hop_len(window["window_s"], window["overlap_s"], fs)))
    return starts or [first]


def _item_parameters(gen: torch.Generator, n: int, signal: dict, labels: torch.Tensor,
                     device) -> dict[str, torch.Tensor]:
    """Per-item draws: [n] tensors of amplitudes, frequencies, phases and the heart rate."""
    def uniform(lo_hi) -> torch.Tensor:
        lo, hi = lo_hi
        return lo + (hi - lo) * torch.rand(n, generator=gen, device=device)

    two_pi = 2.0 * math.pi
    return {
        "floor": uniform(signal["floor_amplitude"]),
        "f_a": uniform(signal["floor_hz"][0]), "f_b": uniform(signal["floor_hz"][1]),
        "ph_a": two_pi * torch.rand(n, generator=gen, device=device),
        "ph_b": two_pi * torch.rand(n, generator=gen, device=device),
        "period": 60.0 / uniform(signal["heart_rate_bpm"]),
        "beat0": torch.rand(n, generator=gen, device=device),
        "f_s1": uniform(signal["s1_hz"]), "f_s2": uniform(signal["s2_hz"]),
        "a_s1": uniform(signal["s1_gain"]),
        "f_m": uniform(signal["murmur_hz"]),
        "murmur": labels.to(device=device, dtype=torch.float32) * signal["murmur_gain"],
    }


def _synthesise(gen: torch.Generator, p: dict[str, torch.Tensor], rows: torch.Tensor,
                t: torch.Tensor, signal: dict) -> torch.Tensor:
    """Samples at times ``t`` (seconds, [R, L] or [L]) of items ``rows`` ([R])."""
    def col(name):
        return p[name][rows][:, None]

    period = col("period")
    phase = torch.remainder(t / period + col("beat0"), 1.0) * period      # time since beat
    s1w, s2w, s2_at = signal["s1_width_s"], signal["s2_width_s"], signal["s2_at"]

    def bump(center, width):
        d = phase - center
        d = d - period * torch.round(d / period)                          # nearest beat
        return torch.exp(-0.5 * (d / width) ** 2)

    floor = col("floor")
    two_pi = 2.0 * math.pi
    x = floor * (torch.sin(two_pi * col("f_a") * t + col("ph_a"))
                 + signal["floor_ratio"] * torch.sin(two_pi * col("f_b") * t + col("ph_b")))
    s1 = floor * col("a_s1") * bump(0.0, s1w) * torch.sin(two_pi * col("f_s1") * phase)
    s2 = (floor * col("a_s1") * signal["s2_ratio"] * bump(s2_at * period, s2w)
          * torch.sin(two_pi * col("f_s2") * (phase - s2_at * period)))
    systole = ((phase > 2 * s1w) & (phase < s2_at * period - 2 * s2w)).float()
    murmur = floor * col("murmur") * systole * torch.sin(two_pi * col("f_m") * t)
    noise = signal["noise"] * floor * torch.randn(x.shape, generator=gen, device=x.device)
    return x + s1 + s2 + murmur + noise


def spike_slots(window_s: float, overlap_s: float, spikes: dict) -> list[tuple[float, float]]:
    """(earliest, latest) centre in seconds from the window's start of a spike in each frame
    that can hold one: inside the frame by ``margin_s`` and outside the window's overlaps."""
    frame, margin = spikes["frame_s"], spikes["margin_s"]
    slots = []
    for j in range(int(round(window_s / frame))):
        lo = max(j * frame, overlap_s) + margin
        hi = min((j + 1) * frame, window_s - overlap_s) - margin
        if hi > lo:
            slots.append((lo, hi))
    if len(slots) < spikes["per_window"]:
        raise ValueError(f"{len(slots)} frames can hold a spike, {spikes['per_window']} asked")
    return slots


def plant_spikes(gen: torch.Generator, host_gen: torch.Generator, items: np.ndarray,
                 starts: np.ndarray, floor: torch.Tensor, slots: list, spikes: dict,
                 fs: float, device) -> dict:
    """The spikes of ``round(window_share * N)`` of the ``N`` windows (window ``i`` lies in
    item ``items[i]`` from sample ``starts[i]``): per spike its ``item``, ``centre`` (in the
    item's samples), signed ``amplitude`` and ``width`` (samples), and the ``reach`` in
    samples either side of a centre that is drawn."""
    n_windows = len(items)
    chosen = torch.randperm(n_windows, generator=host_gen)[
        :int(round(spikes["window_share"] * n_windows))].numpy()
    n, k = len(chosen), spikes["per_window"]

    def uniform(lo_hi, *shape) -> torch.Tensor:
        lo, hi = lo_hi
        return lo + (hi - lo) * torch.rand(*shape, generator=gen, device=device)

    bounds = torch.tensor(slots, dtype=torch.float64, device=device)
    pick = torch.rand(n, len(slots), generator=gen, device=device).argsort(dim=1)[:, :k]
    lo, hi = bounds[pick, 0], bounds[pick, 1]
    at = lo + (hi - lo) * torch.rand(n, k, generator=gen, device=device, dtype=torch.float64)
    sign = torch.where(torch.rand(n, k, generator=gen, device=device) < 0.5, -1.0, 1.0)
    item = torch.as_tensor(items[chosen], device=device)[:, None].expand(n, k)
    first = torch.as_tensor(starts[chosen], device=device, dtype=torch.float64)[:, None]
    return {"item": item.reshape(-1), "centre": (first + at * fs).reshape(-1),
            "amplitude": (sign * uniform(spikes["amplitude"], n, k)
                          * floor[item]).reshape(-1),
            "width": (uniform(spikes["width_ms"], n, k) * 1e-3 * fs).reshape(-1),
            "reach": int(math.ceil(6 * spikes["width_ms"][1] * 1e-3 * fs))}


def _add_spikes(x: torch.Tensor, spikes: dict, first_item: int) -> None:
    """Add to ``x`` (items ``first_item ..`` as rows) the spikes of those items."""
    mine = (spikes["item"] >= first_item) & (spikes["item"] < first_item + len(x))
    row = spikes["item"][mine] - first_item
    centre, amp, width = (spikes[k][mine] for k in ("centre", "amplitude", "width"))
    reach = spikes["reach"]
    index = torch.round(centre).long()[:, None] + torch.arange(-reach, reach + 1,
                                                              device=x.device)
    pulse = amp[:, None] * torch.exp(-0.5 * ((index - centre[:, None]) / width[:, None]) ** 2)
    x.index_put_((row[:, None].expand_as(index), index), pulse.to(x.dtype), accumulate=True)


def balanced_labels(count: int, abnormal_share: float, gen: torch.Generator) -> torch.Tensor:
    """A fixed number of abnormal items (``round(share * count)``), in a seeded order."""
    labels = torch.zeros(count, dtype=torch.int64)
    labels[:int(round(abnormal_share * count))] = 1
    return labels[torch.randperm(count, generator=gen)]


def train_windows(traffic: dict, seed: int, device) -> tuple[np.ndarray, np.ndarray]:
    """(waves float32 [count, window], labels int64 [count]) of a ``windows`` traffic."""
    fs, count = traffic["fs_wire"], traffic["count"]
    n = window_len(traffic["window_s"], fs)
    host_gen = torch.Generator().manual_seed(seed)
    labels = balanced_labels(count, traffic["abnormal_share"], host_gen)
    gen = torch.Generator(device=device).manual_seed(seed)
    p = _item_parameters(gen, count, traffic["signal"], labels, device)
    spec = traffic["signal"]["spikes"]
    spikes = plant_spikes(gen, host_gen, np.arange(count), np.zeros(count, np.int64),
                          p["floor"], spike_slots(traffic["window_s"], 0.0, spec), spec, fs,
                          device)
    t = torch.arange(n, device=device, dtype=torch.float32) / fs
    waves = np.empty((count, n), dtype=np.float32)
    step = max(1, CHUNK_SAMPLES // n)
    for r0 in range(0, count, step):
        rows = torch.arange(r0, min(count, r0 + step), device=device)
        x = _synthesise(gen, p, rows, t, traffic["signal"])
        _add_spikes(x, spikes, r0)
        x = x / x.abs().amax(dim=1, keepdim=True)
        waves[r0:r0 + len(rows)] = x.cpu().numpy()
    return waves, labels.numpy()


def recording_lengths(traffic: dict) -> np.ndarray:
    """Lengths in samples of the recordings: the same set for every seed."""
    spec, count, fs = traffic["length_s"], traffic["count"], traffic["fs_wire"]
    q = ndtri((np.arange(count) + 0.5) / count)
    seconds = np.clip(spec["median"] * np.exp(spec["sigma"] * q), spec["min"], spec["max"])
    return np.round(seconds * fs).astype(np.int64)


def score_corpus(traffic: dict, seed: int, device) -> dict:
    """The scoring corpus of a ``recordings`` traffic: ``waves`` float32 [N, window] in
    recording order, ``labels`` and ``patients`` (recording index) per window, and per
    recording its ``lengths`` (samples), ``labels`` and first window ``offsets``."""
    fs, count, window = traffic["fs_wire"], traffic["count"], traffic["window"]
    win = window_len(window["window_s"], fs)
    host_gen = torch.Generator().manual_seed(seed)
    labels = balanced_labels(count, traffic["abnormal_share"], host_gen)
    lengths = recording_lengths(traffic)[torch.randperm(count, generator=host_gen).numpy()]
    starts = [window_starts(int(n), fs, window) for n in lengths]
    if any(s + win > n for st, n in zip(starts, lengths) for s in st):
        raise ValueError("a recording shorter than its first window: padding is not generated")
    gen = torch.Generator(device=device).manual_seed(seed)
    p = _item_parameters(gen, count, traffic["signal"], labels, device)
    n_windows = np.array([len(s) for s in starts])
    offsets = np.concatenate([[0], np.cumsum(n_windows)])
    spec = traffic["signal"]["spikes"]
    spikes = plant_spikes(gen, host_gen, np.repeat(np.arange(count), n_windows),
                          np.concatenate(starts), p["floor"],
                          spike_slots(window["window_s"], window["overlap_s"], spec), spec,
                          fs, device)
    waves = np.empty((int(offsets[-1]), win), dtype=np.float32)
    rec = 0
    while rec < count:                            # recordings in chunks of samples
        last, n_max = rec + 1, int(lengths[rec])
        while last < count and (last - rec + 1) * max(n_max, lengths[last]) <= CHUNK_SAMPLES:
            n_max = max(n_max, int(lengths[last]))
            last += 1
        rows = torch.arange(rec, last, device=device)
        index = torch.arange(n_max, device=device)
        x = _synthesise(gen, p, rows, index.float() / fs, traffic["signal"])
        _add_spikes(x, spikes, rec)
        valid = index[None, :] < torch.as_tensor(lengths[rec:last], device=device)[:, None]
        x = torch.where(valid, x, 0.0)
        x = x / x.abs().amax(dim=1, keepdim=True)
        host = x.cpu().numpy()
        for i in range(rec, last):
            for j, s in enumerate(starts[i]):
                waves[offsets[i] + j] = host[i - rec, s:s + win]
        rec = last
    patients = np.repeat(np.arange(count), n_windows)
    return {"waves": waves, "labels": labels.numpy()[patients], "patients": patients,
            "lengths": lengths, "recording_labels": labels.numpy(), "offsets": offsets}
