#!/usr/bin/env python3
"""Where the port's serving time goes on one CUDA card.

    python3 scripts/torch_profile_serving.py

Runs ``chip_smoke.py``'s serving configuration (full-width bf16 wav2vec2-base, 512x3 head,
eval batches of 32 synthetic raw 2 kHz windows) and prints:

* host-clock ms per batch for preprocessing alone and for the classifier alone, each
  ending in a device sync (median of 5);
* one ``torch.profiler`` trace of ``score`` over the whole dataset: device time by
  kernel, total device time against wall time (the device's busy share).
"""

from __future__ import annotations

import statistics
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from wav2vec_heart_sounds_tpu_torch.config import WindowSpec  # noqa: E402
from wav2vec_heart_sounds_tpu_torch.data.fragments import FragmentDataset  # noqa: E402
from wav2vec_heart_sounds_tpu_torch.data.loader import Batcher  # noqa: E402
from wav2vec_heart_sounds_tpu_torch.experiments.cinc import score  # noqa: E402
from wav2vec_heart_sounds_tpu_torch.models.build import build_classifier  # noqa: E402
from wav2vec_heart_sounds_tpu_torch.models.classifier import ClassifierConfig  # noqa: E402
from wav2vec_heart_sounds_tpu_torch.signal.torchproc import preprocess_pcg  # noqa: E402


def host_ms(fn, runs: int = 5) -> float:
    times = []
    for _ in range(runs + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times[1:])


TOP = 25   # kernels listed


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    fs_wire, fs, bs = chip_smoke.FS_WIRE, chip_smoke.FS, chip_smoke.BATCH
    win_len = WindowSpec(window_s=chip_smoke.WINDOW_S).window_len(fs)
    batcher = Batcher(FragmentDataset(chip_smoke.synthetic_recordings(), fs=fs_wire), bs,
                      train=False)
    model = build_classifier(ClassifierConfig(head_hidden=(512, 512, 512), fs=fs), seed=0,
                             device="cuda", dtype=torch.bfloat16)
    raw = torch.as_tensor(next(iter(batcher))["waveform"], device="cuda")
    x = preprocess_pcg(raw, fs_wire, fs)[:, :win_len]
    with torch.inference_mode():
        print(f"preprocess_pcg [{bs}, {raw.shape[1]}]: "
              f"{host_ms(lambda: preprocess_pcg(raw, fs_wire, fs)):.3f} ms/batch")
        print(f"classifier [{bs}, {win_len}] bf16: {host_ms(lambda: model(x)):.3f} ms/batch")
    score(model, batcher, fs_wire, fs, win_len)                          # warm-up

    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        score(model, batcher, fs_wire, fs, win_len)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total for e in events) / 1e3
    print(f"score over {len(batcher)} batches: wall {wall_ms:.1f} ms, device busy "
          f"{device_ms:.1f} ms ({100 * device_ms / wall_ms:.1f}%)")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:TOP]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms  {e.count:6d}x  {e.key[:100]}")


if __name__ == "__main__":
    main()
