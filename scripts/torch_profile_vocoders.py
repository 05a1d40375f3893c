#!/usr/bin/env python3
"""Where the diffusion vocoders' time goes on one CUDA card.

    python3 scripts/torch_profile_vocoders.py

For DiffWave and WaveGrad at ``chip_smoke.py`` phase 18's configurations (full width,
float32, TF32 off, seeded weights; sampling at bench.py's batch and frames, the train step at
B = 16 and 80 frames), one ``torch.profiler`` trace each of a sampling call and of a
``GenerativeTrainer.train_step`` (after a warm-up call): the wall time, the device time
summed over kernels and their ratio (the card's busy share), and the device time by kernel,
largest first.
"""

from __future__ import annotations

import sys
import tempfile
import time
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from wav2vec_heart_sounds_tpu_torch.models.registry import get_spec  # noqa: E402
from wav2vec_heart_sounds_tpu_torch.train.generative import GenerativeTrainer  # noqa: E402

TOP = 15   # kernels listed


def trace(label: str, fn) -> None:
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    kernels.sort(key=lambda e: e.self_device_time_total, reverse=True)
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    print(f"[{label}] wall {wall:.3f} ms, device {busy:.3f} ms ({100 * busy / wall:.1f}% busy)")
    for e in kernels[:TOP]:
        print(f"[{label}]   {e.self_device_time_total / 1e3:9.3f} ms  {e.count:5d}x  "
              f"{e.key[:110]}")


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("torch_profile_vocoders: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for name, _, s_batch, s_frames, s_kw, t_batch, t_frames in chip_smoke.VOCODERS:
        spec = get_spec(name)
        model = chip_smoke.seeded_vocoder(name, seed=1).cuda()
        sb = chip_smoke.vocoder_inputs(name, s_batch, s_frames, seed=20, device="cuda")
        gen = torch.Generator(device="cuda").manual_seed(21)
        trace(f"{name} sampling B={s_batch} {s_frames} frames {s_kw}",
              lambda: spec.sample(model, sb["con_spec"], sb["label"], gen, **s_kw))
        tb = chip_smoke.vocoder_inputs(name, t_batch, t_frames, seed=22)
        with tempfile.TemporaryDirectory() as tmp:
            trainer = GenerativeTrainer(model, spec.loss, tmp, log=lambda line: None)
            trace(f"{name} train_step B={t_batch} {t_frames} frames",
                  lambda: trainer.train_step(tb))
        del model


if __name__ == "__main__":
    main()
