#!/usr/bin/env python3
"""Where the port's training time goes on one CUDA card.

    python3 scripts/torch_profile_train.py            # the CinC training step
    python3 scripts/torch_profile_train.py --gated    # the same on the opt-in K3a + K8 route
    python3 scripts/torch_profile_train.py --vest     # the vest training step
    python3 scripts/torch_profile_train.py --fusion   # the PCG+ECG fusion training step

Builds ``chip_smoke.py``'s training configuration (full-width bf16 wav2vec2-base, 512x3
head, SGD at lr 1e-3, B=96 raw 2 kHz int16 windows preprocessed on the card; with
``--gated`` its encoder takes ``qkv_fuse=False, conv_fuse=True``), or with ``--vest`` its
vest configuration (bench.py's: 6 microphones of 2 s at 4125 Hz, the sinc beamformer, LoRA
on q/v under the freeze mask, the 256 head, AdamW at 1e-4, B=16 int16 windows with lazy
host augmentation), or with ``--fusion`` its fusion configuration (bench.py's: two
full-width branches, B=64 int16 windows of 4 s at 4125 Hz on two channels, AdamW at
1e-4), and prints:

* host-clock ms per step for each stage of a train step, each ending in a device sync
  (median of 5): preprocessing (CinC), the beamformer alone (vest) or one branch's
  training encoder (fusion), the training forward with the loss, forward + backward, and
  the whole step with the optimizer update;
* one ``torch.profiler`` trace of a train step as ``SupervisedTrainer`` runs it (one
  batch through ``_run_epoch``, after a warm-up step): device time by kernel, and total
  device time against wall time (the card's busy share).
"""

from __future__ import annotations

import statistics
import sys
import time
from functools import partial
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from wav2vec_heart_sounds_tpu_torch.augment.pipelines import AugmentConfig  # noqa: E402
from wav2vec_heart_sounds_tpu_torch.data.fragments import FragmentDataset  # noqa: E402
from wav2vec_heart_sounds_tpu_torch.data.vest import multi_augment  # noqa: E402
from wav2vec_heart_sounds_tpu_torch.experiments.cinc import _device_prep  # noqa: E402
from wav2vec_heart_sounds_tpu_torch.experiments.common import make_loader  # noqa: E402
from wav2vec_heart_sounds_tpu_torch.models.build import (  # noqa: E402
    build_classifier, build_two_branch)
from wav2vec_heart_sounds_tpu_torch.models.classifier import ClassifierConfig  # noqa: E402
from wav2vec_heart_sounds_tpu_torch.train.classifier import SupervisedTrainer  # noqa: E402
from wav2vec_heart_sounds_tpu_torch.train.losses import cross_entropy  # noqa: E402

TOP = 30   # kernels listed


def host_ms(fn, runs: int = 5) -> float:
    times = []
    for _ in range(runs + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times[1:])


def dequant(raw: torch.Tensor) -> torch.Tensor:
    return raw.float() / 32767.0


def cinc_setup(**routes):
    """(loader, model, trainer, raw batch -> model input, the stage timed alone on (raw,
    input), its label) of the CinC step; ``routes`` sets ``qkv_fuse`` / ``conv_fuse``."""
    fs_wire, fs, bs = chip_smoke.FS_WIRE, chip_smoke.FS, chip_smoke.TRAIN_BATCH
    win_len = int(chip_smoke.WINDOW_S * fs)
    recordings = chip_smoke.synthetic_recordings(1, chip_smoke.TRAIN_PATIENTS,
                                                 chip_smoke.TRAIN_WINDOWS)
    loader = make_loader(FragmentDataset(recordings, fs=fs_wire), bs, train=True)
    model = build_classifier(chip_smoke.classifier_config(**routes), seed=0, device="cuda",
                             dtype=torch.bfloat16, train=True)
    prep = _device_prep(fs_wire, fs, win_len, "cuda")
    trainer = SupervisedTrainer(model, optimizer_name="sgd", lr=1e-3, device_preprocess=prep,
                                log=lambda line: None)
    return (loader, model, trainer, prep, lambda raw, x: prep(raw),
            f"preprocess [{bs}, int16] -> [{bs}, {win_len}]")


def vest_setup():
    """The same for the vest step; the stage before the encoder is the beamformer."""
    bs = chip_smoke.VEST_BATCH
    dataset = FragmentDataset(chip_smoke.vest_fragments(4, 0), fs=chip_smoke.VEST_FS,
                              augment_num=15, augment_fn=partial(multi_augment,
                                                                 cfg=AugmentConfig()))
    loader = make_loader(dataset, bs, True, 0, chip_smoke.VEST_T)
    cfg = chip_smoke.vest_config()
    model = build_classifier(cfg, seed=0, device="cuda", dtype=torch.bfloat16, train=True)
    trainer = SupervisedTrainer(model, optimizer_name="adamw", lr=1e-4, classifier_config=cfg,
                                log=lambda line: None)
    return (loader, model, trainer, dequant,
            lambda raw, x: model.channel_mixer(x.transpose(1, 2)),
            f"beamformer [{bs}, {chip_smoke.VEST_T}, {chip_smoke.VEST_MICS}] -> "
            f"[{bs}, {chip_smoke.VEST_T}] (delay predictor with K6, then K7)")


def fusion_setup():
    """The same for the fusion step; the stage timed alone is one branch's training
    encoder (the PCG channel)."""
    bs, fs = chip_smoke.FUSION_BATCH, chip_smoke.FUSION_FS
    win = int(round(chip_smoke.WINDOW_S * fs))
    dataset = FragmentDataset(chip_smoke.fusion_fragments(4 * bs, 0), fs=fs)
    loader = make_loader(dataset, bs, True, 0, win)
    branch = ClassifierConfig(num_classes=2, num_channels=1, random_init=True, fs=fs)
    model = build_two_branch(branch, branch, seed=0, device="cuda", dtype=torch.bfloat16,
                             train=True)
    trainer = SupervisedTrainer(model, optimizer_name="adamw", lr=1e-4, log=lambda line: None)
    gen = torch.Generator().manual_seed(1)
    return (loader, model, trainer, dequant,
            lambda raw, x: model.branch_0.encode(x[:, :, 0], True, gen),
            f"one branch's training encoder [{bs}, {win}] -> [{bs}, 768]")


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    args = sys.argv[1:]
    if "--vest" in args:
        setup = vest_setup()
    elif "--fusion" in args:
        setup = fusion_setup()
    else:
        setup = cinc_setup(**({"qkv_fuse": False, "conv_fuse": True} if "--gated" in args
                              else {}))
    loader, model, trainer, to_input, stage, stage_label = setup
    batch = next(iter(loader))
    bs = len(batch["label"])
    raw = torch.as_tensor(batch["waveform"], device="cuda")
    y = torch.as_tensor(batch["label"], device="cuda")
    valid = torch.as_tensor(batch["valid"], device="cuda").float()
    with torch.no_grad():
        x = to_input(raw)
    gen = torch.Generator().manual_seed(0)

    def forward():
        return cross_entropy(model(x, train=True, generator=gen), y, valid)

    def forward_backward():
        model.zero_grad(set_to_none=True)
        forward().backward()

    with torch.no_grad():
        print(f"{stage_label}: {host_ms(lambda: stage(raw, x)):.3f} ms/step")
    print(f"training forward + loss, bf16 B={bs}: {host_ms(forward):.3f} ms/step")
    print(f"forward + backward: {host_ms(forward_backward):.3f} ms/step")
    print(f"whole train step (+ optimizer): "
          f"{host_ms(lambda: trainer._train_step(x, y, valid, 1e-3)):.3f} ms/step")
    print(f"peak device memory of a step: {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")

    trainer._run_epoch(loader, True, 1)                                  # warm-up
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        trainer._run_epoch(loader, True, 1)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total for e in events) / 1e3
    print(f"one train step through _run_epoch (batching, host augmentation, transfer and "
          f"preprocessing included): "
          f"wall {wall_ms:.1f} ms, device busy {device_ms:.1f} ms "
          f"({100 * device_ms / wall_ms:.1f}%)")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:TOP]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms  {e.count:6d}x  {e.key[:100]}")


if __name__ == "__main__":
    main()
