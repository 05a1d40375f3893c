#!/usr/bin/env python3
"""bfloat16 against float32 training curves of the CinC classifier on one CUDA card, over
several generator seeds.

    python3 scripts/torch_precision_curves.py [--steps 40] [--seeds 3]

Builds ``chip_smoke.py``'s training configuration (full-width wav2vec2-base, the 512x3 head,
SGD with momentum at lr 1e-3, B = 96 raw 2 kHz int16 windows preprocessed on the card, every
dropout and SpecAugment on) from one weight seed, in float32 and in bfloat16 compute (bf16
live matmul weights under the float32 master). For each generator seed (its dropout seeds
and SpecAugment spans) both dtypes train one epoch of ``--steps`` steps through
``SupervisedTrainer.fit`` on the same batches. The deciding measure is each run's mean loss
over its steps: bf16's gap to float32 on the same seed, against float32's own spread over
the seeds (the largest minus the smallest of its means). The gap lies inside the spread when
every seed's |bf16 - float32| is at most that spread. Prints every step's losses, the means,
the gaps and the spread, each run's seconds, and one JSON line with the curves.
"""

from __future__ import annotations

import argparse
import functools
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from wav2vec_heart_sounds_tpu_torch.data.fragments import FragmentDataset  # noqa: E402
from wav2vec_heart_sounds_tpu_torch.experiments.cinc import _device_prep  # noqa: E402
from wav2vec_heart_sounds_tpu_torch.experiments.common import make_loader  # noqa: E402
from wav2vec_heart_sounds_tpu_torch.models.build import build_classifier  # noqa: E402
from wav2vec_heart_sounds_tpu_torch.train.classifier import SupervisedTrainer  # noqa: E402

DTYPES = {"float32": torch.float32, "bf16": torch.bfloat16}


def train(dtype: torch.dtype, frags, steps: int, seed: int) -> tuple[list[float], float]:
    """One epoch of ``steps`` steps from weight seed 0 and generator seed ``seed``: (losses,
    seconds)."""
    model = build_classifier(chip_smoke.classifier_config(), seed=0, device="cuda", dtype=dtype,
                             train=True)
    win_len = int(chip_smoke.WINDOW_S * chip_smoke.FS)
    trainer = SupervisedTrainer(
        model, optimizer_name="sgd", lr=1e-3, seed=seed, log=lambda line: None,
        device_preprocess=_device_prep(chip_smoke.FS_WIRE, chip_smoke.FS, win_len, "cuda"))
    losses = []
    trainer._train_step = functools.partial(chip_smoke.step_and_keep, trainer._train_step,
                                            losses)
    batches = make_loader(FragmentDataset(frags, fs=chip_smoke.FS_WIRE), chip_smoke.TRAIN_BATCH,
                          train=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer.fit(batches, None, 1, max_batches=steps)
    torch.cuda.synchronize()
    return [float(v) for v in losses], time.perf_counter() - t0


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--steps", type=int, default=40)
    parser.add_argument("--seeds", type=int, default=3)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_precision_curves: this needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    windows = args.steps * chip_smoke.TRAIN_BATCH
    patients = -(-windows // chip_smoke.TRAIN_WINDOWS)
    frags = chip_smoke.synthetic_recordings(1, patients, chip_smoke.TRAIN_WINDOWS)
    runs = {(name, seed): train(dtype, frags, args.steps, seed)
            for seed in range(args.seeds) for name, dtype in DTYPES.items()}
    print(f"[curves] {card}; {args.steps} steps of B={chip_smoke.TRAIN_BATCH}, SGD lr 1e-3, "
          f"dropout and SpecAugment on; seconds " + ", ".join(
              f"{name} seed {seed} {run[1]:.1f}" for (name, seed), run in runs.items()))
    for i in range(args.steps):
        print(f"[curves] step {i:3d}: " + "; ".join(
            f"seed {seed} " + " ".join(f"{name} {runs[name, seed][0][i]:.6f}" for name in DTYPES)
            for seed in range(args.seeds)))
    means = {key: float(np.mean(run[0])) for key, run in runs.items()}
    f32 = [means["float32", seed] for seed in range(args.seeds)]
    spread = max(f32) - min(f32)
    gaps = [means["bf16", seed] - means["float32", seed] for seed in range(args.seeds)]
    for seed, gap in enumerate(gaps):
        print(f"[curves] seed {seed}: mean loss over steps 0-{args.steps - 1} float32 "
              f"{means['float32', seed]!r}, bf16 {means['bf16', seed]!r}; gap {gap!r} "
              f"({gap / means['float32', seed]:+.2%})")
    inside = all(abs(gap) <= spread for gap in gaps)
    print(f"[curves] float32's spread over the seeds {spread!r} "
          f"({spread / np.mean(f32):.2%} of its mean); bf16's gap inside it: {inside}")
    print(json.dumps({"card": card, "steps": args.steps, "spread": spread, "gaps": gaps,
                      "inside": inside,
                      "runs": {f"{name} seed {seed}": {"losses": run[0], "mean": means[name, seed],
                                                        "seconds": run[1]}
                               for (name, seed), run in runs.items()}}))


if __name__ == "__main__":
    main()
