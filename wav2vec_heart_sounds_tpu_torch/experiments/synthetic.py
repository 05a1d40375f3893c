"""Synthetic-augmentation schedule runner, single-channel PCG (port of
``experiments/synthetic.py``).

One classifier and one trainer persist across an ordered stage schedule interleaving real
CinC data and generated (DiffWave/WaveGrad) data: each stage builds its fragments, wraps them
with the stage's ``augment_num`` and lazy PCG augmentation, and fits against a fixed
validation set (the best-MCC restore happens inside each fit); the final evaluation is on the
schedule's test set. As in the JAX runner, ``proportion`` subsamples real datasets too (a
seeded patient-level subsample), and a ``letskip`` stage is skipped when the previous stage
did not improve the best validation MCC. :func:`subsample_patients` and
:func:`source_fragments` are copies of the originals. :func:`run` takes the JAX signature plus
``device`` (default the card) and ``dtype`` (default bfloat16); under a ``mesh`` the trainer
shards the batches over the ranks, the test evaluation runs on whole batches on every rank,
and only rank 0 appends the record.
"""

from __future__ import annotations

from functools import partial

import numpy as np
import torch

from ..augment.pipelines import AugmentConfig
from ..config import WindowSpec
from ..data.cinc import build_fragments, pcg_augment
from ..data.fragments import Fragment, FragmentDataset
from ..data.generated import generated_fragments
from ..data.schedule import Schedule, SourceSpec, load_schedule
from ..models.build import build_classifier
from ..models.classifier import ClassifierConfig
from ..parallel.mesh import mesh_device
from ..train.classifier import SupervisedTrainer
from ..train.evaluate import evaluate, make_apply_fn
from .common import make_loader, write_result


def subsample_patients(fragments: list[Fragment], proportion: float,
                       seed: int = 0) -> list[Fragment]:
    """Keep a seeded ``proportion`` of source patients (augmented copies follow their base)."""
    if proportion >= 1.0 or not fragments:
        return fragments
    patients = sorted({f.patient.split("#aug")[0] for f in fragments})
    rng = np.random.default_rng(seed)
    keep = set(rng.permutation(patients)[:max(1, round(len(patients) * proportion))])
    return [f for f in fragments if f.patient.split("#aug")[0] in keep]


def source_fragments(source: SourceSpec, fs: int, window, seed: int = 0) -> list[Fragment]:
    """Fragments of one schedule source: generated manifest or real CinC records."""
    if source.gen_data:
        return generated_fragments(source.path, fs_out=fs, window=window,
                                   proportion=source.proportion, seed=seed)
    frags = build_fragments(source.path, source.split, "train", fs_out=fs, window=window,
                            ecg=False)
    return subsample_patients(frags, source.proportion, seed)


def run(
    schedule_path: str,
    *,
    fs: int = 4125,
    window_s: float = 4.0,
    random_init: bool = False,
    augment_config: AugmentConfig | None = None,
    batch_size: int = 64,
    optimizer: str = "sgd",
    lr: float = 1e-3,
    max_batches: int | None = None,
    results_json: str | None = None,
    log_dir: str | None = None,
    run_label: str = "",
    mesh=None,
    seed: int = 0,
    encoder_config=None,   # test/CI hook: substitute a small Wav2Vec2Config
    device="cuda",
    dtype: torch.dtype = torch.bfloat16,
) -> dict:
    device = mesh_device(mesh, device)
    schedule: Schedule = load_schedule(schedule_path)
    cfg = augment_config or AugmentConfig()
    window = WindowSpec(window_s=window_s)
    win_len = window.window_len(fs)
    augment_fn = partial(pcg_augment, cfg=cfg)

    valid_frags = build_fragments(schedule.valid_set.data, schedule.valid_set.split,
                                  "valid", fs_out=fs, window=window, ecg=False)
    test_frags = build_fragments(schedule.test_set.data, schedule.test_set.split,
                                 "test", fs_out=fs, window=window, ecg=False)
    valid_loader = make_loader(FragmentDataset(valid_frags, fs=fs), batch_size, False,
                               seed, win_len)
    test_loader = make_loader(FragmentDataset(test_frags, fs=fs), batch_size, False,
                              seed, win_len)

    enc_kw = {"encoder": encoder_config} if encoder_config is not None else {}
    ccfg = ClassifierConfig(num_classes=2, num_channels=1, random_init=random_init, fs=fs,
                            **enc_kw)
    model = build_classifier(ccfg, seed=seed, device=device, dtype=dtype, train=True)
    trainer = SupervisedTrainer(model, optimizer_name=optimizer, lr=lr,
                                classifier_config=ccfg, mesh=mesh, seed=seed, log_dir=log_dir)

    best_mcc = -1.0
    improved = True           # the first stage always runs
    skipped: list[str] = []
    for spec, epochs, letskip in schedule.resolved_stages():
        if letskip and not improved:
            trainer.log(f"[{spec.name}] letskip: no validation improvement last stage, "
                        "skipping")
            skipped.append(spec.name)
            continue
        frags = [f for source in spec.sources
                 for f in source_fragments(source, fs, window, seed)]
        stage_ds = FragmentDataset(frags, fs=fs, augment_num=spec.augment_num,
                                   augment_fn=augment_fn)
        stage_mcc = trainer.fit(make_loader(stage_ds, batch_size, True, seed, win_len),
                                valid_loader, epochs, max_batches, label=f"[{spec.name}]")
        improved = stage_mcc > best_mcc
        best_mcc = max(best_mcc, stage_mcc)

    metrics = evaluate(make_apply_fn(model), test_loader, max_batches)
    record = {"schedule": schedule_path, "fs": fs, "random_init": random_init,
              "run_label": run_label, "skipped_stages": skipped, **metrics}
    write_result(results_json, record, mesh)
    return record
