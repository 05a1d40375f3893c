"""Multichannel vest PCG runner (port of ``experiments/multichannel.py``).

:func:`run` trains one classifier with the sinc beamformer engaged
(``num_channels = len(channels)``), LoRA unless ``random_init``, optionally a frozen
encoder, AdamW at lr 1e-4 and batch 16, with cross-entropy or the contrastive-focal loss;
it scores the test split with the MLP head and, with ``fit_svm``, an SVM probe on the
pooled features, and nests the results under ``mlp`` / ``svm``. The JAX signature, plus
``device`` (default the card) and ``dtype`` (default bfloat16). Under a ``mesh`` the trainer
shards the batches over the ranks (:mod:`..train.classifier`); the test scoring and the SVM
probe run on whole batches on every rank, and only rank 0 appends the record.

The SVM probe needs ``sklearn``, which the card's machine does not have: there
``fit_svm=True`` raises ``ImportError``.
"""

from __future__ import annotations

from functools import partial

import numpy as np
import torch

from ..augment.noise_sources import pcg_noise_bank
from ..augment.pipelines import AugmentConfig
from ..augment.torchaug import augment_multi_pcg_batch
from ..config import WindowSpec
from ..data.vest import vest_dataset
from ..models.build import build_classifier
from ..models.classifier import ClassifierConfig
from ..parallel.mesh import mesh_device
from ..train.classifier import SupervisedTrainer
from ..train.evaluate import evaluate, make_apply_fn, make_encode_fn
from ..train.losses import ContrastiveFocalConfig
from ..train.svm import NeuralSVM
from .common import make_loader, write_result


def run(
    data_dir: str,
    csv_path: str,
    *,
    channels: list[int] | None = None,
    fs: int = 4125,
    window_s: float = 2.0,
    epochs: int = 20,
    augment: bool = True,
    random_init: bool = False,
    lora: bool = True,
    freeze_encoder: bool = False,
    fit_svm: bool = True,
    loss: str = "ce",
    augment_config: AugmentConfig | None = None,
    batch_size: int = 16,
    fold: int = 1,
    optimizer: str = "adamw",
    lr: float = 1e-4,
    max_batches: int | None = None,
    results_json: str | None = None,
    log_dir: str | None = None,
    run_label: str = "",
    mesh=None,
    seed: int = 0,
    device_augment: bool = False,
    encoder_config=None,   # test/CI hook: substitute a small Wav2Vec2Config
    device="cuda",
    dtype: torch.dtype = torch.bfloat16,
) -> dict:
    device = mesh_device(mesh, device)
    channels = channels or [1, 2, 3, 4, 5, 6]
    cfg = augment_config or AugmentConfig()
    window = WindowSpec(window_s=window_s)
    win_len = window.window_len(fs)
    aug_num = 15 if augment else 0

    enc_kw = {"encoder": encoder_config} if encoder_config is not None else {}
    ccfg = ClassifierConfig(num_classes=2, num_channels=len(channels),
                            random_init=random_init, lora=lora and not random_init,
                            freeze_encoder=freeze_encoder, fs=fs, head_hidden=(256,),
                            **enc_kw)
    model = build_classifier(ccfg, seed=seed, device=device, dtype=dtype, train=True)

    # Recorded-noise mixing runs on the card in reference order (after wander/noise) when
    # a bank can be cut from the configured noise directory; the host residual then skips
    # its out-of-order fallback.
    bank = None
    if device_augment and augment and cfg.ephnogram_dir:
        bank_np = pcg_noise_bank(fs, win_len, cfg.ephnogram_dir,
                                 rng=np.random.default_rng(seed))
        if bank_np is not None:
            bank = torch.as_tensor(bank_np, device=device)

    def dataset(subset, augment_num):
        return vest_dataset(data_dir, csv_path, subset, fs_out=fs, window=window,
                            channels=channels, fold=fold, augment_num=augment_num,
                            augment_config=cfg, device_augment=device_augment,
                            recorded_on_device=bank is not None)

    train_ds = dataset("train", aug_num)
    valid_ds = dataset("valid", 0)
    test_ds = dataset("test", 0)

    criterion = (ContrastiveFocalConfig(num_classes=2,
                                        feature_dim=ccfg.encoder.hidden_size)
                 if loss == "contrastive-focal" else None)
    batch_transform = None
    if device_augment and augment:
        batch_transform = partial(augment_multi_pcg_batch, fs=fs, noise_bank=bank)
    trainer = SupervisedTrainer(model, optimizer_name=optimizer, lr=lr,
                                criterion=criterion, classifier_config=ccfg,
                                batch_transform=batch_transform, mesh=mesh, seed=seed,
                                log_dir=log_dir)
    trainer.fit(make_loader(train_ds, batch_size, True, seed, win_len),
                make_loader(valid_ds, batch_size, False, seed, win_len),
                epochs, max_batches)

    metrics = {"mlp": evaluate(make_apply_fn(model),
                               make_loader(test_ds, batch_size, False, seed, win_len),
                               max_batches)}
    if fit_svm:
        svm = NeuralSVM(make_encode_fn(model)).fit(
            make_loader(train_ds, batch_size, False, seed, win_len))
        metrics["svm"] = svm.evaluate(make_loader(test_ds, batch_size, False, seed, win_len))

    record = {
        "channels": channels, "fs": fs, "epochs": epochs, "augment": augment,
        "random_init": random_init, "lora": lora, "freeze_encoder": freeze_encoder,
        "loss": loss, "fold": fold, "run_label": run_label, **metrics,
    }
    write_result(results_json, record, mesh)
    return record
