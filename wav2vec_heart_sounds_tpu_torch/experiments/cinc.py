"""CinC single-channel PCG / ECG and Training-A PCG+ECG classifier runner (port of
``experiments/cinc.py``).

:func:`run` is the JAX runner in every mode: build the train, valid and test fragments
(host preprocessing, or, for ``mode="pcg"`` only, raw low-rate windows preprocessed on the
card), train a wav2vec2 classifier with :class:`..train.classifier.SupervisedTrainer`
(on-device batch augmentation on the raw wire or with ``device_augment``, mono PCG only),
score the test split at fragment and patient level and append the record to
``results_json``. ``mode="pcg"`` / ``"ecg"`` train one branch on channel 0 / 1;
``mode="pcg_ecg"`` trains the PCG branch, then the ECG branch, then the two-branch fusion
model (:mod:`..models.fusion`, the paper's ``big_rnn:2:wav2vec``) on ``[B, T, 2]``
windows. :func:`run_leave_out_db` trains on every CinC database but one and tests on that
one. :func:`score` is the scoring half alone, on the raw wire. Both runners take the JAX
signatures plus ``device`` (default the card) and ``dtype`` (default bfloat16).

Under a ``mesh`` (:func:`..parallel.mesh.data_parallel_mesh`, one process per card) every
rank builds the same fragments and batches, the models live on the mesh's device, and each
trainer shards the training and validation batches; the test evaluation runs on whole
batches on every rank, as the JAX runner's, and only rank 0 appends the record.
"""

from __future__ import annotations

from functools import partial

import numpy as np
import torch

from ..augment.pipelines import AugmentConfig
from ..augment.torchaug import augment_pcg_batch
from ..config import WindowSpec
from ..data.cinc import build_fragments, build_raw_fragments
from ..data.fragments import FragmentDataset
from ..models.build import build_classifier
from ..models.classifier import ClassifierConfig
from ..models.fusion import two_branch_pcg_ecg
from ..parallel.mesh import mesh_device
from ..signal.torchproc import preprocess_pcg
from ..train.classifier import SupervisedTrainer
from ..train.evaluate import dequant, evaluate, make_apply_fn
from ..utils.observe import span
from .common import make_loader, write_result


def _device_prep(fs_wire: int, fs: int, win_len: int, device):
    """Dequantise + PCG preprocessing on ``device`` + crop to ``win_len``: a host batch's
    copy to ``device`` under the ``batch.h2d`` span (a tensor, as the trainer's prefetch
    thread hands it, has been copied there), the rest under ``prep``."""

    def prep(x) -> torch.Tensor:
        if not torch.is_tensor(x):
            with span("batch.h2d"):
                x = torch.as_tensor(x).to(device)
        with span("prep"):
            x = dequant(x.to(device))
            return preprocess_pcg(x, fs_wire, fs)[:, :win_len]

    return prep


def _branch_config(fs: int, random_init: bool, encoder=None) -> ClassifierConfig:
    kw = {"encoder": encoder} if encoder is not None else {}
    return ClassifierConfig(num_classes=2, num_channels=1, random_init=random_init,
                            fs=fs, **kw)


def _prepped(apply_fn, prep):
    """``apply_fn`` on raw-wire batches: preprocessing on the card first."""
    def apply(x):
        with torch.inference_mode():
            return apply_fn(prep(x))

    return apply


def run(
    data_dir: str,
    csv_path: str,
    *,
    mode: str = "pcg",
    dataset: str = "training-a",
    fs: int = 4125,
    window_s: float = 4.0,
    epochs: int = 20,
    augment: bool = True,
    augment_num: int = 15,
    random_init: bool = False,
    reference_train_rnn: bool = False,
    augment_config: AugmentConfig | None = None,
    batch_size: int = 64,
    fold: int = 1,
    optimizer: str = "sgd",
    lr: float = 1e-3,
    max_batches: int | None = None,
    results_json: str | None = None,
    log_dir: str | None = None,
    run_label: str = "",
    mesh=None,
    seed: int = 0,
    device_augment: bool = False,
    wire: str = "preproc",  # "preproc" (reference parity) | "raw" (low-rate raw wire)
    fs_wire: int = 2000,
    encoder_config=None,   # test/CI hook: substitute a small Wav2Vec2Config
    device="cuda",
    dtype: torch.dtype = torch.bfloat16,
) -> dict:
    cfg = augment_config or AugmentConfig()
    aug_num = augment_num if augment else 0
    # Legacy "reference RNN" regime: half the epochs, augmented validation set.
    train_epochs = max(1, epochs // 2) if reference_train_rnn else epochs
    valid_aug = (aug_num // 2) if (reference_train_rnn and augment) else 0
    window = WindowSpec(window_s=window_s)
    win_len = window.window_len(fs)
    two_branch = mode == "pcg_ecg"
    load_ecg = mode in ("ecg", "pcg_ecg")

    raw_wire = wire == "raw"
    if raw_wire and load_ecg:
        raise ValueError("wire='raw' supports the mono 'pcg' mode only")
    device = mesh_device(mesh, device)
    if raw_wire:
        # Raw wire: un-preprocessed low-rate windows over the host->device link; the
        # preprocessing chain runs on the card per batch and host augment copies are
        # replaced by per-epoch augmentation on the card.
        frags = {s: build_raw_fragments(data_dir, csv_path, s, fs_wire=fs_wire,
                                        window=window, fold=fold)
                 for s in ("train", "valid", "test")}
        if augment and not device_augment:
            device_augment = True   # raw mode's only augmentation path
    else:
        # Under device augmentation (mono PCG only) the host copies are replaced, not
        # stacked on.
        host_aug_num = 0 if (device_augment and not load_ecg) else aug_num
        frags = {
            "train": build_fragments(data_dir, csv_path, "train", fs_out=fs, window=window,
                                     ecg=load_ecg, fold=fold, augment_num=host_aug_num,
                                     augment_config=cfg),
            "valid": build_fragments(data_dir, csv_path, "valid", fs_out=fs, window=window,
                                     ecg=load_ecg, fold=fold, augment_num=valid_aug,
                                     augment_config=cfg),
            "test": build_fragments(data_dir, csv_path, "test", fs_out=fs, window=window,
                                    ecg=load_ecg, fold=fold),
        }

    batch_transform = None
    if device_augment:
        # pristine_prob mirrors the host expansion's untouched-original fraction
        # (1 original per aug_num copies); it overrides the loader row mask since
        # these datasets carry no expansion plan.
        pristine = 1.0 / (aug_num + 1) if aug_num > 0 else None
        batch_transform = partial(augment_pcg_batch, fs=fs, cfg=cfg, pristine_prob=pristine)

    frag_fs = fs_wire if raw_wire else fs
    loader_len = window.window_len(frag_fs)
    device_prep = _device_prep(fs_wire, fs, win_len, device) if raw_wire else None

    def branch(channel: int, label: str):
        bcfg = _branch_config(fs, random_init, encoder_config)
        model = build_classifier(bcfg, seed=seed, device=device, dtype=dtype, train=True)
        valid_channel = 0 if not load_ecg else channel
        train_ds = FragmentDataset(frags["train"], fs=frag_fs, channel=channel)
        valid_ds = FragmentDataset(frags["valid"], fs=frag_fs, channel=valid_channel)
        trainer = SupervisedTrainer(model, optimizer_name=optimizer, lr=lr,
                                    classifier_config=bcfg, mesh=mesh, seed=seed,
                                    log_dir=log_dir,
                                    batch_transform=None if load_ecg else batch_transform,
                                    device_preprocess=device_prep)
        trainer.fit(make_loader(train_ds, batch_size, True, seed, loader_len),
                    make_loader(valid_ds, batch_size, False, seed, loader_len),
                    train_epochs, max_batches, label=label)
        return model

    if two_branch:
        pcg_model = branch(0, "[1/3 PCG branch]")
        ecg_model = branch(1, "[2/3 ECG branch]")
        fusion = two_branch_pcg_ecg(pcg_model, ecg_model, seed=seed + 1)
        trainer = SupervisedTrainer(fusion, optimizer_name=optimizer, lr=lr, mesh=mesh,
                                    seed=seed, log_dir=log_dir)
        train_ds = FragmentDataset(frags["train"], fs=fs, channel=-1)
        valid_ds = FragmentDataset(frags["valid"], fs=fs, channel=-1)
        trainer.fit(make_loader(train_ds, batch_size, True, seed, win_len),
                    make_loader(valid_ds, batch_size, False, seed, win_len),
                    train_epochs, max_batches, label="[3/3 fusion]")
        test_ds = FragmentDataset(frags["test"], fs=fs, channel=-1)
        apply_fn = make_apply_fn(fusion)
        topology = "big_rnn:2:wav2vec"
    else:
        channel = 1 if mode == "ecg" else 0
        model = branch(channel, f"[{mode}]")
        test_ds = FragmentDataset(frags["test"], fs=frag_fs,
                                  channel=channel if load_ecg else 0)
        apply_fn = make_apply_fn(model)
        topology = "wav2vec"

    if device_prep is not None:
        apply_fn = _prepped(apply_fn, device_prep)       # the test set is raw too
    metrics = evaluate(apply_fn, make_loader(test_ds, batch_size, False, seed, loader_len),
                       max_batches)
    record = {
        "mode": mode, "dataset": dataset, "fs": fs, "epochs": epochs,
        "train_epochs": train_epochs, "augment": augment, "augment_num": aug_num,
        "random_init": random_init, "reference_train_rnn": reference_train_rnn,
        "topology": topology, "fold": fold, "run_label": run_label, "wire": wire,
        **metrics,
    }
    write_result(results_json, record, mesh)
    return record


def run_leave_out_db(
    databases: dict[str, tuple[str, str]],
    holdout: str,
    *,
    fs: int = 4125,
    window_s: float = 4.0,
    epochs: int = 20,
    augment: bool = True,
    random_init: bool = False,
    reference_train_rnn: bool = False,
    augment_config: AugmentConfig | None = None,
    batch_size: int = 64,
    optimizer: str = "sgd",
    lr: float = 1e-3,
    max_batches: int | None = None,
    results_json: str | None = None,
    log_dir: str | None = None,
    mesh=None,
    seed: int = 0,
    encoder_config=None,
    device="cuda",
    dtype: torch.dtype = torch.bfloat16,
) -> dict:
    """Train single-channel PCG on every database except ``holdout``; test on ``holdout``."""
    device = mesh_device(mesh, device)
    cfg = augment_config or AugmentConfig()
    window = WindowSpec(window_s=window_s)
    win_len = window.window_len(fs)
    aug_num = 15 if augment else 0
    train_epochs = max(1, epochs // 2) if reference_train_rnn else epochs
    valid_aug = (aug_num // 2) if (reference_train_rnn and augment) else 0

    train_frags, valid_frags = [], []
    for name, (data_dir, csv_path) in databases.items():
        if name == holdout:
            continue
        train_frags += build_fragments(data_dir, csv_path, "train", fs_out=fs, window=window,
                                       augment_num=aug_num, augment_config=cfg)
        valid_frags += build_fragments(data_dir, csv_path, "valid", fs_out=fs, window=window,
                                       augment_num=valid_aug, augment_config=cfg)

    holdout_dir, holdout_csv = databases[holdout]
    test_frags = build_fragments(holdout_dir, holdout_csv, "all", fs_out=fs, window=window)

    bcfg = _branch_config(fs, random_init, encoder_config)
    model = build_classifier(bcfg, seed=seed, device=device, dtype=dtype, train=True)
    trainer = SupervisedTrainer(model, optimizer_name=optimizer, lr=lr, mesh=mesh, seed=seed,
                                log_dir=log_dir)
    trainer.fit(make_loader(FragmentDataset(train_frags, fs=fs, channel=0),
                            batch_size, True, seed, win_len),
                make_loader(FragmentDataset(valid_frags, fs=fs, channel=0),
                            batch_size, False, seed, win_len),
                train_epochs, max_batches)

    metrics = evaluate(make_apply_fn(model),
                       make_loader(FragmentDataset(test_frags, fs=fs, channel=0),
                                   batch_size, False, seed, win_len), max_batches)
    record = {"mode": "pcg", "leave_out_db": holdout, "fs": fs, "epochs": epochs,
              "train_epochs": train_epochs, "augment": augment, "random_init": random_init,
              "reference_train_rnn": reference_train_rnn, **metrics}
    write_result(results_json, record, mesh)
    return record


def score(model: torch.nn.Module, batcher, fs_wire: int, fs: int, win_len: int,
          max_batches: int | None = None) -> dict:
    """Score every batch of raw ``fs_wire`` windows with ``model`` at ``fs``.

    Returns the fragment and patient statistics of :func:`..train.evaluate.evaluate`, plus
    ``logits``: float32 ``[n_batches * batch_size, num_classes]``, every row of every
    batch in order (the padded rows of an eval batcher's last batch included).

    Spans of a batch (while a profiler records): ``batch.gather`` and ``score.tally`` (in
    ``evaluate``), ``batch.h2d``, ``prep`` and ``prep.despike`` (the chain), then
    ``score.forward`` (the forward's enqueue) and ``score.readback`` (the logits' copy to
    the host, which waits for the card).
    """
    device = next(model.parameters()).device
    prep = _device_prep(fs_wire, fs, win_len, device)
    apply = make_apply_fn(model)
    logits: list[np.ndarray] = []

    def apply_fn(x) -> np.ndarray:
        with torch.inference_mode():
            x = prep(x)
            with span("score.forward"):
                z = apply(x)
            with span("score.readback"):
                out = z.float().cpu().numpy()
        logits.append(out)
        return out

    metrics = evaluate(apply_fn, batcher, max_batches)
    return {**metrics, "logits": np.concatenate(logits)}
