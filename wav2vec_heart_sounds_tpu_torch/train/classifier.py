"""Supervised classifier training (port of ``train/classifier.py::SupervisedTrainer``).

The JAX trainer's epoch loop, with its semantics: batches arrive through
``prefetch_threaded`` (the host-to-device copy runs on its side thread), the raw wire is
preprocessed on the device by ``device_preprocess`` and dequantised, and each train step
runs the model's training forward (dropout, SpecAugment), the valid-masked cross-entropy,
the backward through the port's kernels, and the float32-master update
(:class:`..optim.MasterOptimizer`: global-norm clip at 5.0, sgd / adam / adamw, the
per-epoch learning rate of :func:`..optim.lr_schedule`). Losses and predictions stay on
the card until the end of the epoch, so the host never waits on a step. The eval epoch
runs the serving forward under ``torch.inference_mode``. ``fit`` keeps the parameters of
the best validation MCC, restores them at the end and refreshes the float32 master.

On-device batch augmentation: ``batch_transform(generator, x, row_mask=aug)`` runs on the
card after preprocessing and dequantisation, with ``aug`` the loader's per-row replica
flag (``augmented``; all ones when the batches carry none); rows at 0 stay pristine
unless the transform draws its own participation (``pristine_prob``). Per-epoch
confusion-matrix statistics and the training loss go to ``log_dir`` through
:class:`..utils.observe.ScalarLogger`.

Freezing and the feature loss: with ``classifier_config`` the model's frozen parameters
(:func:`..models.classifier.trainable_mask`: the frozen encoder, or the encoder's base
under LoRA) get ``requires_grad=False`` and the optimizer sees only the trainable ones, so
frozen weights are neither clipped, decayed nor updated, as under the JAX package's
optimizer mask. ``criterion`` (a :class:`..losses.ContrastiveFocalConfig`) trains on
``forward_with_features`` with the contrastive-focal loss; its class centres are trainable
float32 parameters of the loss (``loss_params``), updated by the same optimizer; the
best-MCC restore covers the model's parameters only, as the JAX trainer's.

Randomness: one CPU ``torch.Generator`` seeded from ``seed``. It first draws the class
centres (with a ``criterion``); then each train step draws in a fixed order from it: the
augmentation (whose large noise fields come from a card generator seeded from it), then
the forward's dropout seed, then its SpecAugment spans.

Data parallelism (``mesh``, a :class:`..parallel.mesh.Mesh`; JAX ``classifier.py:64-111``):
the model's and the loss's parameters are broadcast from rank 0 at construction; each rank
copies its rows of every (identical) global batch to its card; the logits, features, labels
and valid flags of every rank are gathered (:func:`..parallel.mesh.gather_rows`) and the
loss is the global batch's on every rank, whatever rows are valid where, as under the JAX
mesh; the optimizer averages the gradients over the ranks before its clip. After the class
centres, every rank but 0 reseeds its generator to a stream of its own
(:func:`..parallel.mesh.rank_seed`), so its dropout, spans and augmentation differ from
its neighbours' while rank 0 draws exactly what one process would. Predictions are those of
the gathered logits, so the confusion matrices, the best-MCC choice and the restore are the
same on every rank. Only rank 0 logs and writes scalars.

On-disk checkpoints (JAX ``classifier.py:355-388``): :meth:`SupervisedTrainer.save` writes
the epoch, the model's state, the loss's parameters and the optimizer's (the float32 master
and its moments) as one ``torch.save`` file, by rank 0 under a mesh while the others wait;
:meth:`SupervisedTrainer.restore` reads it on every rank and returns ``False`` when it is
missing. The generator's stream is not in it, as the JAX trainer's key is not.
"""

from __future__ import annotations

import itertools
import os
import time
from typing import Callable

import numpy as np
import torch

from ..data.loader import prefetch_threaded
from ..models.classifier import apply_trainable_mask
from ..parallel.mesh import (gather_rows, is_main, maybe_shard_batch, mesh_device, rank_seed,
                             replicate, save_from_rank0)
from ..utils.observe import ScalarLogger, gathered, span
from .evaluate import dequant
from .losses import (ContrastiveFocalConfig, contrastive_focal_loss, cross_entropy,
                     init_contrastive_focal)
from .metrics import ConfusionMatrix
from .optim import MasterOptimizer, lr_schedule


class SupervisedTrainer:
    def __init__(self, model: torch.nn.Module, *, optimizer_name: str = "sgd",
                 lr: float = 1e-3, weight_decay: float = 1e-5,
                 batch_transform: Callable | None = None,
                 device_preprocess: Callable | None = None,
                 criterion: ContrastiveFocalConfig | None = None,
                 classifier_config=None, mesh=None, seed: int = 0,
                 log: Callable[[str], None] = print, log_dir: str | None = None):
        self.model = model
        self.device = mesh_device(mesh, next(model.parameters()).device)
        self.mesh = mesh
        self.batch_transform = batch_transform
        self.device_preprocess = device_preprocess
        self.criterion = criterion
        self.log = log if is_main(mesh) else (lambda line: None)
        self.scalars = ScalarLogger(log_dir if is_main(mesh) else None)
        self.generator = torch.Generator().manual_seed(seed)
        self.loss_params = ({} if criterion is None
                            else init_contrastive_focal(self.generator, criterion, self.device))
        if not is_main(mesh):                  # after the centres: a stream of its own
            self.generator.manual_seed(rank_seed(seed, mesh))
        replicate(model, mesh)
        replicate(self.loss_params, mesh)
        params = (list(model.parameters()) if classifier_config is None
                  else apply_trainable_mask(model, classifier_config))
        self.optimizer = MasterOptimizer(params + list(self.loss_params.values()),
                                         optimizer_name, weight_decay, mesh=mesh)
        self.schedule = lr_schedule(optimizer_name, lr)
        self.epoch = 0

    def _to_device(self, batch: dict, want_aug: bool = False):
        """Runs on the prefetch thread: the host-to-device copies (of this rank's rows under a
        mesh) overlap the card's work."""
        def put(a):
            return maybe_shard_batch(a, self.mesh, self.device)

        aug = None
        if want_aug:
            mask = batch.get("augmented")
            aug = put(np.ones(len(batch["valid"]), dtype=np.float32) if mask is None
                      else np.asarray(mask, dtype=np.float32))
        return (batch, put(batch["waveform"]), put(batch["label"]),
                put(np.asarray(batch["valid"], dtype=np.float32)), aug)

    def _train_step(self, x, y, valid, lr: float, aug=None):
        with span("step.forward"):
            if self.batch_transform is not None:
                with torch.no_grad():
                    x = self.batch_transform(self.generator, x, row_mask=aug)
            self.optimizer.zero_grad()
            loss, logits = self._loss(x, y, valid, train=True)
        with span("step.backward"):
            loss.backward()
        with span("step.optimizer"):
            self.optimizer.step(lr)
        return loss.detach(), logits.detach().argmax(dim=1)

    def _loss(self, x, y, valid, train: bool):
        """(loss, logits) of the global batch: cross-entropy, or the contrastive-focal loss on
        the features; under a mesh on every rank's gathered rows."""
        kw = {"train": True, "generator": self.generator} if train else {}
        y, valid = gather_rows(y, self.mesh), gather_rows(valid, self.mesh)
        if self.criterion is None:
            logits = gather_rows(self.model(x, **kw), self.mesh)
            return cross_entropy(logits, y, valid), logits
        feats, logits = (gather_rows(t, self.mesh)
                         for t in self.model.forward_with_features(x, **kw))
        return contrastive_focal_loss(self.loss_params, self.criterion, feats, logits, y,
                                      valid), logits

    def _eval_step(self, x, y, valid):
        with torch.inference_mode():
            loss, logits = self._loss(x, y, valid, train=False)
            return loss, logits.argmax(dim=1)

    def _run_epoch(self, batcher, train: bool, max_batches: int | None
                   ) -> tuple[ConfusionMatrix, float]:
        """One epoch; the device syncs wait until its end. ``max_batches`` cuts the batcher
        before the prefetch thread, so that thread has finished its last host->device copy
        when the epoch returns (a thread still copying when the interpreter exits aborts
        it).

        Spans of a batch (while a profiler records): on the prefetch thread ``batch.gather``
        (the batcher's ``next()``, which starts the batch's serial) and ``batch.h2d``; on this
        thread ``batch.wait`` (for the prefetched batch; the serial comes with it), ``prep``
        and ``prep.despike`` (``device_preprocess``), and in a train step ``step.forward``,
        ``step.backward`` and ``step.optimizer``."""
        cm = ConfusionMatrix()
        pending = []
        lr = self.schedule(self.epoch)
        self.model.train(train)
        want_aug = train and self.batch_transform is not None

        def to_device(item):
            serial, batch = item
            with span("batch.h2d", serial):
                return serial, *self._to_device(batch, want_aug)

        batches = batcher if max_batches is None else itertools.islice(batcher, max_batches)
        items = prefetch_threaded(gathered(batches), to_device)
        while True:
            with span("batch.wait") as wait:
                item = next(items, None)
                wait.batch = None if item is None else item[0]
            if item is None:
                break
            _, batch, x, y, valid, aug = item
            with torch.no_grad():
                if self.device_preprocess is not None:
                    x = self.device_preprocess(x)
                x = dequant(x)
            step = (self._train_step(x, y, valid, lr, aug) if train
                    else self._eval_step(x, y, valid))
            pending.append((*step, batch["label"], batch["valid"]))
        running = 0.0
        for loss, preds, labels, valid in pending:
            cm.update(labels, preds.cpu().numpy(), valid)
            running += float(loss)
        return cm, running / max(1, len(pending))

    def fit(self, train_batcher, valid_batcher, epochs: int,
            max_batches: int | None = None, label: str = "") -> float:
        """Train ``epochs`` epochs; with a ``valid_batcher``, keep and finally restore the
        parameters of the best validation MCC. Returns that MCC (-1.0 without one)."""
        best_mcc, best = -1.0, None
        prefix = f"{label} " if label else ""
        tag = label.strip("[] ").replace(" ", "_") or "run"
        for epoch in range(1, epochs + 1):
            t0 = time.time()
            train_cm, train_loss = self._run_epoch(train_batcher, True, max_batches)
            self.epoch += 1
            line = (f"{prefix}epoch {epoch}/{epochs}: loss={train_loss:.3f} "
                    f"train {train_cm} [{time.time() - t0:.1f}s]")
            self.scalars.scalars(f"{tag}/train", train_cm.stats(), self.epoch)
            self.scalars.scalar(f"{tag}/train_loss", train_loss, self.epoch)
            if valid_batcher is not None:
                valid_cm, _ = self._run_epoch(valid_batcher, False, max_batches)
                mcc = valid_cm.stats()["mcc"]
                line += f" | valid {valid_cm}"
                self.scalars.scalars(f"{tag}/valid", valid_cm.stats(), self.epoch)
                if mcc > best_mcc:
                    best_mcc = mcc
                    best = {k: v.detach().clone() for k, v in self.model.state_dict().items()}
            self.log(line)
        self.scalars.flush()
        if valid_batcher is not None and best is not None:
            self.model.load_state_dict(best)
            self.optimizer.refresh()
        return best_mcc

    def save(self, path: str) -> str:
        """Write the checkpoint to ``path`` (rank 0 under a mesh; every rank returns once the
        file is written)."""
        return save_from_rank0({"epoch": self.epoch, "model": self.model.state_dict(),
                                "loss_params": {k: v.detach()
                                                for k, v in self.loss_params.items()},
                                "optimizer": self.optimizer.state_dict()}, path, self.mesh)

    def restore(self, path: str) -> bool:
        """Load a :meth:`save` checkpoint; ``False`` when ``path`` does not exist."""
        if not path or not os.path.exists(path):
            return False
        payload = torch.load(path, map_location=self.device, weights_only=True)
        self.model.load_state_dict(payload["model"])
        with torch.no_grad():
            for name, value in payload["loss_params"].items():
                self.loss_params[name].copy_(value)
        self.optimizer.load_state_dict(payload["optimizer"])
        self.epoch = int(payload["epoch"])
        return True
