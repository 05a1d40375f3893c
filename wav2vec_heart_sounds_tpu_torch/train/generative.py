"""Diffusion-vocoder training: epsilon-prediction L1, one step at a time, checkpoints on disk
(port of ``train/generative.py``).

Both models train by L1 epsilon-prediction; only how the noisy input and the model call are
formed differs (a per-model *loss strategy*, ``loss(model, batch, generator, draws=None)``).
A strategy draws its randomness from ``generator`` (on its device) or takes it as given
tensors (``draws``: ``(t, noise)`` for DiffWave, ``(s, u, noise)`` for WaveGrad; the tests
pass the JAX strategy's own draws). :class:`GenBatcher` is a copy of the original.

:class:`GenerativeTrainer` keeps the JAX trainer's machinery: a global-norm clip at 1.0 and
plain Adam (optax's defaults, no weight decay) through :class:`..optim.MasterOptimizer`
(float32 master), the non-finite-loss raise, ``scalars.jsonl`` in ``log_dir``, per-epoch
``weights`` and best-validation ``weights-best`` checkpoints (model, optimizer and step,
``torch.save``; ``<model_dir>/<name>.pt``) with :meth:`~GenerativeTrainer.restore`, and the
periodic generated-sample WAV from a fixed conditioner batch.

Data parallelism (``mesh``; JAX ``generative.py:96-127``): the parameters are broadcast
from rank 0, each rank takes its rows of every batch (and of injected ``draws``) and draws
from a card generator of its own (rank 0's is the one-process stream,
:func:`..parallel.mesh.rank_seed`), and the optimizer averages the gradients over the ranks.
The L1 loss is a mean over equal shards, so that average is the global batch's gradient with
no gather; the losses that ``train_step`` and ``validate`` return are averaged the same way.
Only rank 0 logs and has a ``log_dir`` (scalars and samples), and only it writes checkpoints;
``save`` returns on every rank once the file is written.
"""

from __future__ import annotations

import json
import os
import time
from typing import Callable

import numpy as np
import torch

from ..parallel.mesh import (all_reduce_mean, is_main, maybe_shard_batch, mesh_device,
                             rank_seed, replicate, save_from_rank0)
from .optim import MasterOptimizer

MAX_GRAD_NORM = 1.0                       # the JAX generative trainer's clip


def _normal(generator: torch.Generator, like: torch.Tensor) -> torch.Tensor:
    return torch.randn(like.shape, generator=generator,
                       device=generator.device).to(like.device)


def diffwave_loss(model, batch: dict, generator: torch.Generator | None = None,
                  draws=None) -> torch.Tensor:
    """Discrete-step strategy: t ~ U{0..N-1}; noisy = sqrt(l_t)*ref + sqrt(1-l_t)*eps."""
    ref, con, label = batch["ref_audio"], batch["con_spec"], batch["label"]
    levels = torch.as_tensor(model.config.training_schedule().training_noise_levels(),
                             dtype=torch.float32, device=ref.device)
    if draws is None:
        t = torch.randint(0, len(levels), (ref.shape[0],), generator=generator,
                          device=generator.device).to(ref.device)
        noise = _normal(generator, ref)
    else:
        t, noise = (torch.as_tensor(d).to(ref.device) for d in draws)
    t = t.long()
    scale = levels[t][:, None]
    noisy = torch.sqrt(scale) * ref + torch.sqrt(1.0 - scale) * noise
    predicted = model(noisy, t, con, label)
    return torch.mean(torch.abs(predicted - noise))


def wavegrad_loss(model, batch: dict, generator: torch.Generator | None = None,
                  draws=None) -> torch.Tensor:
    """Continuous-level strategy: level ~ U(l_{s-1}, l_s); noisy = l*ref + sqrt(1-l^2)*eps."""
    ref, con, label = batch["ref_audio"], batch["con_spec"], batch["label"]
    levels = torch.as_tensor(model.config.training_schedule().continuous_noise_levels(),
                             dtype=torch.float32, device=ref.device)
    steps = len(levels) - 1
    if draws is None:
        on = {"generator": generator, "device": generator.device}
        s = torch.randint(1, steps + 1, (ref.shape[0],), **on).to(ref.device)
        u = torch.rand((ref.shape[0],), **on).to(ref.device)
        noise = _normal(generator, ref)
    else:
        s, u, noise = (torch.as_tensor(d).to(ref.device) for d in draws)
    s = s.long()
    lo, hi = levels[s - 1], levels[s]
    scale = (lo + u * (hi - lo))[:, None]
    noisy = scale * ref + torch.sqrt(1.0 - scale ** 2) * noise
    predicted = model(noisy, con, scale[:, 0], label)
    return torch.mean(torch.abs(predicted - noise))


class GenBatcher:
    """Stack fixed-length generator items into device-ready numpy batches."""

    def __init__(self, dataset, batch_size: int, shuffle: bool, seed: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0

    def __len__(self) -> int:
        return max(1, len(self.dataset) // self.batch_size) \
            if len(self.dataset) >= self.batch_size else 1

    def __iter__(self):
        n = len(self.dataset)
        idx = np.arange(n)
        if self.shuffle:
            np.random.default_rng(self.seed + self.epoch).shuffle(idx)
        self.epoch += 1
        bs = min(self.batch_size, n)
        for b in range(max(1, n // bs)):
            chunk = idx[b * bs:(b + 1) * bs]
            if len(chunk) < bs:
                break
            items = [self.dataset[int(i)] for i in chunk]
            yield {
                "ref_audio": np.stack([it["ref_audio"] for it in items]),
                "con_spec": np.stack([it["con_spec"] for it in items]),
                "label": np.asarray([it["label"] for it in items], dtype=np.int32),
                "patient": [it["patient"] for it in items],
            }


class GenerativeTrainer:
    def __init__(self, model: torch.nn.Module, loss_strategy: Callable, model_dir: str, *,
                 lr: float = 2e-4, sampler=None, sample_every: int = 10,
                 log_dir: str | None = None, seed: int = 0,
                 log: Callable[[str], None] = print, mesh=None):
        self.model = model
        self.device = mesh_device(mesh, next(model.parameters()).device)
        self.mesh = mesh
        self.loss_strategy = loss_strategy
        self.model_dir = model_dir
        self.sampler = sampler
        self.sample_every = sample_every
        self.log = log if is_main(mesh) else (lambda line: None)
        self.log_dir = log_dir if is_main(mesh) else None     # rank 0's scalars and samples
        # every rank draws the sample batch: drawing it advances a shuffling batcher's epoch
        self.draws_sample = bool(log_dir) and sampler is not None
        self.generator = torch.Generator(device=self.device).manual_seed(rank_seed(seed, mesh))
        self.step = 0
        self.best_valid = float("inf")
        os.makedirs(model_dir, exist_ok=True)
        if self.log_dir:
            os.makedirs(self.log_dir, exist_ok=True)
        replicate(model, mesh)
        self.optimizer = MasterOptimizer(model.parameters(), "adam", weight_decay=0.0,
                                         max_grad_norm=MAX_GRAD_NORM, mesh=mesh)
        self.lr = lr

    def _device(self, batch: dict) -> dict:
        return {k: maybe_shard_batch(v, self.mesh, self.device)
                for k, v in batch.items() if k != "patient"}

    def _mean(self, loss: torch.Tensor) -> float:
        """The loss averaged over the ranks (itself without a mesh)."""
        loss = loss.detach().reshape(1)
        if self.mesh is not None:
            all_reduce_mean([loss], self.mesh)
        return float(loss)

    def train_step(self, batch: dict, draws=None) -> float:
        if draws is not None:
            draws = tuple(maybe_shard_batch(d, self.mesh, self.device) for d in draws)
        self.optimizer.zero_grad()
        loss = self.loss_strategy(self.model, self._device(batch), self.generator, draws)
        loss.backward()
        self.optimizer.step(self.lr)
        self.step += 1
        return self._mean(loss)

    @torch.no_grad()
    def validate(self, batcher, max_batches: int | None = None) -> float:
        total, count = 0.0, 0
        for i, batch in enumerate(batcher):
            total += self._mean(self.loss_strategy(self.model, self._device(batch),
                                                   self.generator))
            count += 1
            if max_batches is not None and i + 1 >= max_batches:
                break
        return total / max(1, count)

    def train(self, train_batcher, epochs: int, valid_batcher=None,
              max_train_batches: int | None = None):
        name = type(self.model).__name__
        sample_batch = next(iter(train_batcher)) if self.draws_sample else None
        for epoch in range(1, epochs + 1):
            running, n = 0.0, 0
            t0 = time.time()
            for i, batch in enumerate(train_batcher):
                loss = self.train_step(batch)
                if not np.isfinite(loss):
                    raise RuntimeError(f"non-finite loss at step {self.step}")
                running += loss
                n += 1
                if max_train_batches is not None and i + 1 >= max_train_batches:
                    break
            train_loss = running / max(1, n)
            msg = f"{name} epoch {epoch}/{epochs}: train L1={train_loss:.4f}"
            self._scalar(epoch, "train_L1", train_loss)
            if valid_batcher is not None:
                valid_loss = self.validate(valid_batcher, max_train_batches)
                msg += f" valid L1={valid_loss:.4f}"
                self._scalar(epoch, "valid_L1", valid_loss)
                if valid_loss < self.best_valid:
                    self.best_valid = valid_loss
                    self.save("weights-best")
            self._log_sample(epoch, sample_batch)
            self.log(msg + f" [{time.time() - t0:.1f}s]")
            self.save("weights")

    # --- observability ----------------------------------------------------

    def _scalar(self, epoch: int, tag: str, value: float) -> None:
        if not self.log_dir:
            return
        with open(os.path.join(self.log_dir, "scalars.jsonl"), "a") as fh:
            fh.write(json.dumps({"epoch": epoch, "tag": f"gen/{tag}",
                                 "value": value, "step": self.step}) + "\n")

    def _log_sample(self, epoch: int, sample_batch) -> None:
        """Periodically generate one clip from a fixed conditioner and write it to log_dir."""
        if sample_batch is None or not self.log_dir or epoch % self.sample_every:
            return
        from scipy.io import wavfile

        from ..signal.normalize import abs_max_normalise

        audio, sr = self.sampler(self.model, sample_batch["con_spec"][:1],
                                 int(sample_batch["label"][0]), self.generator)
        wave = abs_max_normalise(audio[0].float().cpu().numpy()).astype(np.float32)
        wavfile.write(os.path.join(self.log_dir, f"sample_e{epoch}.wav"), sr, wave)

    # --- checkpointing ------------------------------------------------------

    def save(self, name: str) -> str:
        return save_from_rank0({"step": self.step, "model": self.model.state_dict(),
                                "optimizer": self.optimizer.state_dict()},
                               os.path.join(self.model_dir, f"{name}.pt"), self.mesh)

    def restore(self, path: str) -> bool:
        if not path or not os.path.exists(path):
            return False
        payload = torch.load(path, map_location=self.device, weights_only=True)
        self.model.load_state_dict(payload["model"])
        self.optimizer.load_state_dict(payload["optimizer"])
        self.step = int(payload["step"])
        return True
