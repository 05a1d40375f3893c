"""The benchmark's side of the port: build the system under test and feed it.

Everything here goes through the port's own entry points (``Wav2VecClassifier``,
``SupervisedTrainer``, ``make_loader`` / ``Batcher``, ``experiments.cinc._device_prep`` and
``score``); the benchmark only makes the weights and the windows, wraps the iterable it
hands the program, and hooks the model's forward to read what it was given.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from wav2vec_heart_sounds_tpu_torch.models.classifier import ClassifierConfig, Wav2VecClassifier
from wav2vec_heart_sounds_tpu_torch.models.hf_port import config_from_hf

from .configs import ModelConfig
from .weights import served_dtype


def port_config(cfg: ModelConfig, spec: dict, fs: int) -> ClassifierConfig:
    """The port's classifier configuration for a configuration file (random init: the
    weights are loaded afterwards). The encoder's fields are read from the file's HF keys by
    the port's own reader, as a user's checkpoint is, so an architecture key the port does
    not compute stops here with the port's error naming it; the file's routes are set on
    top."""
    routes = spec["precision"]
    encoder = dataclasses.replace(
        config_from_hf(spec), ffn_mega=routes["ffn_route"] == "K4",
        qkv_fuse=routes["attention_route"] == "K3b", conv_fuse=routes["conv_fuse"])
    return ClassifierConfig(num_classes=cfg.num_classes, num_channels=1,
                            head_hidden=cfg.head_hidden, random_init=True, fs=fs,
                            encoder=encoder)


def build_model(ccfg: ClassifierConfig, weights: dict[str, torch.Tensor], dtype: torch.dtype,
                device, train: bool) -> Wav2VecClassifier:
    """The port's classifier on ``device`` in ``dtype``, holding ``weights`` (strictly: every
    leaf by name, each already in the dtype the port serves it in)."""
    with torch.device("meta"):
        model = Wav2VecClassifier(ccfg, dtype)
    model.to_empty(device=device)
    for name, p in model.named_parameters():
        if p.dtype != served_dtype(name, dtype):
            raise TypeError(f"the port serves {name} in {p.dtype}, the benchmark made "
                            f"{served_dtype(name, dtype)}")
    model.load_state_dict(weights, strict=True)
    return model.train(train)


class ArrayDataset:
    """Windows held as one ``[N, L]`` array: what the port's ``Batcher`` gathers from
    (``labels``, ``gather``). ``taken`` (a list, when set) records the indices of every
    gathered batch."""

    def __init__(self, waves: np.ndarray, labels: np.ndarray, patients: np.ndarray | None = None):
        self.waves, self.labels = waves, np.asarray(labels, dtype=np.int64)
        self.patients = ([str(p) for p in patients] if patients is not None
                         else [str(i) for i in range(len(waves))])
        self.taken: list[np.ndarray] | None = None

    def __len__(self) -> int:
        return len(self.waves)

    def gather(self, indices: np.ndarray) -> dict:
        indices = np.asarray(indices, dtype=np.int64)
        if self.taken is not None:
            self.taken.append(indices.copy())
        return {"waveform": self.waves[indices], "label": self.labels[indices].astype(np.int32),
                "patient": [self.patients[i] for i in indices]}


class Feed:
    """The iterable the benchmark hands the program: ``batcher``'s batches until
    ``deadline`` (a ``time.perf_counter`` value) or ``limit`` batches. Records, per batch,
    the seconds spent in the batcher's ``next`` (``wait_s``), its valid rows, and (for a
    consumer that asks for the next batch once it is done with one) the seconds from handing
    a batch out to the next ask (``latency_s``)."""

    def __init__(self, batcher, deadline: float | None = None, limit: int | None = None):
        self.batcher, self.deadline, self.limit = batcher, deadline, limit
        self.batches = self.valid_rows = 0
        self.wait_s: list[float] = []
        self.latency_s: list[float] = []

    def __iter__(self):
        handed, out_at = 0, None
        it = iter(self.batcher)
        while True:
            now = time.perf_counter()
            if out_at is not None:
                self.latency_s.append(now - out_at)
            if (self.deadline is not None and now >= self.deadline) or \
                    (self.limit is not None and handed >= self.limit):
                return
            try:
                batch = next(it)
            except StopIteration:
                return
            out_at = time.perf_counter()
            self.wait_s.append(out_at - now)
            self.batches += 1
            handed += 1
            self.valid_rows += int(np.sum(batch["valid"]))
            yield batch


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)

