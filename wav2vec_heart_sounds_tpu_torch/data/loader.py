"""Host-side batching: balanced sampling, static-shape padded batches, threaded prefetch.

Copy of ``pad_batch``, ``Batcher`` and ``prefetch_threaded`` from
``wav2vec_heart_sounds_tpu/data/loader.py`` (numpy and the standard library only), held to
the original by ``tests/test_torch_imports.py``. Batches stay numpy; the trainer moves
them to the card inside ``prefetch_threaded``'s transform, on its side thread.
:func:`prefetch_to_device` is the JAX package's double buffer on the calling thread.
"""

from __future__ import annotations

from typing import Iterable, Iterator

import numpy as np

from ..config import WIRE_SCALE
from .labels import balance_weights


def pad_batch(waves: list[np.ndarray], target_len: int | None = None) -> np.ndarray:
    """Zero-pad ``[T]`` / ``[T, C]`` items to a common length and stack to ``[B, L(, C)]``."""
    max_len = max(w.shape[0] for w in waves)
    length = target_len or max_len
    multi = waves[0].ndim == 2
    shape = (len(waves), length, waves[0].shape[1]) if multi else (len(waves), length)
    out = np.zeros(shape, dtype=np.float32)
    for i, w in enumerate(waves):
        n = min(w.shape[0], length)
        out[i, :n] = w[:n]
    return out


class Batcher:
    """Iterate fixed-shape batches over a FragmentDataset-like sequence.

    ``train=True`` draws a class-balanced bootstrap (one epoch = len(dataset) draws with
    replacement, equal class probability); ``train=False`` iterates in order, padding the last
    batch by repeating its final item so shapes stay static (the repeated rows carry
    ``valid=False`` and are ignored by metric accumulation).

    ``wire_int16=True`` ships waveforms as int16 (values scaled by 32767); the consumer
    dequantises on the device.
    """

    def __init__(self, dataset, batch_size: int, train: bool, *, seed: int = 0,
                 target_len: int | None = None, drop_last: bool = False,
                 wire_int16: bool = False):
        self.dataset = dataset
        self.batch_size = batch_size
        self.train = train
        self.seed = seed
        self.epoch = 0
        self.target_len = target_len
        self.drop_last = drop_last
        self.wire_int16 = wire_int16

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.train:
            return max(1, n // self.batch_size)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _epoch_indices(self) -> np.ndarray:
        n = len(self.dataset)
        if not self.train:
            return np.arange(n)
        rng = np.random.default_rng(self.seed + self.epoch)
        w = balance_weights(self.dataset.labels)
        # at least one full batch even for tiny datasets (bootstrap with replacement)
        draws = max(n, self.batch_size)
        return rng.choice(n, size=draws, replace=True, p=w / w.sum())

    def __iter__(self) -> Iterator[dict]:
        idx = self._epoch_indices()
        self.epoch += 1
        bs = self.batch_size
        n_batches = len(self)
        for b in range(n_batches):
            chunk = idx[b * bs:(b + 1) * bs]
            valid = np.ones(bs, dtype=bool)
            if len(chunk) < bs:                      # eval tail: repeat last item, mark invalid
                valid[len(chunk):] = False
                chunk = np.concatenate([chunk, np.full(bs - len(chunk), chunk[-1])])
            if hasattr(self.dataset, "gather"):
                batch = self.dataset.gather(chunk)
                waves, labels, patients = batch["waveform"], batch["label"], batch["patient"]
                augmented = batch.get("augmented")
                if self.target_len is not None and waves.shape[1] != self.target_len:
                    waves = pad_batch(list(waves), self.target_len)
            else:
                items = [self.dataset[int(i)] for i in chunk]
                waves = pad_batch([it["waveform"] for it in items], self.target_len)
                labels = np.asarray([it["label"] for it in items], dtype=np.int32)
                patients = [it["patient"] for it in items]
                augmented = np.asarray([it.get("augmented", False) for it in items])
            if self.wire_int16:
                waves = np.clip(np.round(waves * WIRE_SCALE), -32767, 32767).astype(np.int16)
            out = {
                "waveform": waves,
                "label": labels,
                "patient": patients,
                "valid": valid,
            }
            if augmented is not None:
                out["augmented"] = np.asarray(augmented, dtype=bool)
            yield out


def prefetch_threaded(iterator: Iterable, transform=None, depth: int = 2) -> Iterator:
    """Background-thread prefetch: batch assembly (and an optional transform, e.g. the
    host->device transfer) runs ahead of consumption on a side thread, overlapping with
    device compute. Order-preserving; worker exceptions re-raise at the consumer."""
    import queue as queue_mod
    import threading

    q: "queue_mod.Queue" = queue_mod.Queue(maxsize=depth)
    stop = object()
    cancelled = threading.Event()
    failure: list[BaseException] = []

    def put(item) -> bool:
        # Bounded put that aborts when the consumer abandoned the generator (e.g. a
        # max_batches break) — otherwise the worker blocks forever on the full queue,
        # leaking the thread and ~depth device-resident batches per abandoned epoch.
        while not cancelled.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue_mod.Full:
                continue
        return False

    def worker():
        try:
            for item in iterator:
                if not put(transform(item) if transform is not None else item):
                    return
        except BaseException as exc:   # noqa: BLE001 — re-raised at the consumer
            failure.append(exc)
        finally:
            put(stop)

    threading.Thread(target=worker, daemon=True).start()
    try:
        while True:
            item = q.get()
            if item is stop:
                if failure:
                    raise failure[0]
                return
            yield item
    finally:
        cancelled.set()


def prefetch_to_device(iterator: Iterable[dict], size: int = 2,
                       device="cuda") -> Iterator[dict]:
    """Move array leaves to ``device`` ahead of consumption (the JAX package's double buffer):
    ``size`` batches in flight, copied from pinned host memory without blocking on the card.
    Strings (patient ids) and ``valid`` stay host-side."""
    import collections

    import torch

    device = torch.device(device)
    queue = collections.deque()

    def put_leaf(v):
        t = torch.from_numpy(np.ascontiguousarray(v))
        if device.type == "cuda":
            return t.pin_memory().to(device, non_blocking=True)
        return t.to(device)

    def put(batch):
        queue.append({
            k: (put_leaf(v) if isinstance(v, np.ndarray) and v.dtype.kind not in "USO"
                and k != "valid" else v)
            for k, v in batch.items()
        })

    it = iter(iterator)
    try:
        for _ in range(size):
            put(next(it))
    except StopIteration:
        pass
    while queue:
        out = queue.popleft()
        try:
            put(next(it))
        except StopIteration:
            pass
        yield out
