"""Synthetic-dataset generation from a trained diffusion vocoder (port of
``train/generate.py``).

Iterate a GenerativeDataset, sample ``per_item`` waveforms per item conditioned on its mel
and label, abs-max normalise, and write ``<patient>_<idx>_<copy>.wav`` plus a
``REFERENCE.csv`` manifest (``patient,label,file``, the JAX module's rows in its order) that
:func:`..data.generated.generated_fragments` consumes. The (item, copy) tasks are sampled
``batch_size`` at a time; the last chunk is sampled at its own size (the JAX module pads it
to a static batch only for XLA's shapes). Items whose mels differ in shape are sampled one
at a time. Randomness: one generator seeded with ``seed`` on the model's device.
"""

from __future__ import annotations

import csv
import os

import numpy as np
import torch
from scipy.io import wavfile

from ..data.common import progress
from ..signal.normalize import abs_max_normalise


def generate_dataset(model, spec, dataset, output_dir: str, *, per_item: int = 1,
                     seed: int = 0, sampler_kwargs: dict | None = None,
                     batch_size: int = 8) -> str:
    """Sample ``per_item`` waveforms per dataset item; returns the manifest path."""
    os.makedirs(output_dir, exist_ok=True)
    sampler_kwargs = sampler_kwargs or {}
    device = next(model.parameters()).device
    generator = torch.Generator(device=device).manual_seed(seed)
    manifest_path = os.path.join(output_dir, "REFERENCE.csv")

    tasks = [(idx, copy) for idx in range(len(dataset)) for copy in range(per_item)]
    with open(manifest_path, "w", newline="") as fh:
        writer = csv.writer(fh)
        writer.writerow(["patient", "label", "file"])
        starts = range(0, len(tasks), batch_size)
        for start in progress(starts, desc="generating", unit="batch"):
            chunk = tasks[start:start + batch_size]
            items = {i: dataset[i] for i in dict.fromkeys(i for i, _ in chunk)}
            cons = {task: np.asarray(items[task[0]]["con_spec"], np.float32) for task in chunk}
            same = len({c.shape for c in cons.values()}) == 1
            for group in ([chunk] if same else [[task] for task in chunk]):
                con = np.stack([cons[task] for task in group])
                labels = np.asarray([int(items[i]["label"]) for i, _ in group], np.int64)
                audio, sr = spec.sample(model, con, labels, generator, **sampler_kwargs)
                audio = audio.float().cpu().numpy()
                for (idx, copy), wav in zip(group, audio):
                    wave = abs_max_normalise(wav).astype(np.float32)
                    item = items[idx]
                    name = f"{item['patient']}_{idx}_{copy}.wav"
                    wavfile.write(os.path.join(output_dir, name), sr, wave)
                    writer.writerow([item["patient"], item["label"], name])
    return manifest_path
