"""Throughput benchmark of the port (port of the root ``bench.py``): its ten modes on the card.

    python -m wav2vec_heart_sounds_tpu_torch.bench [--mode=train] [--steps=60]
    torchrun --nproc_per_node=N -m wav2vec_heart_sounds_tpu_torch.bench --mode=train

Each run prints ONE JSON line: ``{"metric": ..., "value": N, "unit": ..., ...}`` under
``bench.py``'s metric names and units. The modes, at ``bench.py``'s sizes:

* ``train``, ``infer``, ``preproc`` (:func:`run_bench`): B = 96 raw 2 kHz windows of 4 s,
  preprocessed on the card to 16 kHz (:func:`.experiments.cinc._device_prep`), into a
  full-width bf16 wav2vec2-base classifier with the 512x3 head (random weights from seed 0):
  ``SupervisedTrainer._train_step`` with SGD at 1e-3 on the K4 route, the eval forward, or
  the chain alone. 3 warm steps, then ``steps`` timed ones on the host clock;
* ``real``: the training loop itself, ``Batcher`` -> int16 wire -> prefetch -> step through
  ``SupervisedTrainer._run_epoch``, on the raw 2 kHz wire preprocessed on the card, or with
  ``W2VHS_REAL_WIRE=16k`` on the 16 kHz wire preprocessed beforehand;
* ``vest`` (:func:`run_vest_bench`): B = 16 windows of 6 microphones x 2 s at 4125 Hz, lazy
  host augmentation with 15 copies a window, the sinc beamformer and LoRA, AdamW at 1e-4;
  ``W2VHS_VEST_DEVAUG=1`` moves the augmentation's tail to the card, and
  ``W2VHS_VEST_BATCH`` / ``W2VHS_VEST_STEPS`` / ``W2VHS_VEST_WINDOW_S`` resize the run;
* ``fusion`` (:func:`run_fusion_bench`): two full-width branches, B = 64 windows of 4 s at
  4125 Hz on two channels, AdamW at 1e-4;
* ``gen`` / ``gen-wavegrad`` (DiffWave fast sampling at B = 16 x 96 frames, WaveGrad 6-step
  sampling at B = 8 x 80) and ``gen-train`` (= ``gen-train-diffwave``) /
  ``gen-train-wavegrad`` (``GenerativeTrainer.train_step`` at B = 16 x 80), float32 with
  TF32 off inside the mode (:func:`.ops.full_fp32`); the classifier modes run on the
  process's settings.

Every window ends on a sync that waits for every step: ``torch.cuda.synchronize()``, and
under a mesh a barrier after it. The classifier modes run data-parallel when the process
runs under ``torchrun`` (or in a process group already formed): B stays the global batch
and the rate divides by the world size; otherwise the run uses one card and divides by 1.
Only rank 0 prints. ``vs_baseline`` is ``null``: the baseline file holds CPU runs of the
upstream reference, no figure to divide a card's rate by. Each line adds ``card`` (the
``nvidia-smi`` name and power limit), the torch, CUDA and cuDNN versions, ``world_size``, and
``cudnn_deterministic`` / ``cudnn_benchmark`` as the run found them; the bench sets neither.

Entry points run on the card unless the caller passes ``device="cpu"``; ``device="cuda"``
without a card raises. ``encoder`` (a :class:`.models.wav2vec2.Wav2Vec2Config`) replaces
wav2vec2-base in the classifier modes.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time
from functools import partial

import numpy as np
import torch
import torch.distributed as dist

from .augment.pipelines import AugmentConfig
from .augment.torchaug import augment_multi_pcg_batch
from .data.fragments import Fragment, FragmentDataset
from .data.loader import Batcher
from .data.vest import multi_augment, multi_augment_host_residual
from .experiments.cinc import _device_prep
from .experiments.common import make_loader
from .models.build import build_classifier, build_two_branch, default_compute_dtype
from .models.classifier import ClassifierConfig
from .models.diffusion import (DiffWaveConfig, WaveGradConfig, build_diffwave, build_wavegrad,
                               diffwave_sample, wavegrad_sample)
from .ops import full_fp32
from .parallel.mesh import barrier, data_parallel_mesh, is_main, maybe_shard_batch, mesh_device
from .train.classifier import SupervisedTrainer
from .train.generative import GenerativeTrainer, diffwave_loss, wavegrad_loss

MODES = ("train", "infer", "preproc", "real", "vest", "fusion", "gen", "gen-wavegrad",
         "gen-train", "gen-train-diffwave", "gen-train-wavegrad")
# The modes that train or score the classifier: they run data-parallel under torchrun.
MESH_MODES = ("train", "infer", "preproc", "real", "vest", "fusion")
WARM = 3                       # warm-up steps of run_bench's modes, before the timed window


def _raw_batch(batch_size: int, fs_in: int, seconds: float, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    t = np.arange(int(fs_in * seconds)) / fs_in
    base = np.sin(2 * np.pi * 90 * t) + 0.4 * np.sin(2 * np.pi * 250 * t)
    batch = base[None, :] + 0.05 * rng.normal(size=(batch_size, t.size))
    return batch.astype(np.float32)


def _placed(device) -> torch.device:
    """``device``, refusing the card where there is none (nothing falls back to the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device={device}: torch.cuda.is_available() is false "
                           "(pass device='cpu' to run on the CPU)")
    return device


def _sync(device: torch.device, mesh=None) -> None:
    """Wait for every queued step on this card, then (under a mesh) for every rank."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    barrier(mesh)


def _card(device: torch.device) -> str | None:
    if device.type != "cuda":
        return None
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[device.index or 0]


def _line(metric: str, value: float, unit: str, mode: str, device: torch.device, mesh,
          settings: dict, **keys) -> dict:
    """One JSON line: ``bench.py``'s keys, then the port's (card, versions, world size and
    the cuDNN flags the run found)."""
    return {"metric": metric, "value": round(value, 3), "unit": unit, "vs_baseline": None,
            "mode": mode, **keys, "backend": device.type,
            "card": _card(device), "torch": torch.__version__, "cuda": torch.version.cuda,
            "cudnn": torch.backends.cudnn.version(),
            "world_size": 1 if mesh is None else mesh.world_size, **settings}


def _cudnn_settings() -> dict:
    return {"cudnn_deterministic": torch.backends.cudnn.deterministic,
            "cudnn_benchmark": torch.backends.cudnn.benchmark}


def _classifier_config(fs: int, encoder, **fields) -> ClassifierConfig:
    return ClassifierConfig(num_classes=2, random_init=True, fs=fs,
                            **({} if encoder is None else {"encoder": encoder}), **fields)


def _timed_epochs(trainer, loader, warm: int, steps: int, device, mesh) -> tuple[float, float]:
    """``warm`` batches, then ``steps`` timed ones through ``_run_epoch``: (seconds, the timed
    epoch's mean loss)."""
    trainer._run_epoch(loader, True, max_batches=warm)
    _sync(device, mesh)
    t0 = time.perf_counter()
    _, loss = trainer._run_epoch(loader, True, max_batches=steps)
    _sync(device, mesh)
    return time.perf_counter() - t0, loss


def run_bench(batch_size: int = 96, fs: int = 16000, window_s: float = 4.0, steps: int = 60,
              mode: str = "train", fs_in: int = 2000, *, device="cuda", mesh=None,
              encoder=None, wire: str = "raw", vest_options: dict | None = None) -> dict:
    """One mode's line. ``train``, ``infer``, ``preproc`` and ``real`` take the sizes given
    here; the other modes run at their own defaults, as ``bench.py``'s dispatch does
    (``vest_options`` are the ``W2VHS_VEST_*`` overrides, ``wire`` ``real``'s wire)."""
    if mode == "gen":
        return run_gen_bench(device=device)
    if mode == "gen-wavegrad":
        return run_wavegrad_sample_bench(device=device)
    if mode in ("gen-train", "gen-train-diffwave"):
        return run_gen_train_bench("diffwave", device=device)
    if mode == "gen-train-wavegrad":
        return run_gen_train_bench("wavegrad", device=device)
    if mode == "vest":
        return run_vest_bench(device=device, mesh=mesh, encoder=encoder, **(vest_options or {}))
    if mode == "fusion":
        return run_fusion_bench(device=device, mesh=mesh, encoder=encoder)
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; one of {', '.join(MODES)}")
    device = mesh_device(mesh, _placed(device))
    settings = _cudnn_settings()
    win_len = int(round(window_s * fs))
    world = 1 if mesh is None else mesh.world_size
    prep = _device_prep(fs_in, fs, win_len, device)
    if mode == "preproc":
        model = trainer = None
    else:
        cfg = _classifier_config(fs, encoder, num_channels=1, head_hidden=(512, 512, 512))
        model = build_classifier(cfg, seed=0, device=device,
                                 dtype=default_compute_dtype(device), train=mode != "infer")
        trainer = SupervisedTrainer(model, optimizer_name="sgd", lr=1e-3,
                                    classifier_config=cfg, mesh=mesh, log=lambda s: None)

    if mode == "real":
        seconds, loss = _run_real(trainer, prep, batch_size, win_len, window_s, steps, fs,
                                  fs_in, wire, device, mesh)
        return _line("pcg_4s_windows_per_sec_per_chip_real_loop",
                     batch_size * steps / seconds / world, "windows/s/chip", mode, device,
                     mesh, settings, wire="raw2k_int16" if wire != "16k" else "preproc16k_int16",
                     batch_size=batch_size, steps=steps, final_fetch=round(float(loss), 6))

    raw = maybe_shard_batch(_raw_batch(batch_size, fs_in, window_s), mesh, device)
    if mode == "preproc":
        def run_step():
            with torch.no_grad():
                return prep(raw)
    elif mode == "infer":
        def run_step():
            with torch.inference_mode():
                return model(prep(raw))
    else:
        labels = maybe_shard_batch((np.arange(batch_size) % 2).astype(np.int32), mesh, device)
        valid = maybe_shard_batch(np.ones(batch_size, np.float32), mesh, device)

        def run_step():
            with torch.no_grad():
                x = prep(raw)
            return trainer._train_step(x, labels, valid, 1e-3)[0]

    for _ in range(WARM):
        out = run_step()
    _sync(device, mesh)
    t0 = time.perf_counter()
    for _ in range(steps):
        out = run_step()
    _sync(device, mesh)
    final_value = float(out.reshape(-1)[0])
    elapsed = time.perf_counter() - t0
    return _line("pcg_4s_windows_per_sec_per_chip_e2e", batch_size * steps / elapsed / world,
                 "windows/s/chip", mode, device, mesh, settings, batch_size=batch_size,
                 steps=steps, final_fetch=round(final_value, 6))


def _run_real(trainer, prep, batch_size, win_len, window_s, steps, fs, fs_in, wire, device,
              mesh):
    """``bench.py``'s real loop (``:411-478``): (seconds of ``steps`` batches, their loss).
    The dataset covers the warm-up, the timed window and one batch more: with fewer windows
    the epoch would end early and the rate over-count."""
    n_windows = batch_size * (steps + WARM + 1)
    if wire != "16k":
        host_raw = _raw_batch(n_windows, fs_in, window_s)
        host_raw /= np.max(np.abs(host_raw))          # wire contract: [-1, 1]
        frags = [Fragment(w, i % 2, f"p{i}") for i, w in enumerate(host_raw)]
        wire_len, wire_fs = int(round(window_s * fs_in)), fs_in
        trainer.device_preprocess = prep
    else:
        with torch.no_grad():
            host_waves = prep(torch.as_tensor(_raw_batch(n_windows, fs_in, window_s))
                              ).float().cpu().numpy()
        frags = [Fragment(w, i % 2, f"p{i}") for i, w in enumerate(host_waves)]
        wire_len, wire_fs = win_len, fs
    batcher = Batcher(FragmentDataset(frags, fs=wire_fs), batch_size, train=True, seed=0,
                      target_len=wire_len, wire_int16=True)
    return _timed_epochs(trainer, batcher, WARM, steps, device, mesh)


def run_vest_bench(batch_size: int = 16, steps: int = 6, window_s: float = 2.0,
                   fs: int = 4125, channels: int = 6, warm: int = 2, *,
                   device_augment: bool = False, device="cuda", mesh=None,
                   encoder=None) -> dict:
    """Vest real loop (``bench.py:207-283``): lazy host augmentation (one pipeline shared by
    the microphones) -> ``Batcher`` int16 wire -> sinc beamformer + LoRA train step;
    ``device_augment`` keeps the pipeline's head on the host and runs its tail on the card
    (``augment_multi_pcg_batch`` as the trainer's batch transform)."""
    device = mesh_device(mesh, _placed(device))
    settings = _cudnn_settings()
    win_len = int(round(window_s * fs))
    aug_num = 15                                  # reference default expansion
    n_items = batch_size * (steps + warm + 2)
    n_base = max(2, -(-n_items // (aug_num + 1)))
    rng = np.random.default_rng(0)
    t = np.arange(win_len) / fs
    base = np.sin(2 * np.pi * 85 * t) + 0.3 * np.sin(2 * np.pi * 190 * t)
    frags = []
    for i in range(n_base):
        wave = (base[:, None]
                + 0.05 * rng.normal(size=(win_len, channels))).astype(np.float32)
        wave /= np.max(np.abs(wave))
        frags.append(Fragment(wave, i % 2, f"p{i}"))
    host_fn = multi_augment_host_residual if device_augment else multi_augment
    ds = FragmentDataset(frags, fs=fs, augment_num=aug_num,
                         augment_fn=partial(host_fn, cfg=AugmentConfig()))
    batch_transform = partial(augment_multi_pcg_batch, fs=fs) if device_augment else None
    cfg = _classifier_config(fs, encoder, num_channels=channels, lora=True, head_hidden=(256,))
    model = build_classifier(cfg, seed=0, device=device, dtype=default_compute_dtype(device),
                             train=True)
    trainer = SupervisedTrainer(model, optimizer_name="adamw", lr=1e-4, classifier_config=cfg,
                                batch_transform=batch_transform, mesh=mesh, log=lambda s: None)
    loader = make_loader(ds, batch_size, True, 0, win_len)
    seconds, loss = _timed_epochs(trainer, loader, warm, steps, device, mesh)
    world = 1 if mesh is None else mesh.world_size
    return _line("vest_2s_windows_per_sec_per_chip_real_loop", batch_size * steps / seconds / world,
                 "windows/s/chip", "vest", device, mesh, settings,
                 device_augment=device_augment, channels=channels, batch_size=batch_size,
                 steps=steps, final_fetch=round(float(loss), 6))


def run_fusion_bench(batch_size: int = 64, steps: int = 10, window_s: float = 4.0,
                     fs: int = 4125, warm: int = 3, *, device="cuda", mesh=None,
                     encoder=None) -> dict:
    """Two-branch PCG+ECG fusion train step through the ``Batcher`` int16 wire
    (``bench.py:285-338``)."""
    device = mesh_device(mesh, _placed(device))
    settings = _cudnn_settings()
    win_len = int(round(window_s * fs))
    n_items = batch_size * (steps + warm + 2)
    rng = np.random.default_rng(0)
    t = np.arange(win_len) / fs
    pcg = np.sin(2 * np.pi * 90 * t) + 0.4 * np.sin(2 * np.pi * 250 * t)
    ecg = np.sin(2 * np.pi * 1.2 * t)
    frags = []
    for i in range(n_items):
        wave = np.stack([pcg + 0.05 * rng.normal(size=win_len),
                         ecg + 0.02 * rng.normal(size=win_len)], axis=1)
        wave /= np.max(np.abs(wave))
        frags.append(Fragment(wave.astype(np.float32), i % 2, f"p{i}"))
    ds = FragmentDataset(frags, fs=fs)
    branch = _classifier_config(fs, encoder, num_channels=1)
    fusion = build_two_branch(branch, branch, seed=0, device=device,
                              dtype=default_compute_dtype(device), train=True)
    trainer = SupervisedTrainer(fusion, optimizer_name="adamw", lr=1e-4, mesh=mesh,
                                log=lambda s: None)
    loader = make_loader(ds, batch_size, True, 0, win_len)
    seconds, loss = _timed_epochs(trainer, loader, warm, steps, device, mesh)
    world = 1 if mesh is None else mesh.world_size
    return _line("fusion_4s_windows_per_sec_per_chip_e2e", batch_size * steps / seconds / world,
                 "windows/s/chip", "fusion", device, mesh, settings, batch_size=batch_size,
                 steps=steps, final_fetch=round(float(loss), 6))


def _mels_and_labels(rng: np.random.Generator, batch_size: int, n_mels: int, frames: int):
    """``bench.py``'s seeded conditioning: uniform mels, then labels, from ``rng``."""
    con = rng.uniform(0, 1, (batch_size, n_mels, frames)).astype(np.float32)
    return con, rng.integers(0, 2, batch_size).astype(np.int32)


def _timed_calls(call, warm: int, steps: int, device) -> tuple[float, float]:
    """``warm`` calls, then ``steps`` timed ones: (seconds, the last call's first value)."""
    for _ in range(warm):
        out = call()
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(steps):
        out = call()
    _sync(device)
    value = float(torch.as_tensor(out).reshape(-1)[0])
    return time.perf_counter() - t0, value


def run_gen_bench(batch_size: int = 16, steps: int = 10, frames: int = 96, *,
                  device="cuda") -> dict:
    """DiffWave fast-sampling throughput: generated audio-seconds per wall second
    (``bench.py:44-93``)."""
    device = _placed(device)
    settings = _cudnn_settings()
    with full_fp32():
        cfg = DiffWaveConfig()
        model = build_diffwave(cfg, seed=0, device=device)
        con, labels = (torch.as_tensor(a).to(device) for a in _mels_and_labels(
            np.random.default_rng(0), batch_size, cfg.n_mels, frames))
        generator = torch.Generator(device=device).manual_seed(1)
        seconds, last = _timed_calls(
            lambda: diffwave_sample(model, con, labels, generator, fast=True)[0], 1, steps,
            device)
    audio_seconds = batch_size * steps * (cfg.hop_length * frames / cfg.sample_rate)
    return _line("diffwave_fast_sampling_audio_s_per_s", audio_seconds / seconds, "audio-s/s",
                 "gen", device, None, settings, batch_size=batch_size, steps=steps,
                 final_fetch=round(last, 6))


def run_wavegrad_sample_bench(batch_size: int = 8, steps: int = 10, num_steps: int = 6,
                              frames: int = 80, *, device="cuda") -> dict:
    """WaveGrad sampling throughput on the subsampled reverse schedule, WG-6 by default
    (``bench.py:96-141``)."""
    device = _placed(device)
    settings = _cudnn_settings()
    with full_fp32():
        cfg = WaveGradConfig()
        model = build_wavegrad(cfg, seed=0, device=device)
        con, labels = (torch.as_tensor(a).to(device) for a in _mels_and_labels(
            np.random.default_rng(0), batch_size, cfg.n_mels, frames))
        generator = torch.Generator(device=device).manual_seed(1)
        seconds, last = _timed_calls(
            lambda: wavegrad_sample(model, con, labels, generator, num_steps=num_steps)[0], 1,
            steps, device)
    audio_seconds = batch_size * steps * (cfg.hop_length * frames / cfg.sample_rate)
    return _line("wavegrad_sampling_audio_s_per_s", audio_seconds / seconds, "audio-s/s",
                 "gen-wavegrad", device, None, settings, num_steps=num_steps,
                 batch_size=batch_size, steps=steps, final_fetch=round(last, 6))


def run_gen_train_bench(which: str = "diffwave", batch_size: int = 16, steps: int = 10,
                        frames: int = 80, *, device="cuda") -> dict:
    """Generative train-step throughput: audio-seconds of training data per wall second,
    one ``GenerativeTrainer.train_step`` (denoising loss, clip, Adam) a batch
    (``bench.py:144-205``)."""
    device = _placed(device)
    settings = _cudnn_settings()
    with full_fp32():
        if which == "wavegrad":
            cfg, build, loss_fn = WaveGradConfig(), build_wavegrad, wavegrad_loss
        else:
            cfg, build, loss_fn = DiffWaveConfig(), build_diffwave, diffwave_loss
        n = cfg.hop_length * frames
        rng = np.random.default_rng(0)
        con, labels = _mels_and_labels(rng, batch_size, cfg.n_mels, frames)
        audio = rng.normal(size=(batch_size, n)).astype(np.float32) * 0.1
        batch = {"ref_audio": audio, "con_spec": con, "label": labels}
        model = build(cfg, seed=0, device=device)
        with tempfile.TemporaryDirectory() as tmp:
            trainer = GenerativeTrainer(model, loss_fn, tmp, log=lambda s: None)
            seconds, last = _timed_calls(lambda: trainer.train_step(batch), 2, steps, device)
    audio_seconds = batch_size * steps * (n / cfg.sample_rate)
    return _line(f"{which}_train_audio_s_per_s", audio_seconds / seconds, "audio-s/s",
                 f"gen-train-{which}", device, None, settings, batch_size=batch_size,
                 steps=steps, final_fetch=round(last, 6))


@contextlib.contextmanager
def launched_mesh(device="cuda"):
    """The data-parallel mesh of a process launched by ``torchrun`` (``RANK`` and
    ``WORLD_SIZE`` set) or already in a process group, else ``None``. A group this call
    forms is destroyed on exit."""
    if not (dist.is_initialized() or ("RANK" in os.environ and "WORLD_SIZE" in os.environ)):
        yield None
        return
    formed = not dist.is_initialized()
    mesh = data_parallel_mesh(_placed(device))
    try:
        yield mesh
    finally:
        if formed:
            dist.destroy_process_group()


def environment_options() -> dict:
    """``bench.py``'s environment switches as :func:`run_bench` keywords: ``W2VHS_REAL_WIRE``
    (``raw`` or ``16k``) and the vest's ``W2VHS_VEST_DEVAUG`` / ``_BATCH`` / ``_STEPS`` /
    ``_WINDOW_S``."""
    env = os.environ
    vest = {"device_augment": env.get("W2VHS_VEST_DEVAUG") == "1"}
    for key, name, cast in (("batch_size", "W2VHS_VEST_BATCH", int),
                            ("steps", "W2VHS_VEST_STEPS", int),
                            ("window_s", "W2VHS_VEST_WINDOW_S", float)):
        if name in env:
            vest[key] = cast(env[name])
    return {"wire": "16k" if env.get("W2VHS_REAL_WIRE", "raw") == "16k" else "raw",
            "vest_options": vest}


def main(argv: list[str] | None = None) -> None:
    """``--mode=`` (default ``train``) and ``--steps=`` (default 60, the timed steps of
    ``train``, ``infer``, ``preproc`` and ``real``), as ``bench.py``'s; the port adds
    ``--device=`` (default ``cuda``) and ``--batch-size=`` (those four modes, default 96)."""
    mode, options = "train", {"steps": 60}
    for arg in sys.argv[1:] if argv is None else argv:
        name, _, value = arg.partition("=")
        if name == "--mode":
            mode = value
        elif name == "--steps":
            options["steps"] = int(value)
        elif name == "--batch-size":
            options["batch_size"] = int(value)
        elif name == "--device":
            options["device"] = value
        else:
            raise SystemExit(f"unknown argument {arg!r}: --mode=, --steps=, --batch-size=, "
                             "--device=")
    if mode not in MODES:
        raise SystemExit(f"unknown mode {mode!r}; one of {', '.join(MODES)}")
    with (launched_mesh(options.get("device", "cuda")) if mode in MESH_MODES
          else contextlib.nullcontext()) as mesh:
        result = run_bench(mode=mode, mesh=mesh, **options, **environment_options())
        if is_main(mesh):
            print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
