"""Construct a classifier on the meta device, allocate it on the target, init from a seed;
the two-branch PCG+ECG fusion model built from two such classifiers; and the compute dtype
that the command line takes by device."""

from __future__ import annotations

from dataclasses import replace

import torch

from . import hf_port
from .classifier import ClassifierConfig, Wav2VecClassifier
from .fusion import EncoderFusion, two_branch_pcg_ecg
from .wav2vec2 import init_parameters


def default_compute_dtype(device) -> torch.dtype:
    """bfloat16 on the card, float32 on the CPU (the JAX package's ``default_compute_dtype``
    by backend)."""
    return torch.float32 if torch.device(device).type == "cpu" else torch.bfloat16


def build_classifier(cfg: ClassifierConfig, seed: int = 0, device="cuda",
                     dtype: torch.dtype = torch.float32, train: bool = False
                     ) -> Wav2VecClassifier:
    """A classifier on ``device`` (the card unless the caller asks for the CPU),
    computing in ``dtype``, in eval mode, or in
    ``.train()`` mode for a trainer with ``train=True`` (the forward's ``train`` argument
    picks the training path).

    The dtype is the caller's choice, never inferred from the device. Weights come from a
    CPU ``torch.Generator`` seeded with ``seed``, so the same seed gives the same weights
    on every device. With ``cfg.random_init`` False the encoder takes the pretrained
    ``cfg.pretrained_name`` (a directory, or a hub name in the local HF cache:
    :func:`.hf_port.load_pretrained_encoder`) when it is there, with its architecture (the
    fields of :data:`.hf_port.ARCHITECTURE`; dropouts, SpecAugment, LoRA, routes and
    remat stay the caller's), as the JAX package's ``build_classifier`` does; the encoder is then loaded
    strictly, only the LoRA adapters keeping their init. Without a checkpoint it keeps its
    random init and says so in one printed line. A multichannel config gets the sinc
    beamformer and a LoRA config the adapters (:mod:`.classifier`); every parameter keeps
    ``requires_grad`` until a trainer applies the config's freeze mask. Load trained or
    converted weights afterwards with ``model.load_state_dict`` (see :mod:`.from_jax` and
    :mod:`.hf_port`).
    """
    pretrained = None
    if not cfg.random_init:
        loaded = hf_port.load_pretrained_encoder(cfg.pretrained_name)
        if loaded is not None:
            arch, pretrained = loaded
            cfg = replace(cfg, encoder=replace(
                cfg.encoder, **{f: getattr(arch, f) for f in hf_port.ARCHITECTURE}))
    with torch.device("meta"):
        model = Wav2VecClassifier(cfg, dtype)
    model.to_empty(device=device)
    init_parameters(model, torch.Generator().manual_seed(seed))
    if pretrained is not None:      # the checkpoint has no LoRA adapters: they keep their init
        missing, unexpected = model.encoder.load_state_dict(pretrained, strict=False)
        if unexpected or any(not k.endswith((".lora_a", ".lora_b")) for k in missing):
            raise KeyError(f"checkpoint of {cfg.pretrained_name} does not fit the encoder: "
                           f"missing {missing}, unexpected {unexpected}")
    elif not cfg.random_init:
        print(f"build_classifier: no local checkpoint of {cfg.pretrained_name}; the "
              f"encoder keeps its random init (seed {seed})")
    return model.train(train)


def build_two_branch(pcg_cfg: ClassifierConfig, ecg_cfg: ClassifierConfig, seed: int = 0,
                     num_classes: int = 2, device="cuda", dtype: torch.dtype = torch.float32,
                     train: bool = False) -> EncoderFusion:
    """A fresh (untrained) two-branch fusion model (the JAX package's ``build_two_branch``):
    the PCG branch from ``seed``, the ECG branch from ``seed + 1``, the float32 fusion head
    from ``seed + 2``; the branches are trained separately upstream in the runner."""
    pcg = build_classifier(pcg_cfg, seed, device, dtype, train)
    ecg = build_classifier(ecg_cfg, seed + 1, device, dtype, train)
    return two_branch_pcg_ecg(pcg, ecg, num_classes, seed + 2)
