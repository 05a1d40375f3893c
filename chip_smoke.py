#!/usr/bin/env python3
"""GPU smoke run of the PyTorch port (``wav2vec_heart_sounds_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which exits non-zero on failure:

1. build every CUDA kernel from ``csrc/`` (into ``build/torch_kernels/``), one ``nvcc``
   per source, all started together;
2. the serving attention kernel against its plain PyTorch version on the card, at the
   serving shapes, with CUDA-event timings (median of 20); then phase 17 (below);
3. full width: a wav2vec2-base encoder (float32, 12 layers x 768) loaded from the synthetic
   HF-layout state dict ``tests/golden/fullsize_sd.py`` must reproduce the recorded HF
   torch outputs ``tests/golden/wav2vec2_fullsize_parity.npz``;
4. the serving path: seeded synthetic raw 2 kHz recordings -> ``FragmentDataset`` -> eval
   ``Batcher`` -> ``experiments.cinc.score`` with a full-width bfloat16 classifier ->
   fragment and patient statistics; the attention kernel must have run 12 times per batch
   and the logits must agree with the same classifier on the plain attention;
5. the training kernels against their plain versions at the training shapes
   (``[96*199, 768]``, ``[96*199, 3072]``, ``[96, 36, 199, 64]``), bfloat16 and float32,
   dropout rate 0.1: ``csrc/philox.cuh`` against the plain Philox bits, every mask bit for
   bit (the attention's decoded in bfloat16 and float32), every output and gradient at a
   stated tolerance; K3b on the head view of a ``[B, T, 3H, d]`` projection (the encoder's
   layout) equal bit for bit to the contiguous packed tensor, its backward equal to a
   second run of itself, timed on both layouts; K1 and K2 also at the vest's ``[400, 768]``
   and an odd length on a view one element past 16 bytes (K1), fusion's ``[3264, 768]``, a
   ragged ``[127, 768]`` and ``[1, 768]`` and 384 columns (K2), masks, K1's output and K2's
   s bit for bit, and K2's refusal of a view that does not start on 16 bytes; CUDA-event
   timings around each call (median of 20) beside each kernel's bound (bytes, or operations:
   products, exponentials, or the integer instructions of the Philox masks counted in the
   built SASS; K5's bytes count the backward's partial rows, and beside its bound it prints
   every instruction the built kernel's main loop issues per element, counted in its SASS,
   and their time at the issue rate) and,
   where one PyTorch call computes the same function, that call's time; beside them the
   device time of each kernel and library call (``device_ms``: 20 calls queued behind a spin
   kernel); K5 also at a ragged row count, the tiny config's 64 columns and an odd length,
   its masks bit for bit, its backward equal to a second run, its refusal of a view one
   element past 16 bytes; then K4 (``csrc/ffn_mega.cu``, the FFN sublayer) the same
   way at 19104, 3264 (fusion), 400 (vest) and 127 (ragged) rows, both masks checked bit for bit through
   the zero patterns of the backward's ``h`` and ``dhid``, timed beside the decomposed route
   (cuBLAS products + K5 + K2), with the device time of each bf16 stage (``torch.profiler``)
   and each product's TFLOP/s;
6. one full-width float32 training step (B=8, dropout and SpecAugment on) from one state
   and one seed, the kernels (K4 on) against all-plain versions: loss and per-parameter
   gradient norms agree, and each kernel ran its exact count of launches in the forward and
   in the backward; then the bfloat16 K4 route against the decomposed K5 route (distances
   to the float32 step averaged over four step seeds);
7. the training path: ``SupervisedTrainer.fit`` of a full-width bfloat16 classifier at B=96
   on seeded synthetic raw 2 kHz windows (int16 wire, preprocessing on the card), one
   epoch of 4 steps and a validation epoch, on the K4 route and on the K5 control: finite
   losses, exact launches per step, and training windows/s of both routes (host clock,
   median of 3 epochs each, in turns);
8. the CinC runner ``experiments.cinc.run`` on a synthetic CinC directory (PCG+ECG records
   written with the port's ``wfdb_io``), full width, bfloat16, 16 kHz: the raw wire with
   augmentation on the card, and the host chain with augmented copies;
9. the vest slice's kernels against their plain versions at the vest shapes: K6
   (``csrc/flash_kv.cu``, ``[16, 8250, 4, 8]`` in float32 and through the bfloat16
   boundary cast, its backward equal bit for bit to a second run, also at T = 300 and 77,
   timed beside ``scaled_dot_product_attention``; its bound counts the products at the
   dense TF32 rate and the exponentials at the special-function rate) and K7
   (``csrc/sinc_delay.cu``, ``[96, 8250]`` rows, delays in [0, 41.25] with integers) on three
   draws (``k7_draws``: the phase's own stream and two other seed-21 streams, one of them a
   stream on which the forward once missed its bar beyond the taps) and on delays smooth in
   time (``k7_smooth_inputs``), y and s beyond the taps bit for bit, each side's error
   against the plain version in float64 printed inside and beyond the taps; K6 and K7 by
   CUDA events and by device time (``device_ms``), each beside its bound (K7's: each form's
   float64, conversion and special-function instructions counted in the SASS of a build in
   that form, ``k7_form_counts``, times that form's share of the draw), K7 on the iid and the
   smooth draw; K3b at the vest encoder's T = 25 and K4 at its 400 rows;
10. one full-width float32 vest training step (B=2, 6 microphones, LoRA under the freeze
   mask, the waveform's gradient asked for too) kernels against all-plain versions;
11. ``SupervisedTrainer.fit`` on bench.py's vest config (B=16, bfloat16, AdamW, lazy host
   augmentation): exact launches per step and vest training windows/s (median of 3); then
   a second timed arm on the same model with the augmentation on the card (the host head
   of ``vest_dataset(device_augment=True)``, ``augment_multi_pcg_batch`` as the trainer's
   batch transform), its exact launches and its windows/s;
12. the vest runner ``experiments.multichannel.run`` on a synthetic vest directory (9-column
   int16 WAVs), full width, bfloat16: the host chain with cross-entropy, and device
   augmentation with the contrastive-focal loss;
13. K3a, the unpacked attention (one CUDA body with K3b, ``csrc/attention_qkv_{fwd,bwd}.cu``),
   at ``[96, 12, 199, 64]`` on head views of ``[B, T, H, d]`` projections, bfloat16 and
   float32, rate 0.1 and 0, t = 199 and 150: masks decoded bit for bit, values and
   gradients against the plain version at K3b's bars, and output, lse and gradients equal
   to K3b's on the packed tensor of the same q, k, v bit for bit; timed beside its bound
   and ``scaled_dot_product_attention`` on the same views; then both routes at the vest's
   T = 25 and fusion's T = 51 (t = T and T - 4), bit for bit each other and a second
   backward run, against the plain version;
14. K8, the fused conv + erf GELU (``csrc/conv_gelu.cu``), at conv_1's shapes
   (``[96, 512, 12799]`` and ``[96, 512, 12800]`` -> 6399 frames, bfloat16, and a ragged
   ``[3, 256, 301]`` -> 128; float32 at B = 8): out, pre, dx and dW against the plain
   version, the bfloat16 frame view and padded channels-last dpre bit for bit against
   theirs, timed beside its bound and cuDNN ``conv1d`` + ``gelu``, with each bfloat16 stage
   (pack, GEMM, dpre, dx, dW and its reduce) timed alone;
15. one full-width float32 training step on the opt-in route (``qkv_fuse=False``,
   ``conv_fuse=True``; B = 2, 64000-sample windows) kernels against all-plain versions
   (phase 7's ``fit`` runs that route too: K3a 12+12 and K8 1+1 launches a step, K3b none);
16. the fusion path: ``SupervisedTrainer.fit`` on bench.py's fusion config (two full-width
   wav2vec2-base branches, B = 64, 4 s windows at 4125 Hz on two channels, AdamW at 1e-4):
   exact launches per step and fusion training windows/s; then the CinC runner
   ``experiments.cinc.run(mode="pcg_ecg")`` on phase 8's synthetic PCG+ECG directory (host
   chain): finite losses of its three trainings and a ``big_rnn:2:wav2vec`` record;
17. (run right after phase 2) the kernels at other configs' widths against their plain
   versions (K3a and K3b at head dims 16, 32 and 128; K4 at hidden / FFN 32 / 64, 1024 / 4096
   and 40 / 72; K2's widths 32, 1024 and 40 run in phase 5), then ``Wav2Vec2Config.tiny()``
   (hidden 32, head dim 16, FFN 64) on the card, float32, dropout and SpecAugment on, on both
   FFN routes: one eval forward and one training step against the same on the CPU from the
   same state dict and step seed (the loss at 1e-4 relative, each gradient norm at 1e-3
   relative), every kernel with its exact launches (K1, K2, K3b and K4 or K5);
18. the diffusion vocoders at full width (``DiffWaveConfig()``, ``WaveGradConfig()``; they run
   no port kernel and must launch none): from one seeded state dict on the CPU and the card,
   float32, B = 2, the forward (1e-4 of the output's largest value) and one loss gradient
   from injected draws (the loss at 1e-4 relative, each gradient norm at 1e-3 relative);
   the bf16 arm: the same weights at the bf16 compute dtype keep float32 parameters through
   a ``train_step`` and give a forward within 0.2 of the float32 one's largest value;
   then bench.py's gen modes in audio-s/s, each the median of 3 windows of 10 calls:
   DiffWave fast sampling (B = 16, 96 frames), WaveGrad 6-step sampling (B = 8, 80 frames)
   and ``GenerativeTrainer.train_step`` of both (B = 16, 80 frames), float32 and bf16;
19. the generative pipeline on phase 8's synthetic CinC directory, once per vocoder:
   ``cinc_generative_dataset`` -> ``GenerativeTrainer.train`` (one epoch of two batches,
   validation, the sample WAV) -> ``restore`` of ``weights-best`` (equal to the trained
   state) -> ``generate_dataset(per_item=2)``: the manifest's rows in order, every WAV at
   4 kHz, ``hop * 96`` samples, abs-max 1;
20. ``experiments.synthetic.run`` on a schedule of phase 8's directory and phase 19's
   DiffWave manifest (the second stage ``letskip``), full-width wav2vec2-base, bf16, 4 s at
   4125 Hz, B = 64: finite losses, the exact launches of every kernel (K1 2+2, K2, K3b and K4
   12+12 a step, K3b 12 a validation or test batch), a record with the JAX runner's keys;
21. the command line: ``python -m wav2vec_heart_sounds_tpu_torch.cli --help`` in a
   subprocess, then through ``cli.main`` on phase 8's CinC directory and a synthetic vest
   directory ``make-splits``, ``classify-cinc`` (raw wire), ``classify-vest``, ``gen-train``
   (DiffWave, bf16 compute), ``gen-sample``, ``classify-synthetic`` and ``summarize``: each
   record with the JAX runner's keys and finite statistics, every kernel's exact launches
   (K1-K4 on the ``classify-*`` commands, K6 and K7 on the vest, none on the vocoders), the
   host chain taken by the C++ library (its seconds, its gap to the NumPy oracle), and
   ``preprocess_ecg``, the normalisers and ``segment`` on the card against the CPU;
22. data parallelism through a world-1 NCCL group (a ``file://`` store, the mesh from
   ``parallel.data_parallel_mesh()``): (a) phase 7's ``fit`` (B = 96, bf16, 4 steps and a
   validation epoch), (b) one vest step with the contrastive-focal loss under LoRA's freeze
   mask, (c) one full-width DiffWave ``train_step``, each without a mesh and through it on
   cuDNN's deterministic algorithms: losses, parameters, the float32 master, the moments and
   the class centres equal bit for bit, with the mesh's exact launches (K1-K4; K6 and K7 on
   the vest) and (a)'s step wall time beside the no-mesh step's on cuDNN's default algorithms
   (in turns); (d) ``experiments.cinc.run(mesh=...)`` on phase 8's layout: one record, finite
   statistics, exact launches; (e) the device time of the gradient all-reduce of (a)'s flat
   float32 buffer, NCCL's alone and the optimizer's whole mean all-reduce, with its bytes;
23. the pretrained-encoder path: (a) ``experiments.cinc.run`` in its default mode
   (``random_init`` False, raw wire) on phase 8's directory, its checkpoint a seeded
   wav2vec2-base ``Wav2Vec2ForCTC`` in the real ``-960h`` layout (``wav2vec2.`` prefix, legacy
   ``weight_g``/``weight_v``, an ``lm_head``; ``pytorch_model.bin`` and HF's base
   ``config.json``) found by name in a hub cache: the built encoder holds the checkpoint's
   tensors, K1-K4 launch exactly; (b) a seeded checkpoint of wav2vec2-large-960h's
   architecture (24 x 1024, 16 heads, FFN 4096; 317 M parameters) written as
   ``model.safetensors`` by this script's own writer, built by
   ``build_classifier(random_init=False)`` from a caller's config holding the default
   wav2vec2-base encoder: 24 x 1024 with the checkpoint's tensors; (c) that model and phase
   7's wav2vec2-base trained in three arms (no remat, ``remat``, ``remat`` + ``remat_conv``),
   3 steps each at B = 96 bf16 on cuDNN's deterministic algorithms, in turns and again in the
   other order: losses, the last gradients and the states equal bit for bit, each arm's exact
   launches (the remat arms run each layer's K2, K3b and K4 forward once more), its median
   step ms and its peak device memory;
24. the port's bench (``wav2vec_heart_sounds_tpu_torch/bench.py``, bench.py's ten modes) at
   bench.py's sizes with windows of 3 timed steps, on torch's default TF32 settings and
   cuDNN's default algorithms: ``train``, ``infer``, ``preproc``, ``real`` on both wires, the
   vest on both augmentation arms, ``fusion``, ``gen``, ``gen-wavegrad`` and both
   ``gen-train`` modes: bench.py's keys and the port's, a finite positive value, each kernel's
   exact launches (K1-K4 in ``train``, ``real`` and ``fusion``, K3b in ``infer``, K6 and K7
   too in the vest, none in ``preproc`` and the vocoder modes); then the CLI's ``bench`` in a
   subprocess, alone and under a world-1 torchrun environment;
25. (run right after phase 14) the positional convolution's kernels (``csrc/pos_conv.cu``) at
   every shape a path runs them (``POS_CONV_SHAPES``: base and large training, fusion's and
   the vest's frames, the test config), bfloat16: out, pre, dx, dW and db against the plain
   version in float32 on the same tensors, a second backward bit for bit, each wrapper's
   exact launches and ``posconv.launches`` under a profiler, cuDNN's flags untouched; timed
   beside the bound and two library yardsticks the port never calls, cuDNN's default and
   deterministic algorithms on the plain version. Every bfloat16 path phase above counts
   the positional conv's launches with the other kernels' (one forward and one backward a
   train step a wav2vec2 encoder, one forward an eval batch); float32 models keep
   nn.Conv1d's call and launch none.

Prints the card's name and power limit, one JSON line describing the kernels (launches
from the ``fit`` of the path that runs each kernel: phase 7's K4 route for the CinC
kernels and the positional conv but K5, which runs only on its control, and K3a and K8,
which run on the opt-in route; phase 11 for K6 and K7, but K7's input gradient, which only
phase 10 asks for; times of the positional conv from phase 25 at base's shape), and
as its last line ``{"ok": true, "device": {...}}``. Imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import importlib.util
import json
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from unittest import mock

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
CSRC = "wav2vec_heart_sounds_tpu_torch/csrc/"
PALLAS = "wav2vec_heart_sounds_tpu/ops/pallas/"
SOURCES = ("attention_qkv_fwd", "attention_qkv_bwd", "dropout", "resid", "ffn_act", "ffn_mega",
           "flash_kv", "sinc_delay", "conv_gelu", "pos_conv")

# Serving configuration: 4 s windows at 16 kHz (the CinC window) from a 2 kHz raw wire.
FS_WIRE, FS, WINDOW_S, BATCH = 2000, 16000, 4.0, 32
PATIENTS, WINDOWS_PER_PATIENT = 12, 9
# Training configuration (bench.py's train mode): B=96, the same windows, SGD at lr 1e-3.
TRAIN_BATCH, TRAIN_PATIENTS, TRAIN_WINDOWS, RATE = 96, 48, 8, 0.1
H, T, D, HIDDEN, FFN = 12, 199, 64, 768, 3072
ROWS = TRAIN_BATCH * T
# Vest configuration (bench.py's run_vest_bench): 6 microphones, 2 s windows at 4125 Hz,
# B=16; the delay predictor's attention is [B, T, 4, 8] over every sample.
VEST_BATCH, VEST_MICS, VEST_FS, VEST_T, VEST_FRAMES = 16, 6, 4125, 8250, 25
KV_HEADS, KV_DIM = 4, 8
# conv_1 of wav2vec2-base on 64000 samples: 512 -> 512 channels, 12799 -> 6399 frames (K8).
CONV_C, CONV_T = 512, 12799
# Fusion configuration (bench.py's run_fusion_bench): two branches, 4 s at 4125 Hz, B=64.
FUSION_BATCH, FUSION_FS = 64, 4125
FUSION_FRAMES = 51                      # wav2vec2-base frames of 4 s at 4125 Hz (16500 samples)


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise SystemExit(f"chip_smoke FAILED: {msg}")


def cuda_ms(fn, runs: int = 20, warmup: int = 3) -> float:
    """Median milliseconds of ``fn()`` over ``runs`` launches, timed with CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def device_ms(fn, runs: int = 20, batches: int = 3) -> float:
    """Device milliseconds of one ``fn()``: CUDA events around ``runs`` calls queued behind a
    ~10 ms spin kernel (``torch.cuda._sleep``), so the card runs them back to back while the
    host is still launching; the median over ``batches``. Unlike ``cuda_ms``, the host's time
    to launch one call (a Python wrapper's tens of microseconds) is not in it."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(batches):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(20_000_000)
        start.record()
        for _ in range(runs):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / runs)
    return float(np.median(times))


def load_golden_module():
    path = ROOT / "tests" / "golden" / "fullsize_sd.py"
    spec = importlib.util.spec_from_file_location("fullsize_sd", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def phase_build() -> None:
    from wav2vec_heart_sounds_tpu_torch.ops.kernels import build

    from concurrent.futures import ThreadPoolExecutor

    t0 = time.perf_counter()
    with ThreadPoolExecutor(1) as pool:          # K7's counted variants beside them (k7_bound)
        variants = pool.submit(variant_libraries, K7_FORM_BUILDS)
        build.load_libraries(*SOURCES)
        variants.result()
    seconds = time.perf_counter() - t0
    print(f"[build] {len(SOURCES)} sources and {len(K7_FORM_BUILDS)} variants of sinc_delay, "
          f"one nvcc each in parallel: {seconds:.2f} s")
    for name in SOURCES:
        log = build.build_logs.get(name)
        print(f"[build] {name}: {'compiled' if log is not None else 'already built'}")
        for kernel, registers, spills in ptxas_usage(log or ""):
            print(f"[build]   {kernel}: {registers} registers, {spills}")


def ptxas_usage(log: str) -> list[tuple[str, str, str]]:
    """(kernel and dtype, registers, spills) for each kernel in an ``nvcc -Xptxas -v`` log."""
    rows, kernel, spills = [], None, ""
    for line in log.splitlines():
        if "Function properties for" in line:
            mangled = line.rsplit(" ", 1)[-1]
            found = re.search(r"\d([a-z_]+_kernel)", mangled)
            dtype = "bf16" if "bfloat16" in mangled else "f32"
            kernel = f"{found.group(1) if found else mangled} {dtype}"
        elif "spill" in line:
            spills = line.strip()
        elif "Used" in line and "registers" in line and kernel is not None:
            rows.append((kernel, line.split("Used", 1)[1].split()[0], spills))
            kernel = None
    return rows


def phase_kernel_vs_plain() -> None:
    """The serving attention kernel (rate 0) against plain attention."""
    from wav2vec_heart_sounds_tpu_torch.ops.kernels.attention import (
        attention_qkv_fwd, attention_qkv_reference)

    gen = torch.Generator(device="cuda").manual_seed(0)
    H, T, d = 12, 199, 64
    # bf16 output rounding: 1 ulp = 2^-7 ~ 7.8e-3 at unit scale, so the two versions,
    # which round at the same point from differently ordered f32 sums, may differ by one.
    cases = [(torch.bfloat16, 96, 1e-2, 1e-2), (torch.bfloat16, BATCH, 1e-2, 1e-2),
             (torch.float32, 96, 1e-5, 0.0)]
    for dtype, B, atol, rtol in cases:
        qkv = torch.randn(B, 3 * H, T, d, device="cuda", generator=gen).to(dtype)
        for t in (T, 150):
            out = attention_qkv_fwd(qkv, t)
            ref = attention_qkv_reference(qkv, t)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            ok = torch.allclose(out.float(), ref.float(), atol=atol, rtol=rtol)
            print(f"[kernel] attention_qkv_fwd {str(dtype)[6:]} B={B} H={H} T={T} d={d} t={t}: "
                  f"max_abs_err={err:.3e} (atol {atol:g}, rtol {rtol:g})")
            check(ok, f"attention kernel disagrees with plain ({dtype}, B={B}, t={t}): {err}")
        ms = cuda_ms(lambda: attention_qkv_fwd(qkv, T))
        plain_ms = cuda_ms(lambda: attention_qkv_reference(qkv, T))
        print(f"[kernel] attention_qkv_fwd {str(dtype)[6:]} B={B} t=T: kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms (CUDA events, median of 20)")


def phase_full_width() -> None:
    from wav2vec_heart_sounds_tpu_torch.models import hf_port
    from wav2vec_heart_sounds_tpu_torch.models.wav2vec2 import Wav2Vec2Model
    from wav2vec_heart_sounds_tpu_torch.ops.kernels.attention import attention_qkv_fwd

    golden_sd = load_golden_module()
    golden = np.load(ROOT / "tests" / "golden" / "wav2vec2_fullsize_parity.npz")
    with torch.device("cuda"):
        model = Wav2Vec2Model(dtype=torch.float32)
    hf_port.load_hf_state_dict(model, golden_sd.make_state_dict()).eval()
    reset_counts()
    for case, x in enumerate(golden_sd.make_inputs()):
        before = attention_qkv_fwd.launches
        with torch.inference_mode():
            out = model(torch.as_tensor(x, device="cuda")).cpu().numpy()
        launches = attention_qkv_fwd.launches - before
        ref = golden[f"out:{case}"]
        err = float(np.abs(out - ref).max())
        print(f"[golden] wav2vec2-base f32, input {x.shape[1]} samples -> {out.shape}: "
              f"max_abs_err={err:.3e} vs recorded HF torch (atol 2e-4, rtol 1e-3); "
              f"attention launches {launches}")
        check(out.shape == ref.shape, f"golden shape {out.shape} != {ref.shape}")
        check(np.allclose(out, ref, atol=2e-4, rtol=1e-3), f"golden case {case} mismatch: {err}")
        check(launches == model.config.num_layers,
              f"{launches} attention launches for one forward, expected {model.config.num_layers}")


def synthetic_recordings(seed: int = 0, patients: int = PATIENTS,
                         windows: int = WINDOWS_PER_PATIENT):
    """Raw 2 kHz windows: ``patients`` patients (half with a murmur-like band), a few spikes."""
    from wav2vec_heart_sounds_tpu_torch.data.fragments import Fragment

    rng = np.random.default_rng(seed)
    n = int(WINDOW_S * FS_WIRE)
    t = np.arange(n) / FS_WIRE
    frags = []
    for p in range(patients):
        label = p % 2
        rate = rng.uniform(0.9, 1.6)                         # beats per second
        for w in range(windows):
            phase = (t * rate + rng.uniform()) % 1.0
            beat = np.exp(-((phase - 0.10) / 0.02) ** 2) + 0.7 * np.exp(-((phase - 0.40) / 0.02) ** 2)
            x = beat * np.sin(2 * np.pi * rng.uniform(40, 90) * t)
            if label:
                x += 0.3 * (0.20 < phase) * (phase < 0.35) * rng.normal(size=n)
            x += 0.02 * rng.normal(size=n)
            if w % 3 == 0:
                x[rng.integers(0, n, size=2)] = rng.choice([-1.0, 1.0], size=2) * 25.0
            frags.append(Fragment(waveform=x.astype(np.float32), label=label,
                                  patient=f"patient{p:02d}"))
    return frags


def phase_serving(card: str) -> int:
    """Drive ``score``; returns the attention launches counted during the main-path run."""
    from wav2vec_heart_sounds_tpu_torch.config import WindowSpec
    from wav2vec_heart_sounds_tpu_torch.data.fragments import FragmentDataset
    from wav2vec_heart_sounds_tpu_torch.data.loader import Batcher
    from wav2vec_heart_sounds_tpu_torch.experiments.cinc import score
    from wav2vec_heart_sounds_tpu_torch.models.build import build_classifier
    from wav2vec_heart_sounds_tpu_torch.ops.kernels import attention
    from wav2vec_heart_sounds_tpu_torch.signal.torchproc import preprocess_pcg

    win_len = WindowSpec(window_s=WINDOW_S).window_len(FS)
    dataset = FragmentDataset(synthetic_recordings(), fs=FS_WIRE)
    batcher = Batcher(dataset, BATCH, train=False)
    n_windows, n_batches = len(dataset), len(batcher)

    # Preprocessing on the card against the same code on CPU tensors (itself held to the
    # JAX package and the NumPy oracle by the CPU tests): catches TF32 and device faults.
    raw = next(iter(batcher))["waveform"]
    gpu = preprocess_pcg(torch.as_tensor(raw, device="cuda"), FS_WIRE, FS).cpu().numpy()
    cpu = preprocess_pcg(torch.as_tensor(raw), FS_WIRE, FS).numpy()
    err = float(np.abs(gpu - cpu).max())
    print(f"[serve] preprocess_pcg card vs CPU, [{BATCH}, {raw.shape[1]}] -> {gpu.shape}: "
          f"max_abs_err={err:.3e} (atol 1e-4)")
    check(err < 1e-4, f"preprocessing on the card disagrees with CPU: {err}")

    cfg = classifier_config()
    model = build_classifier(cfg, seed=0, device="cuda", dtype=torch.bfloat16)
    score(model, batcher, FS_WIRE, FS, win_len, max_batches=1)           # warm-up
    torch.cuda.synchronize()

    reset_counts()
    t0 = time.perf_counter()
    result = score(model, batcher, FS_WIRE, FS, win_len)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = attention.attention_qkv_fwd.launches
    pos_launches = kernel_wrappers()["pos_conv_fwd"].launches
    runs = [seconds]
    for _ in range(2):                                                   # two more timed runs
        t0 = time.perf_counter()
        score(model, batcher, FS_WIRE, FS, win_len)
        torch.cuda.synchronize()
        runs.append(time.perf_counter() - t0)

    logits = result["logits"]
    print(f"[serve] {n_windows} windows of {WINDOW_S:g} s ({n_batches} batches of {BATCH}, "
          f"bf16 wav2vec2-base + 512x3 head): {n_windows / np.median(runs):.1f} windows/s "
          f"on {card} (median of 3 runs: {', '.join(f'{s * 1e3:.1f}' for s in runs)} ms; "
          f"host clock, preprocessing included)")
    print(f"[serve] attention launches {launches} in the first run "
          f"({cfg.encoder.num_layers} layers x {n_batches} batches), positional conv "
          f"{pos_launches} (one a batch)")
    print(f"[serve] fragment stats {json.dumps(result['fragment'])}")
    print(f"[serve] patient stats {json.dumps(result['patient'])}")
    check(logits.shape == (n_batches * BATCH, 2), f"logits shape {logits.shape}")
    check(bool(np.isfinite(logits).all()), "non-finite logits")
    check(launches == cfg.encoder.num_layers * n_batches,
          f"{launches} attention launches, expected {cfg.encoder.num_layers * n_batches}")
    check(pos_launches == n_batches, f"{pos_launches} pos_conv_fwd launches, expected {n_batches}")

    def plain(qkv, t=None, dropout_rate=0.0):
        return attention.attention_qkv_reference(qkv, t)

    before = attention.attention_qkv_fwd.launches
    with mock.patch.object(attention, "flash_attention_qkv", plain):
        reference = score(model, batcher, FS_WIRE, FS, win_len)
    check(attention.attention_qkv_fwd.launches == before, "plain run launched the kernel")
    diff = float(np.abs(reference["logits"] - logits).max())
    scale = float(np.abs(reference["logits"]).max())
    # bf16 activations (1 ulp = 2^-8 relative) round at different points through 12 layers.
    print(f"[serve] logits kernel vs plain attention: max_abs_err={diff:.3e} "
          f"(|logits| <= {scale:.3f}; atol 5e-2, rtol 5e-2)")
    check(np.allclose(logits, reference["logits"], atol=5e-2, rtol=5e-2),
          f"serving logits disagree with the plain-attention classifier: {diff}")
    for level in ("fragment", "patient"):
        check(all(np.isfinite(v) for v in result[level].values()), f"{level} stats not finite")
    return launches


@functools.cache
def kernel_wrappers() -> dict:
    """The counted wrapper of every kernel (each adds one to ``.launches`` per launch),
    taken once, before any phase patches a wrapper out."""
    from wav2vec_heart_sounds_tpu_torch.ops.kernels import attention, conv, dropout, ffn, resid
    from wav2vec_heart_sounds_tpu_torch.ops.kernels import megakernel as mk

    from wav2vec_heart_sounds_tpu_torch.ops.kernels import flash_kv, pos_conv, sinc_delay

    return {"attention_qkv_fwd": attention.attention_qkv_fwd,
            "attention_qkv_bwd": attention.attention_qkv_bwd,
            "attention_fwd": attention.attention_fwd, "attention_bwd": attention.attention_bwd,
            "conv_gelu_fwd": conv.conv_gelu_fwd_kernel,
            "conv_gelu_bwd": conv.conv_gelu_bwd_kernel,
            "dropout": dropout.dropout_kernel,
            "resid_fwd": resid.resid_fwd_kernel, "resid_bwd": resid.resid_bwd_kernel,
            "ffn_act_fwd": ffn.ffn_act_fwd_kernel, "ffn_act_bwd": ffn.ffn_act_bwd_kernel,
            "ffn_mega_fwd": mk.ffn_mega_fwd_kernel, "ffn_mega_bwd": mk.ffn_mega_bwd_kernel,
            "flash_kv_fwd": flash_kv.flash_kv_fwd_kernel,
            "flash_kv_bwd": flash_kv.flash_kv_bwd_kernel,
            "sinc_delay_fwd": sinc_delay.sinc_fwd_kernel,
            "sinc_delay_grad_d": sinc_delay.sinc_grad_d_kernel,
            "sinc_delay_grad_x": sinc_delay.sinc_grad_x_kernel,
            "pos_conv_fwd": pos_conv.pos_conv_fwd_kernel,
            "pos_conv_bwd": pos_conv.pos_conv_bwd_kernel}


# The kernels only the vest path runs; their launches come from its fit (phase 11), K7's
# input gradient's from the vest step (phase 9), the one run that needs it.
VEST_KERNELS = ("flash_kv_fwd", "flash_kv_bwd", "sinc_delay_fwd", "sinc_delay_grad_d",
                "sinc_delay_grad_x")
# name -> (source, the TPU kernel it replaces; None where the JAX package leaves it to XLA)
KERNELS = {
    "attention_qkv_fwd": ("attention_qkv_fwd.cu", "attention.py:343"),
    "attention_qkv_bwd": ("attention_qkv_bwd.cu", "attention.py:376"),
    "attention_fwd": ("attention_qkv_fwd.cu", "attention.py:240"),
    "attention_bwd": ("attention_qkv_bwd.cu", "attention.py:276"),
    "conv_gelu_fwd": ("conv_gelu.cu", "conv.py:180"),
    "conv_gelu_bwd": ("conv_gelu.cu", "conv.py:257"),
    "dropout": ("dropout.cu", "dropout.py:43"),
    "resid_fwd": ("resid.cu", "resid.py:114"),
    "resid_bwd": ("resid.cu", "resid.py:142"),
    "ffn_act_fwd": ("ffn_act.cu", "ffn.py:119"),
    "ffn_act_bwd": ("ffn_act.cu", "ffn.py:143"),
    "ffn_mega_fwd": ("ffn_mega.cu", "megakernel.py:206"),
    "ffn_mega_bwd": ("ffn_mega.cu", "megakernel.py:260"),
    "flash_kv_fwd": ("flash_kv.cu", "flash_kv.py:210"),
    "flash_kv_bwd": ("flash_kv.cu", "flash_kv.py:258"),
    "sinc_delay_fwd": ("sinc_delay.cu", "beamformer.py:111"),
    "sinc_delay_grad_d": ("sinc_delay.cu", "beamformer.py:167"),
    "sinc_delay_grad_x": ("sinc_delay.cu", "beamformer.py:176"),
    "pos_conv_fwd": ("pos_conv.cu", None),
    "pos_conv_bwd": ("pos_conv.cu", None),
}


def reset_counts() -> None:
    for fn in kernel_wrappers().values():
        fn.launches = 0


def counts() -> dict:
    return {name: fn.launches for name, fn in kernel_wrappers().items()}


@contextlib.contextmanager
def plain_route():
    """Every kernel wrapper replaced by its plain version (same signature and contract), and
    the positional conv's op sent to its plain version (``pos_conv_gelu_plain``)."""
    from wav2vec_heart_sounds_tpu_torch.ops.kernels import attention, conv, dropout, ffn, resid
    from wav2vec_heart_sounds_tpu_torch.ops.kernels import flash_kv as fk
    from wav2vec_heart_sounds_tpu_torch.ops.kernels import megakernel as mk
    from wav2vec_heart_sounds_tpu_torch.ops.kernels import pos_conv as pc
    from wav2vec_heart_sounds_tpu_torch.ops.kernels import sinc_delay as sk

    def conv_fwd_plain(x, w, keep_frames=False):
        out, pre = conv.conv_gelu_fwd_reference(x, w)
        return (out, pre, x) if keep_frames else (out, pre)

    def conv_bwd_plain(x, w, pre, g, need_dx=True, need_dw=True):
        return conv.conv_gelu_bwd_reference(x, w, pre, g)

    pairs = [(attention, "attention_fwd", attention.attention_reference),
             (attention, "attention_bwd", attention.attention_bwd_reference),
             (conv, "conv_gelu_fwd_kernel", conv_fwd_plain),
             (conv, "conv_gelu_bwd_kernel", conv_bwd_plain),
             (fk, "flash_kv_fwd_kernel", fk.attention_kv_fwd_reference),
             (fk, "flash_kv_bwd_kernel", fk.attention_kv_bwd_reference),
             (sk, "sinc_fwd_kernel", sk.sinc_fwd_reference),
             (sk, "sinc_grad_d_kernel", sk.sinc_grad_d_reference),
             (sk, "sinc_grad_x_kernel", sk.sinc_grad_x_reference),
             (mk, "ffn_mega_fwd_kernel", mk.ffn_mega_fwd_reference),
             (mk, "ffn_mega_bwd_kernel", mk.ffn_mega_bwd_reference),
             (attention, "attention_qkv_fwd", attention.attention_qkv_reference),
             (attention, "attention_qkv_bwd", attention.attention_qkv_bwd_reference),
             (dropout, "dropout_kernel", dropout.dropout_reference),
             (resid, "resid_fwd_kernel", resid.resid_fwd_reference),
             (resid, "resid_bwd_kernel", resid.resid_bwd_reference),
             (ffn, "ffn_act_fwd_kernel", ffn.ffn_act_fwd_reference),
             (ffn, "ffn_act_bwd_kernel", ffn.ffn_act_bwd_reference),
             (pc, "takes_kernel", lambda x: False)]       # the op's own plain version
    with contextlib.ExitStack() as stack:
        for module, name, plain in pairs:
            stack.enter_context(mock.patch.object(module, name, plain))
        yield


def agree(name: str, got: torch.Tensor, ref: torch.Tensor, atol: float, rtol: float) -> float:
    got, ref = got.float(), ref.float()
    err = (got - ref).abs().max().item()
    print(f"[train-kernel] {name}: max_abs_err={err:.3e} (atol {atol:g}, rtol {rtol:g})")
    check(got.shape == ref.shape and torch.allclose(got, ref, atol=atol, rtol=rtol),
          f"{name}: kernel disagrees with plain: {err}")
    return err


def identical(name: str, got: torch.Tensor, ref: torch.Tensor) -> None:
    check(got.shape == ref.shape and torch.equal(got, ref), f"{name}: kernel and plain differ")
    print(f"[train-kernel] {name}: bit-identical ({got.numel()} elements)")


def attention_masks(seed: int, site: int, unpacked: bool = False,
                    dtype: torch.dtype = torch.float32) -> tuple[torch.Tensor, torch.Tensor]:
    """The keep masks [B, H, T, T] the attention kernels applied, decoded exactly: K3b's on
    the packed tensor, or with ``unpacked`` K3a's on its three head ranges, in ``dtype``.

    With q = k = 0 every probability is 1/T. Forward: v_k = 2^(k div 64) e_(k mod 64), so
    out[q, j] * T / scale = sum_b keep[q, j + 64 b] 2^b, an integer below 16. Backward:
    do_q = 2^(q div 64) e_(q mod 64) decodes keep[j + 64 b, k] from dv[k, j] the same way.
    The codes are exact in bfloat16 too: zeros and powers of two in, and an integer below 16
    times one rounded factor out (2^-8 relative), which rounds back to the integer.
    """
    from wav2vec_heart_sounds_tpu_torch.ops import philox
    from wav2vec_heart_sounds_tpu_torch.ops.kernels import attention

    B = TRAIN_BATCH
    pos = torch.arange(T, device="cuda")
    code_of_pos = (2.0 ** (pos // D)).float()
    qkv = torch.zeros(B, 3 * H, T, D, device="cuda", dtype=dtype)
    qkv[:, 2 * H:, pos, pos % D] = code_of_pos.to(dtype)
    dout = torch.zeros(B, H, T, D, device="cuda", dtype=dtype)
    dout[:, :, pos, pos % D] = code_of_pos.to(dtype)
    args = (T, RATE, seed, site)
    if unpacked:
        q, k, v = qkv[:, :H], qkv[:, H:2 * H], qkv[:, 2 * H:]
        out, lse = attention.attention_fwd(q, k, v, *args, with_lse=True)
        dv = attention.attention_bwd(q, k, v, out, dout, lse, *args)[2]
    else:
        out, lse = attention.attention_qkv_fwd(qkv, *args, with_lse=True)
        dv = attention.attention_qkv_bwd(qkv, out, dout, lse, *args)[:, 2 * H:]
    scale = philox.keep_scale(RATE)

    def decode(a):                     # [B, H, rows, D] codes -> [B, H, rows, T] bits
        code = torch.round(a.float() * T / scale).to(torch.int64)
        return torch.cat([((code >> b) & 1).bool()[..., :min(D, T - D * b)]
                          for b in range(-(-T // D))], dim=-1)

    return decode(out), decode(dv).transpose(2, 3)


HBM_BYTES_PER_S = 3.35e12                       # H100 SXM device memory
# dense tensor core (bf16), f32 FMA outside the tensor cores, dense TF32 tensor core (K6)
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12, "tf32": 495e12}
# Exponentials: 16 results per clock per SM from the special-function units (CUDA's
# arithmetic-throughput table, compute capability 9.0) x 132 SMs x the 1.98 GHz boost clock.
EXP_PER_S = 16 * 132 * 1.98e9
# Per clock per SM (the same table): 32-bit integer instructions (Philox's multiplies, XORs
# and adds) 64; float64 adds, multiplies and FMAs 64; conversions to and from float64 (F2F)
# 16; and the issue of 4 warp-instructions (one per scheduler). Each x 132 SMs x the card's
# maximum SM clock as nvidia-smi reports it.
INT_PER_CLOCK_SM, FP64_PER_CLOCK_SM, F2F_PER_CLOCK_SM, ISSUE_PER_CLOCK_SM, SMS = 64, 64, 16, 4, 132


@functools.cache
def sm_clock_hz() -> float:
    mhz = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True).stdout.split()[0]
    return float(mhz) * 1e6


# SASS opcodes of one Philox4x32-10 call: its multiplies (hi and lo halves), three-way XORs
# and key-schedule adds; and the high-half multiplies, 20 a call (2 in each of 10 rounds).
PHILOX_OPCODES = ("IMAD", "LOP3", "IADD3")
HIGH_MULTIPLIES = ("IMAD.HI", "IMAD.WIDE")


SASS_LINE = re.compile(r"^\s*/\*([0-9a-f]{4,})\*/\s+(.*)$")
SASS_LABEL = re.compile(r"^\s*(\.L_x_\d+):")
BRANCH = re.compile(r"\bBRA(?:\.\S+)?\s+(?:`\(([^)]+)\)|(0x[0-9a-f]+))")


@functools.cache
def sass_listing(path: str) -> dict[str, list[tuple[int, str, int | None]]]:
    """Kernel name -> its SASS instructions (address, instruction without its predicate,
    the address a branch goes to or None) in the built library ``path``, from
    ``cuobjdump -sass``."""
    from wav2vec_heart_sounds_tpu_torch.ops.kernels import build

    cuobjdump = Path(build.find_nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", path], capture_output=True, text=True,
                          check=True).stdout
    kernels, insts, labels, pending = {}, None, {}, []
    for line in sass.splitlines():
        if "Function :" in line:
            insts = kernels.setdefault(line.split("Function :", 1)[1].strip(), [])
            labels, pending = {}, []
            continue
        label = SASS_LABEL.match(line)
        if label:
            pending.append(label.group(1))
            continue
        found = SASS_LINE.match(line)
        if insts is None or not found:
            continue
        words = [w for w in found.group(2).split("/*", 1)[0].split() if not w.startswith("@")]
        if not words or not words[0][0].isupper():
            continue
        address = int(found.group(1), 16)
        for name in pending:
            labels[name] = address
        pending = []
        insts.append([address, " ".join(words).rstrip(" ;"), found.group(2)])
    for insts in kernels.values():                 # branch targets, by label or address
        for inst in insts:
            target = BRANCH.search(inst[2])
            inst[2] = (None if target is None else labels.get(target.group(1)) if target.group(1)
                       else int(target.group(2), 16))
    return {name: [tuple(inst) for inst in insts] for name, insts in kernels.items()}


def library_sass(library: str) -> dict[str, list[str]]:
    """Kernel name -> its SASS instructions (opcode first, predicates dropped) in the built
    library of ``csrc/<library>.cu``, from ``cuobjdump -sass``."""
    from wav2vec_heart_sounds_tpu_torch.ops.kernels import build

    return {name: [text for _, text, _ in insts]
            for name, insts in sass_listing(str(build._target(library))).items()}


def innermost_loops(insts: list[tuple[int, str, int | None]]) -> list[list[str]]:
    """The instructions (no NOPs) of each innermost loop of one kernel's SASS: the span from
    a backward branch's target to the branch that holds no other such span and no ``EXIT``
    (a span over an ``EXIT`` is a slow path, placed after the kernel's code, returning into
    the code it left: no loop)."""
    exits = [address for address, text, _ in insts if text.startswith("EXIT")]
    spans = [(target, address) for address, _, target in insts
             if target is not None and target <= address
             and not any(target <= e <= address for e in exits)]
    inner = [(lo, hi) for lo, hi in spans
             if not any((lo, hi) != (a, b) and lo <= a and b <= hi for a, b in spans)]
    return [[text for address, text, _ in insts if lo <= address <= hi and
             not text.startswith("NOP")] for lo, hi in inner]


def innermost_loop(insts: list[tuple[int, str, int | None]]) -> list[str]:
    """The largest of ``innermost_loops``."""
    return max(innermost_loops(insts), key=len, default=[])


def variant_libraries(specs: dict) -> dict[str, Path]:
    """Builds of ``csrc/<name>.cu`` with extra ``-D`` defines, ``{label: (name, defines)}``:
    one ``nvcc`` each, all started together, into ``build/torch_kernels/variants/`` (named by
    the package build's hash and the defines; an existing one is reused). Returns
    ``{label: library path}``; a failed build fails the run."""
    import hashlib
    import os

    from wav2vec_heart_sounds_tpu_torch.ops.kernels import build

    out_dir = build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs, paths = [], {}
    for label, (name, defines) in specs.items():
        digest = hashlib.sha256(" ".join((build._target(name).name, *defines)).encode())
        out = out_dir / f"lib{name}_{digest.hexdigest()[:16]}.so"
        paths[label] = out
        if out.exists():
            continue
        tmp = out.with_name(out.name + f".tmp{os.getpid()}")
        cmd = [build.find_nvcc(), *build.NVCC_FLAGS, *defines, "-o", str(tmp),
               str(build.CSRC_DIR / f"{name}.cu")]
        jobs.append((label, tmp, out, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                       stderr=subprocess.STDOUT, text=True)))
    for label, tmp, out, proc in jobs:
        log = proc.communicate()[0]
        check(proc.returncode == 0, f"nvcc failed to build the variant '{label}':\n{log}")
        os.replace(tmp, out)
    return paths


@functools.cache
def philox_instructions() -> int:
    """Integer instructions of one ``philox_group`` call, from the SASS of the built
    ``philox_fill_kernel`` (one call an element): the instructions of ``PHILOX_OPCODES``
    over the calls the kernel's code holds (its high-half multiplies over 20), its loop's
    index and address arithmetic included (a few of them)."""
    ops = [line.split()[0] for name, lines in library_sass("dropout").items()
           if "philox_fill_kernel" in name for line in lines]
    calls = round(sum(op.startswith(HIGH_MULTIPLIES) for op in ops) / 20)
    count = sum(op.split(".")[0] in PHILOX_OPCODES for op in ops)
    check(calls > 0 and count > 0, f"no Philox call found in philox_fill_kernel's SASS: {ops}")
    return round(count / calls)


def philox_ops(elements: int, rate: float) -> float:
    """Integer instructions of the masks of ``elements`` elements: one Philox call per four,
    none at rate 0 (the kernels skip Philox there)."""
    return 0.0 if rate == 0 else -(-elements // 4) * philox_instructions()


@functools.cache
def k5_instructions(dtype, backward: bool, library: str | None = None) -> float:
    """Instructions a thread issues per element in the main loop of the built K5 kernel
    (``csrc/ffn_act.cu``, or the build at ``library``) for ``dtype``: the instructions of the
    largest innermost loop in its SASS (the forward's takes one 16-byte run a trip, the
    backward's one row of four columns) over the elements of a trip
    (``ffn_act_trip_elements``)."""
    from wav2vec_heart_sounds_tpu_torch.ops.kernels import build
    from wav2vec_heart_sounds_tpu_torch.ops.kernels.dropout import DTYPE_CODES

    path = library or str(build._target("ffn_act"))
    kernel = "ffn_act_bwd_kernel" if backward else "ffn_act_fwd_kernel"
    bf16 = dtype == torch.bfloat16
    bodies = [innermost_loop(insts) for name, insts in sass_listing(path).items()
              if kernel in name and ("bfloat16" in name) == bf16]
    check(len(bodies) == 1 and bool(bodies[0]), f"no main loop found in {kernel}'s SASS ({dtype})")
    trip = ctypes.CDLL(path).ffn_act_trip_elements
    trip.argtypes, trip.restype = [ctypes.c_int, ctypes.c_int], ctypes.c_int
    return len(bodies[0]) / trip(DTYPE_CODES[dtype], int(backward))


# K7's SASS counted for its bound: sinc_delay.cu built with every sample in one form and one
# tap a trip of its tap loop.
K7_FORM_BUILDS = {form: ("sinc_delay", (f"-DW2V_SINC_FORM={code}", "-DW2V_SINC_UNROLL=1"))
                  for form, code in (("near", 1), ("far", 2))}
K7_ENTRIES = {"sinc_delay_fwd": "sinc_delay_fwd_kernel", "sinc_delay_grad_d":
              "sinc_delay_grad_d_kernel", "sinc_delay_grad_x": "sinc_delay_grad_x_kernel"}
FP64_OPCODES = ("DADD", "DMUL", "DFMA", "DSETP", "DMNMX", "DSET")


def k7_kinds(ops: list[str]) -> dict:
    """Float64 instructions (``FP64_OPCODES``), conversions to or from float64 (``F2F``,
    ``I2F``/``F2I`` with an F64 operand) and special-function instructions (``MUFU``)."""
    return {"fp64": sum(op.split(".")[0] in FP64_OPCODES for op in ops),
            "conversions": sum(op.startswith(("F2F", "I2F", "F2I")) and "F64" in op
                               for op in ops),
            "special": sum(op.startswith("MUFU") for op in ops)}


@functools.cache
def k7_form_counts() -> dict:
    """``{form: {entry: kinds}}`` (``k7_kinds``, and all its ``instructions``) of one tap of
    each K7 entry's kernel built with every sample in that form (``K7_FORM_BUILDS``): its tap
    loop, the innermost loop that reads the window from ``__constant__`` memory (bank
    ``c[0x3]``). The code a sample runs once (staging, the sort, the last division) is left
    out: a bound."""
    out = {}
    for form, path in variant_libraries(K7_FORM_BUILDS).items():
        listing = sass_listing(str(path))
        out[form] = {}
        for entry, kernel in K7_ENTRIES.items():
            insts = [insts for name, insts in listing.items() if kernel in name]
            check(len(insts) == 1, f"no single {kernel} in the {form}-form build's SASS")
            taps = [body for body in innermost_loops(insts[0])
                    if any("c[0x3]" in text for text in body)]
            check(len(taps) == 1, f"no single tap loop in {kernel}'s {form}-form SASS")
            ops = [text.split()[0] for text in taps[0]]
            out[form][entry] = {**k7_kinds(ops), "instructions": len(ops)}
    return out


def k7_bound(entry: str, bytes_moved: float, d: torch.Tensor) -> dict:
    """K7's bound on delays ``d``: bytes, or K taps of each form's float64 instructions,
    conversions and special-function instructions (``k7_form_counts``) times that form's
    samples in this draw, at their rates, whichever is larger."""
    K = len(K7_WINDOW)
    far = int((torch.round(d).abs() > K // 2).sum())
    samples = {"far": far, "near": d.numel() - far}
    c = k7_form_counts()
    work = {kind: sum(K * n * c[form][entry][kind] for form, n in samples.items())
            for kind in ("fp64", "conversions", "special")}
    b = bound(bytes_moved, 0.0, torch.float32, exps=work["special"], fp64=work["fp64"],
              conversions=work["conversions"])
    return {**b, "far_share": far / d.numel(),
            "per_tap": {form: c[form][entry] for form in samples}}


def bound(bytes_moved: float, flops: float, dtype, exps: float = 0.0, int_ops: float = 0.0,
          instructions: float = 0.0, fp64: float = 0.0, conversions: float = 0.0) -> dict:
    """The least time the card could take: bytes over the memory rate, or operations over
    their rates, whichever is larger (H100 SXM data-sheet rates): products at the peak rate
    for ``dtype`` (a torch dtype, or ``"tf32"`` for float32 products on the tensor cores),
    ``exps`` on the special-function units, ``int_ops`` at the INT32 rate, ``instructions``
    (every instruction a thread issues) at the issue rate, ``fp64`` at the float64 rate,
    ``conversions`` at the F2F rate. Returns the bound, its side, and both sides' times."""
    mem_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    clock = sm_clock_hz() if int_ops or instructions or fp64 or conversions else 0.0
    op_ms = max(flops / PEAK_FLOPS[dtype], exps / EXP_PER_S,
                int_ops / (INT_PER_CLOCK_SM * SMS * clock) if int_ops else 0.0,
                instructions / 32 / (ISSUE_PER_CLOCK_SM * SMS * clock) if instructions else 0.0,
                fp64 / (FP64_PER_CLOCK_SM * SMS * clock) if fp64 else 0.0,
                conversions / (F2F_PER_CLOCK_SM * SMS * clock) if conversions else 0.0) * 1e3
    return {"bound_ms": max(mem_ms, op_ms),
            "bound_by": "bytes" if mem_ms >= op_ms else "operations",
            "bytes_ms": mem_ms, "operations_ms": op_ms}


def phase_training_kernels() -> dict:
    """Phase 5: every training kernel against its plain version at the training shapes.

    Returns the bfloat16 measurements by kernel name (ms, plain_ms, max_abs_err, the bound,
    and ``library_ms``: one PyTorch call computing the same function, where there is one:
    ``F.dropout`` for K1, ``scaled_dot_product_attention`` with the key mask and dropout on
    views of the packed projection, and its autograd backward, for K3b)."""
    import torch.nn.functional as F

    from wav2vec_heart_sounds_tpu_torch.ops import philox
    from wav2vec_heart_sounds_tpu_torch.ops.kernels import attention, dropout, ffn, resid

    gen = torch.Generator(device="cuda").manual_seed(1)
    seed, site, eps = 2718281828, 7, 1e-5
    kat = dropout.philox_bits_kernel(4, 0, 0, "cuda").tolist()
    check(kat == [0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8],
          f"philox.cuh misses the Philox4x32-10 known answer: {[hex(k) for k in kat]}")
    n = ROWS * FFN
    identical(f"philox.cuh bits vs plain, {n} elements",
              dropout.philox_bits_kernel(n, seed, site, "cuda"), philox.bits(seed, site, n, "cuda"))
    for dtype in (torch.bfloat16, torch.float32):
        dt = "bf16" if dtype == torch.bfloat16 else "f32"
        fwd_mask, bwd_mask = attention_masks(seed, site, dtype=dtype)
        want = philox.keep_mask(seed, site, fwd_mask.shape, RATE, "cuda")
        identical(f"attention_qkv_fwd mask {dt} (decoded) vs plain", fwd_mask, want)
        identical(f"attention_qkv_bwd mask {dt} (decoded from dv) vs plain", bwd_mask, want)
        del fwd_mask, bwd_mask, want

    records = {}
    for dtype in (torch.bfloat16, torch.float32):
        bf16 = dtype == torch.bfloat16
        dt = "bf16" if bf16 else "f32"
        # one bf16 ulp is 2^-8 relative; float32 values differ only by summation order
        elem = (1e-2, 1e-2) if bf16 else (1e-5, 1e-5)
        grad = (1e-2, 1e-2) if bf16 else (1e-4, 1e-4)
        colsum = (1e-2, 1e-4)              # float32 sums over 19104 rows, in other orders
        rec = {}

        def randn(*shape):
            return torch.randn(*shape, device="cuda", generator=gen).to(dtype)

        size = torch.finfo(dtype).bits // 8
        rows_d, rows_f = ROWS * HIDDEN * size, ROWS * FFN * size
        attn_fwd, attn_bwd = attention_work(TRAIN_BATCH, dtype)

        def timed(name, kernel, plain, err, nbytes, flops=0, library=None, int_ops=0.0):
            # CUDA events around each call, as every phase times; beside them the device time
            # of the kernel and of the library call (device_ms: no host launch work in it).
            ms, plain_ms = cuda_ms(kernel), cuda_ms(plain)
            lib_ms = cuda_ms(library) if library is not None else None
            dev_ms = device_ms(kernel)
            lib_dev_ms = device_ms(library) if library is not None else None
            b = bound(nbytes, flops, dtype, int_ops=int_ops)
            lib = f", library call {lib_ms:.4f} ms" if lib_ms is not None else ""
            lib_dev = f", library call {lib_dev_ms:.4f} ms" if lib_dev_ms is not None else ""
            print(f"[train-kernel] {name} {dt}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms"
                  f"{lib} (CUDA events, median of 20); device time kernel {dev_ms:.4f} ms"
                  f"{lib_dev} (device_ms); bound {b['bound_ms']:.4f} ms by {b['bound_by']} "
                  f"(bytes {b['bytes_ms']:.4f} ms, operations {b['operations_ms']:.4f} ms; "
                  f"{b['bound_ms'] / dev_ms:.0%} of it by device time)")
            rec[name] = {"ms": ms, "plain_ms": plain_ms, "max_abs_err": err, **b,
                         "library_ms": lib_ms, "device_ms": dev_ms,
                         "library_device_ms": lib_dev_ms}

        # K1 dropout, [96*199, 768]
        x = randn(ROWS, HIDDEN)
        ones = torch.ones_like(x)
        identical(f"dropout mask {dt}", dropout.dropout_kernel(ones, seed, site, RATE),
                  dropout.dropout_reference(ones, seed, site, RATE))
        err = agree(f"dropout {dt} [{ROWS}, {HIDDEN}]", dropout.dropout_kernel(x, seed, site, RATE),
                    dropout.dropout_reference(x, seed, site, RATE), 0.0, 0.0)
        timed("dropout", lambda: dropout.dropout_kernel(x, seed, site, RATE),
              lambda: dropout.dropout_reference(x, seed, site, RATE), err, 2 * rows_d,
              library=lambda: F.dropout(x, RATE, training=True),
              int_ops=philox_ops(x.numel(), RATE))

        # K2 dropout + add + LayerNorm, [96*199, 768]
        h, g = randn(ROWS, HIDDEN), randn(ROWS, HIDDEN)
        w = 1.0 + 0.1 * torch.randn(HIDDEN, device="cuda", generator=gen)
        b = 0.1 * torch.randn(HIDDEN, device="cuda", generator=gen)
        args = (seed, site, RATE, eps)
        identical(f"resid mask {dt} (s of h=1, x=0)",
                  resid.resid_fwd_kernel(ones, torch.zeros_like(x), w, b, *args)[1],
                  resid.resid_fwd_reference(ones, torch.zeros_like(x), w, b, *args)[1])
        out_k, s_k = resid.resid_fwd_kernel(h, x, w, b, *args)
        out_p, s_p = resid.resid_fwd_reference(h, x, w, b, *args)
        agree(f"resid_fwd s {dt}", s_k, s_p, 0.0, 0.0)
        err = agree(f"resid_fwd out {dt}", out_k, out_p, *elem)
        vectors = 2 * HIDDEN * 4                          # gamma and beta, float32
        timed("resid_fwd", lambda: resid.resid_fwd_kernel(h, x, w, b, *args),
              lambda: resid.resid_fwd_reference(h, x, w, b, *args), err, 4 * rows_d + vectors,
              int_ops=philox_ops(h.numel(), RATE))
        got = resid.resid_bwd_kernel(g, s_p, w, *args)
        ref = resid.resid_bwd_reference(g, s_p, w, *args)
        err = max(agree(f"resid_bwd {name} {dt}", a, r, *tol) for name, a, r, tol in
                  zip(("dh", "dx", "dweight", "dbias"), got, ref, (grad, grad, colsum, colsum)))
        # the partial rows (two of 768 floats a block), written once and read once
        partials = 2 * 2 * resid.grid_blocks(ROWS, HIDDEN, dtype, g.device, True) * HIDDEN * 4
        timed("resid_bwd", lambda: resid.resid_bwd_kernel(g, s_p, w, *args),
              lambda: resid.resid_bwd_reference(g, s_p, w, *args), err,
              4 * rows_d + vectors // 2 + partials, int_ops=philox_ops(g.numel(), RATE))
        del h, g, out_k, s_k, out_p, s_p, got, ref
        k1_k2_shapes(dtype, gen, seed, site, eps, elem, grad, colsum)

        # K5 FFN activation, [96*199, 3072]
        pre, g = randn(ROWS, FFN), randn(ROWS, FFN)
        ten = torch.full_like(pre, 10.0)                     # gelu(10) = 10 in both forms
        args = (seed, site, RATE)
        identical(f"ffn_act mask {dt} (y of pre=10)", ffn.ffn_act_fwd_kernel(ten, *args),
                  ffn.ffn_act_fwd_reference(ten, *args))
        identical(f"ffn_act_bwd mask {dt} (zero pattern of dpre, g=1, pre=10)",
                  ffn.ffn_act_bwd_kernel(torch.ones_like(g), ten, *args)[0] == 0,
                  ffn.ffn_act_bwd_reference(torch.ones_like(g), ten, *args)[0] == 0)
        err = agree(f"ffn_act_fwd {dt} [{ROWS}, {FFN}]", ffn.ffn_act_fwd_kernel(pre, *args),
                    ffn.ffn_act_fwd_reference(pre, *args), *elem)
        # The bound: each tensor once (and the backward's partial rows written and read
        # once), or the masks' Philox instructions at the integer rate, as K1's and K2's.
        # Beside it, what the built kernel spends: every instruction its main loop issues per
        # element (its SASS) at the issue rate, which counts the kernel's own overheads and so
        # is no bound of the function.
        per_elem = k5_instructions(dtype, False), k5_instructions(dtype, True)
        issue_ms = [bound(0.0, 0.0, dtype, instructions=n * pre.numel())["operations_ms"]
                    for n in per_elem]
        print(f"[train-kernel] ffn_act {dt}: {per_elem[0]:.2f} / {per_elem[1]:.2f} instructions "
              f"an element in the built forward / backward main loop (SASS), "
              f"{issue_ms[0]:.4f} / {issue_ms[1]:.4f} ms at the issue rate")
        timed("ffn_act_fwd", lambda: ffn.ffn_act_fwd_kernel(pre, *args),
              lambda: ffn.ffn_act_fwd_reference(pre, *args), err, 2 * rows_f,
              int_ops=philox_ops(pre.numel(), RATE))
        got, ref = ffn.ffn_act_bwd_kernel(g, pre, *args), ffn.ffn_act_bwd_reference(g, pre, *args)
        err = max(agree(f"ffn_act_bwd dpre {dt}", got[0], ref[0], *grad),
                  agree(f"ffn_act_bwd dbias {dt}", got[1], ref[1], *colsum))
        identical(f"ffn_act_bwd dpre and dbias {dt}, two runs",
                  torch.cat([t.float().flatten() for t in ffn.ffn_act_bwd_kernel(g, pre, *args)]),
                  torch.cat([t.float().flatten() for t in got]))
        partials = 2 * min(ROWS, ffn.MAX_CHUNKS) * FFN * 4       # per-chunk partial rows
        timed("ffn_act_bwd", lambda: ffn.ffn_act_bwd_kernel(g, pre, *args),
              lambda: ffn.ffn_act_bwd_reference(g, pre, *args), err, 3 * rows_f + partials,
              int_ops=philox_ops(pre.numel(), RATE))
        for name, n, t in zip(("ffn_act_fwd", "ffn_act_bwd"), per_elem, issue_ms):
            rec[name].update(instructions_per_element=n, issue_ms=t)
        del pre, g, ten, got, ref, x, ones
        # a generator of their own, so that the inputs drawn after them stay as they were
        k5_shapes(dtype, torch.Generator(device="cuda").manual_seed(12), seed, site, elem,
                  grad, colsum)

        # K3b attention with dropout, [96, 36, 199, 64], then at t = 150 keys: on the head
        # view of a [B, T, 3H, d] projection (the encoder's layout, no copy), held bit for bit
        # to the contiguous packed tensor of the same values and to a second run of itself
        strided = randn(TRAIN_BATCH, T, 3 * H, D).transpose(1, 2)
        qkv, dout = strided.contiguous(), randn(TRAIN_BATCH, H, T, D)
        for t in (T, 150):
            args = (t, RATE, seed, site)
            out_k, lse_k = attention.attention_qkv_fwd(strided, *args, with_lse=True)
            out_c, lse_c = attention.attention_qkv_fwd(qkv, *args, with_lse=True)
            identical(f"attention_qkv_fwd out {dt} t={t}, strided view vs contiguous", out_k, out_c)
            identical(f"attention_qkv_fwd lse {dt} t={t}, strided view vs contiguous", lse_k, lse_c)
            out_p, lse_p = attention.attention_qkv_reference(strided, *args, with_lse=True)
            err_f = agree(f"attention_qkv_fwd out {dt} t={t}", out_k, out_p, *elem)
            agree(f"attention_qkv_fwd lse {dt} t={t}", lse_k, lse_p, 1e-5, 1e-5)
            dqkv = attention.attention_qkv_bwd(strided, out_p, dout, lse_p, *args)
            identical(f"attention_qkv_bwd dqkv {dt} t={t}, two runs",
                      attention.attention_qkv_bwd(strided, out_p, dout, lse_p, *args), dqkv)
            identical(f"attention_qkv_bwd dqkv {dt} t={t}, strided view vs contiguous",
                      attention.attention_qkv_bwd(qkv, out_p, dout, lse_p, *args), dqkv)
            err_b = agree(f"attention_qkv_bwd dqkv {dt} t={t}", dqkv,
                          attention.attention_qkv_bwd_reference(strided, out_p, dout, lse_p, *args),
                          *((2e-2, 2e-2) if bf16 else grad))
            if t == T:
                errs = (err_f, err_b)
        args = (T, RATE, seed, site)
        keys = torch.ones(TRAIN_BATCH, 1, 1, T, dtype=torch.bool, device="cuda")   # key mask

        def sdpa(packed):
            return F.scaled_dot_product_attention(packed[:, :H], packed[:, H:2 * H],
                                                  packed[:, 2 * H:], attn_mask=keys,
                                                  dropout_p=RATE)

        timed("attention_qkv_fwd",
              lambda: attention.attention_qkv_fwd(strided, *args, with_lse=True),
              lambda: attention.attention_qkv_reference(strided, *args, with_lse=True), errs[0],
              *attn_fwd, library=lambda: sdpa(strided))
        rec["attention_qkv_fwd"]["contiguous_ms"] = cuda_ms(
            lambda: attention.attention_qkv_fwd(qkv, *args, with_lse=True))
        leaf = strided.detach().requires_grad_()
        lib_out = sdpa(leaf)
        timed("attention_qkv_bwd",
              lambda: attention.attention_qkv_bwd(strided, out_p, dout, lse_p, *args),
              lambda: attention.attention_qkv_bwd_reference(strided, out_p, dout, lse_p, *args),
              errs[1], *attn_bwd,
              library=lambda: torch.autograd.grad(lib_out, leaf, dout, retain_graph=True))
        rec["attention_qkv_bwd"]["contiguous_ms"] = cuda_ms(
            lambda: attention.attention_qkv_bwd(qkv, out_p, dout, lse_p, *args))
        print(f"[train-kernel] attention_qkv {dt} on the contiguous [96, 36, 199, 64] tensor: "
              f"fwd {rec['attention_qkv_fwd']['contiguous_ms']:.4f} ms, bwd "
              f"{rec['attention_qkv_bwd']['contiguous_ms']:.4f} ms (CUDA events, median of 20)")
        del qkv, strided, dout, out_k, out_c, out_p, lse_k, lse_c, lse_p, dqkv, leaf, lib_out
        torch.cuda.empty_cache()
        if bf16:
            records = rec
    return records


# The other widths K2 takes (rows, cols): the test config's 32 columns (its 2 x 399 frames),
# wav2vec2-large's 1024 at the training rows, and 40 (five bf16 runs, ten f32 ones: no whole
# pass of 32 lanes) at a ragged row count.
K2_WIDTHS = ((798, 32), (ROWS, 1024), (127, 40))

# K2's other shapes: fusion's rows (64 x 51), ragged row counts (127, and one row: fewer than a
# tile of 8, no whole tile) and a width of 384 (the lanes of the last pass half idle in bf16).
K2_SHAPES = ((FUSION_BATCH * FUSION_FRAMES, HIDDEN), (127, HIDDEN), (1, HIDDEN), (ROWS, 384),
             *K2_WIDTHS)
# K1's: the vest's LoRA inputs (16 x 25 rows), and an odd length on a view one element past
# 16 bytes.
K1_SHAPES = ((VEST_BATCH * VEST_FRAMES, HIDDEN), (100003,))


def k1_k2_shapes(dtype, gen, seed: int, site: int, eps: float, elem, grad, colsum) -> None:
    """K1 and K2 against their plain versions at ``K1_SHAPES`` and ``K2_SHAPES``, rate 0.1:
    masks, K1's output and K2's s bit for bit, K2's other outputs at phase 5's bars; K2's
    wrappers refuse a view one element past 16 bytes, K1 takes it."""
    from wav2vec_heart_sounds_tpu_torch.ops.kernels import dropout, resid

    dt = "bf16" if dtype == torch.bfloat16 else "f32"

    def randn(*shape):
        return torch.randn(*shape, device="cuda", generator=gen).to(dtype)

    for shape in K1_SHAPES:
        offset = len(shape) == 1
        x = randn(shape[0] + offset)[offset:] if offset else randn(*shape)
        ones = torch.ones_like(x)
        where = f"{list(shape)}{', offset view' if offset else ''}"
        out = dropout.dropout_kernel(x, seed, site, RATE)
        identical(f"dropout mask {dt} {where}", dropout.dropout_kernel(ones, seed, site, RATE),
                  dropout.dropout_reference(ones, seed, site, RATE))
        identical(f"dropout {dt} {where}", out, dropout.dropout_reference(x, seed, site, RATE))
    for rows, cols in K2_SHAPES:
        x, h, g = randn(rows, cols), randn(rows, cols), randn(rows, cols)
        w = 1.0 + 0.1 * torch.randn(cols, device="cuda", generator=gen)
        b = 0.1 * torch.randn(cols, device="cuda", generator=gen)
        args = (seed, site, RATE, eps)
        where = f"{dt} [{rows}, {cols}]"
        identical(f"resid mask {where} (s of h=1, x=0)",
                  resid.resid_fwd_kernel(torch.ones_like(h), torch.zeros_like(x), w, b, *args)[1],
                  resid.resid_fwd_reference(torch.ones_like(h), torch.zeros_like(x), w, b, *args)[1])
        out_k, s_k = resid.resid_fwd_kernel(h, x, w, b, *args)
        out_p, s_p = resid.resid_fwd_reference(h, x, w, b, *args)
        identical(f"resid_fwd s {where}", s_k, s_p)
        agree(f"resid_fwd out {where}", out_k, out_p, *elem)
        got = resid.resid_bwd_kernel(g, s_p, w, *args)
        ref = resid.resid_bwd_reference(g, s_p, w, *args)
        for name, a, r, tol in zip(("dh", "dx", "dweight", "dbias"), got, ref,
                                   (grad, grad, colsum, colsum)):
            agree(f"resid_bwd {name} {where}", a, r, *tol)
        keep = torch.ones_like(g)       # the backward's mask: dh of g = ones has its zeros
        identical(f"resid_bwd zero pattern of dh {where}",
                  resid.resid_bwd_kernel(keep, s_p, w, *args)[0] == 0,
                  resid.resid_bwd_reference(keep, s_p, w, *args)[0] == 0)
    view = randn(2 * HIDDEN + 1)[1:].view(2, HIDDEN)     # one element past 16 bytes
    w, b = torch.ones(HIDDEN, device="cuda"), torch.zeros(HIDDEN, device="cuda")
    before = resid.resid_fwd_kernel.launches
    with contextlib.suppress(ValueError):          # the refusal this check asks for
        resid.resid_fwd_kernel(view, view, w, b, seed, site, RATE, eps)
        check(False, "resid_fwd_kernel took a view that does not start on 16 bytes")
    check(resid.resid_fwd_kernel.launches == before, "resid_fwd_kernel launched on a bad view")
    print(f"[train-kernel] resid_fwd_kernel {dt}: refuses a view one element past 16 bytes")


# K5's other shapes: a ragged row count (fewer rows than the backward's 256 chunks) and the
# tiny config's 64 columns, and for the forward an odd length on a view that starts on 16
# bytes (a tail of fewer than 8 elements).
K5_SHAPES = ((127, FFN), (400, 64), (100003,))


def k5_shapes(dtype, gen, seed: int, site: int, elem, grad, colsum) -> None:
    """K5 against its plain version at ``K5_SHAPES``, rate 0.1: the masks bit for bit (y of
    pre = 10, and the backward's zero pattern), y, dpre and dbias at phase 5's bars; the
    forward's wrapper refuses a view one element past 16 bytes."""
    from wav2vec_heart_sounds_tpu_torch.ops.kernels import ffn

    dt = "bf16" if dtype == torch.bfloat16 else "f32"
    args = (seed, site, RATE)
    for shape in K5_SHAPES:
        pre = torch.randn(*shape, device="cuda", generator=gen).to(dtype)
        ten = torch.full_like(pre, 10.0)
        where = f"{dt} {list(shape)}"
        identical(f"ffn_act mask {where} (y of pre=10)", ffn.ffn_act_fwd_kernel(ten, *args),
                  ffn.ffn_act_fwd_reference(ten, *args))
        agree(f"ffn_act_fwd {where}", ffn.ffn_act_fwd_kernel(pre, *args),
              ffn.ffn_act_fwd_reference(pre, *args), *elem)
        if len(shape) == 1:
            continue
        g = torch.randn(*shape, device="cuda", generator=gen).to(dtype)
        got, ref = ffn.ffn_act_bwd_kernel(g, pre, *args), ffn.ffn_act_bwd_reference(g, pre, *args)
        agree(f"ffn_act_bwd dpre {where}", got[0], ref[0], *grad)
        agree(f"ffn_act_bwd dbias {where}", got[1], ref[1], *colsum)
        identical(f"ffn_act_bwd zero pattern of dpre {where} (g=1, pre=10)",
                  ffn.ffn_act_bwd_kernel(torch.ones_like(g), ten, *args)[0] == 0,
                  ffn.ffn_act_bwd_reference(torch.ones_like(g), ten, *args)[0] == 0)
    view = torch.randn(2 * FFN + 1, device="cuda", generator=gen).to(dtype)[1:].view(2, FFN)
    before = ffn.ffn_act_fwd_kernel.launches
    with contextlib.suppress(ValueError):          # the refusal this check asks for
        ffn.ffn_act_fwd_kernel(view, *args)
        check(False, "ffn_act_fwd_kernel took a view that does not start on 16 bytes")
    check(ffn.ffn_act_fwd_kernel.launches == before, "ffn_act_fwd_kernel launched on a bad view")
    print(f"[train-kernel] ffn_act_fwd_kernel {dt}: refuses a view one element past 16 bytes")


# The row counts K4 runs at: CinC training (96 x 199 frames), fusion (64 x 51), the vest
# (16 x 25), and a ragged count inside one 128-row tile.
K4_ROWS = (ROWS, FUSION_BATCH * FUSION_FRAMES, VEST_BATCH * VEST_FRAMES, 127)
# The kernels K4 launches in bf16, by stage (csrc/ffn_mega.cu and csrc/resid.cuh), and
# whether the stage is a product of 2 * rows * 768 * 3072 operations.
K4_STAGES = (("(A) x W1^T", "ffn_up_wgmma_kernel", True),
             ("(B) h W2^T", "ffn_down_wgmma_kernel", True),
             ("LN pass", "ln_rows_kernel", False),
             ("(C) row pass", "resid_bwd_kernel", False),
             ("(D) dhid W2", "ffn_dgrad_wgmma_kernel", True))


def decomposed_ffn_fwd(x, w1, b1, w2, b2, lw, lb, seed, s_act, s_hid, rate_act, rate_hid, eps):
    """K4's yardstick forward: cuBLAS products, K5, then K2."""
    from wav2vec_heart_sounds_tpu_torch.ops.kernels import ffn, resid

    h = ffn.ffn_act_fwd_kernel(torch.nn.functional.linear(x, w1, b1), seed, s_act, rate_act)
    return resid.resid_fwd_kernel(torch.nn.functional.linear(h, w2, b2), x, lw, lb, seed,
                                  s_hid, rate_hid, eps)


def decomposed_ffn_bwd(g, s, pre, w2, lw, seed, s_act, s_hid, rate_act, rate_hid, eps):
    """K4's yardstick backward (its in-kernel part): K2's backward, cuBLAS, K5's backward."""
    from wav2vec_heart_sounds_tpu_torch.ops.kernels import ffn, resid

    dhid, _, _, _ = resid.resid_bwd_kernel(g, s, lw, seed, s_hid, rate_hid, eps)
    return ffn.ffn_act_bwd_kernel(dhid @ w2, pre, seed, s_act, rate_act)


def print_k4_stages(fwd, bwd, rows: int, runs: int = 10) -> dict:
    """Device ms per call of each K4 stage kernel (``torch.profiler`` over ``runs`` forward
    and backward calls after a warm-up, each kernel's time over the launches the profile
    recorded), and each product's TFLOP/s."""
    cuda = torch.autograd.DeviceType.CUDA
    fwd(), bwd()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fwd(), bwd()
        torch.cuda.synchronize()
    stage_ms = {}
    for e in prof.key_averages():
        for stage, kernel, _ in K4_STAGES:
            if e.device_type == cuda and kernel in e.key:
                stage_ms[stage] = (stage_ms.get(stage, 0.0)
                                   + e.self_device_time_total / 1e3 / e.count)
    for stage, kernel, product in K4_STAGES:
        ms = stage_ms.get(stage)
        check(ms is not None, f"the profile shows no {kernel} launch")
        rate = f", {2 * rows * HIDDEN * FFN / ms / 1e9:.1f} TFLOP/s" if product else ""
        print(f"[train-kernel] K4 stage {stage} ({kernel}) bf16 [{rows}, {HIDDEN}] -> {FFN}: "
              f"{ms:.4f} ms{rate} (torch.profiler, mean of {runs})")
    return stage_ms


K4_SEED, K4_SITES, K4_EPS = 3141592653, (4, 5), 1e-5


def k4_tolerances(dtype) -> tuple:
    """(elem, grad, colsum) bars of K4 against its plain version. bf16: the kernel's products
    sum in another order than cuBLAS, so pre (and dh) may differ by one ulp (2^-8 relative)
    before two more roundings; float32 differs only by summation order. Column sums over up
    to 19104 rows are compared relative."""
    if dtype == torch.bfloat16:
        return (3e-2, 2e-2), (3e-2, 2e-2), (1e-1, 2e-2)
    return (1e-5, 1e-5), (1e-4, 1e-4), (1e-2, 1e-4)


def k4_weights(gen, dtype, d: int, f: int) -> tuple:
    """(w1, b1, w2, b2, LayerNorm weight, LayerNorm bias) of a [d] -> [f] -> [d] sublayer."""
    def randn(*shape, std=1.0):
        return (std * torch.randn(*shape, device="cuda", generator=gen)).to(dtype)

    w1, b1 = randn(f, d, std=d ** -0.5), randn(f, std=0.1)
    w2, b2 = randn(d, f, std=f ** -0.5), randn(d, std=0.1)
    lw = 1.0 + 0.1 * torch.randn(d, device="cuda", generator=gen)
    lb = 0.1 * torch.randn(d, device="cuda", generator=gen)
    return w1, b1, w2, b2, lw, lb


def k4_check(weights: tuple, x, g) -> tuple:
    """K4 against its plain version on rows ``x`` and cotangent ``g`` at rate 0.1: pre, s, y
    and every output of the backward at ``k4_tolerances``, and both masks bit for bit through
    the zero patterns of the backward's h (act mask) and dhid (hidden mask), which contain
    the masks' zeros. Returns (forward error, backward error, forward inputs, backward
    inputs, the plain forward's (y, s, pre))."""
    from wav2vec_heart_sounds_tpu_torch.ops import philox
    from wav2vec_heart_sounds_tpu_torch.ops.kernels import megakernel as mk

    elem, grad, colsum = k4_tolerances(x.dtype)
    dt = "bf16" if x.dtype == torch.bfloat16 else "f32"
    (rows, d), f = x.shape, weights[0].shape[0]
    args = (K4_SEED, *K4_SITES, RATE, RATE, K4_EPS)
    fwd_in = (x, *weights, *args)
    y_k, s_k, pre_k = mk.ffn_mega_fwd_kernel(*fwd_in)
    plain = mk.ffn_mega_fwd_reference(*fwd_in)
    err = max(agree(f"ffn_mega_fwd {name} {dt} [{rows}, {d}] -> {f}", a, r, *elem)
              for name, a, r in zip(("y", "s", "pre"), (y_k, s_k, pre_k), plain))
    del y_k, s_k, pre_k
    bwd_in = (g, plain[1], plain[2], weights[2], weights[4], *args)
    got = mk.ffn_mega_bwd_kernel(*bwd_in)
    ref = mk.ffn_mega_bwd_reference(*bwd_in)
    names = ("ds", "dhid", "dpre", "h", "db1", "db2", "dweight", "dbias")
    err_b = max(agree(f"ffn_mega_bwd {name} {dt} [{rows}, {d}] -> {f}", a, r,
                      *(colsum if i >= 4 else grad))
                for i, (name, a, r) in enumerate(zip(names, got, ref)))
    for name, a, r, site, shape in (("h (act mask)", got[3], ref[3], K4_SITES[0], (rows, f)),
                                    ("dhid (hidden mask)", got[1], ref[1], K4_SITES[1],
                                     (rows, d))):
        keep = philox.keep_mask(K4_SEED, site, shape, RATE, "cuda")
        check(not bool((r[~keep] != 0).any()), f"plain {name} is nonzero off its mask")
        identical(f"ffn_mega_bwd zero pattern of {name} {dt} [{rows}, {d}] -> {f}", a == 0,
                  r == 0)
    return err, err_b, fwd_in, bwd_in, plain


# The other widths K4 takes, (hidden, FFN, rows): the test config's (its 2 x 399 frames),
# wav2vec2-large's (at fusion's rows), and widths that are no multiple of a tile (a ragged
# row count).
K4_WIDTHS = ((32, 64, 798), (1024, 4096, FUSION_BATCH * FUSION_FRAMES), (40, 72, 127))


def k4_widths() -> None:
    """K4 (``k4_check``) at ``K4_WIDTHS``, bfloat16 and float32."""
    gen = torch.Generator(device="cuda").manual_seed(16)
    for dtype in (torch.bfloat16, torch.float32):
        for d, f, rows in K4_WIDTHS:
            x, g = (torch.randn(rows, d, device="cuda", generator=gen).to(dtype) for _ in "xg")
            k4_check(k4_weights(gen, dtype, d, f), x, g)
    torch.cuda.empty_cache()


def phase_megakernel() -> dict:
    """K4 (the FFN-sublayer kernels) against its plain version in bfloat16 and float32 at
    rate 0.1, at every row count of ``K4_ROWS`` (``k4_check``), and at the training shape
    timed beside the decomposed route (``F.linear`` + K5 + ``F.linear`` + K2), with the device
    time of each bf16 stage. Returns the bfloat16 records by kernel name."""
    from wav2vec_heart_sounds_tpu_torch.ops.kernels import megakernel as mk

    gen = torch.Generator(device="cuda").manual_seed(11)
    records = {}
    for dtype in (torch.bfloat16, torch.float32):
        bf16 = dtype == torch.bfloat16
        dt = "bf16" if bf16 else "f32"
        params = k4_weights(gen, dtype, HIDDEN, FFN)
        for rows in K4_ROWS:
            x, g = (torch.randn(rows, HIDDEN, device="cuda", generator=gen).to(dtype)
                    for _ in "xg")
            err, err_b, fwd_in, bwd_in, (y_p, s_p, pre_p) = k4_check(params, x, g)
            if rows != ROWS:
                continue

            size = torch.finfo(dtype).bits // 8
            rows_d, rows_f = ROWS * HIDDEN * size, ROWS * FFN * size
            weights = 2 * HIDDEN * FFN * size
            products = 2 * ROWS * HIDDEN * FFN
            # forward: x, W1, W2 in; y, s, pre out. backward (in-kernel part): g, s, pre, W2
            # in; ds, dhid, dpre, h out (vectors and partials are below 0.1% of it).
            fwd_bound = bound(3 * rows_d + weights + rows_f, 2 * products, dtype)
            bwd_bound = bound(4 * rows_d + weights // 2 + 3 * rows_f, products, dtype)
            for name, kernel, plain, decomposed, b, e in (
                    ("ffn_mega_fwd", lambda: mk.ffn_mega_fwd_kernel(*fwd_in),
                     lambda: mk.ffn_mega_fwd_reference(*fwd_in),
                     lambda: decomposed_ffn_fwd(*fwd_in), fwd_bound, err),
                    ("ffn_mega_bwd", lambda: mk.ffn_mega_bwd_kernel(*bwd_in),
                     lambda: mk.ffn_mega_bwd_reference(*bwd_in),
                     lambda: decomposed_ffn_bwd(*bwd_in), bwd_bound, err_b)):
                ms, plain_ms, dec_ms = cuda_ms(kernel), cuda_ms(plain), cuda_ms(decomposed)
                print(f"[train-kernel] {name} {dt}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                      f"decomposed route (cuBLAS products + K5 + K2) {dec_ms:.4f} ms, bound "
                      f"{b['bound_ms']:.4f} ms by {b['bound_by']} (CUDA events, median of 20)")
                if bf16:
                    records[name] = {"ms": ms, "plain_ms": plain_ms, "max_abs_err": e,
                                     "decomposed_ms": dec_ms, **b, "library_ms": None}
            if bf16:
                stages = print_k4_stages(lambda: mk.ffn_mega_fwd_kernel(*fwd_in),
                                         lambda: mk.ffn_mega_bwd_kernel(*bwd_in), ROWS)
                records["ffn_mega_fwd"]["stages_ms"] = stages
            del x, g, s_p, pre_p, y_p
        torch.cuda.empty_cache()
    return records


def repeat_bits(fk, shape: str, q, k, v, o, lse, g, first) -> None:
    """K6's backward run again on the same inputs gives the same bits (no atomics)."""
    again = fk.flash_kv_bwd_kernel(q, k, v, o, lse, g)
    same = all(torch.equal(a, b) for a, b in zip(again, first))
    check(same, f"flash_kv_bwd {shape}: a second run gives other bits")
    print(f"[vest-kernel] flash_kv_bwd dq, dk, dv f32 {shape}: a second run bit-identical")


K7_WINDOW = tuple(float(w) for w in np.hamming(41).astype(np.float32))


def k7_inputs(source: torch.Generator) -> tuple:
    """K7's ``[96, 8250]`` inputs from ``source``: x and the cotangent g unit normals, the
    delays uniform in [0, 41.25] samples with 5% integers (0 to 41)."""
    R, T = VEST_BATCH * VEST_MICS, VEST_T
    x, g = (torch.randn(R, T, device="cuda", generator=source) for _ in range(2))
    d = torch.rand(R, T, device="cuda", generator=source) * (0.01 * VEST_FS)
    hit = torch.rand(R, T, device="cuda", generator=source) < 0.05
    d = torch.where(hit, torch.randint(0, 42, (R, T), device="cuda", generator=source).float(),
                    d)
    return x, g, d


def k7_draws(source: torch.Generator | None = None) -> tuple:
    """Three draws of K7's inputs, ``(label, (x, g, d))`` each: phase 9's own (from
    ``source``, its seed-21 generator after K6's four ``[16, 8250, 4, 8]`` inputs, or without
    it a fresh one that draws those first: the same values); the stream on which the forward
    once missed its bar beyond the taps (K6's ragged 4 x ``[2, 300, 4, 8]`` and
    4 x ``[2, 77, 4, 8]`` drawn from it in between); and a seed-21 generator that has drawn
    only the ragged eight."""
    def after(*shapes):
        fresh = torch.Generator(device="cuda").manual_seed(21)
        for shape in shapes:
            torch.randn(*shape, device="cuda", generator=fresh)
        return k7_inputs(fresh)

    k6 = [(VEST_BATCH, VEST_T, KV_HEADS, KV_DIM)] * 4
    ragged = [(2, 300, KV_HEADS, KV_DIM)] * 4 + [(2, 77, KV_HEADS, KV_DIM)] * 4
    first = k7_inputs(source) if source is not None else after(*k6)
    return (("after K6", first), ("after K6 and the ragged eight", after(*k6, *ragged)),
            ("after the ragged eight", after(*ragged)))


def k7_smooth_inputs(seed: int = 23) -> tuple:
    """K7's ``[96, 8250]`` inputs with delays smooth in time, as the delay predictor's clamped
    output: per row a slow sinusoid (0.5-3 Hz at 4125 Hz) of amplitude up to 15 samples
    around a centre uniform in [0, 41.25], clamped to [0, 41.25]; x and g unit normals."""
    src = torch.Generator(device="cuda").manual_seed(seed)
    R, T = VEST_BATCH * VEST_MICS, VEST_T
    x, g = (torch.randn(R, T, device="cuda", generator=src) for _ in range(2))
    top = 0.01 * VEST_FS
    centre, amp, freq, phase = (torch.rand(R, 1, device="cuda", generator=src) for _ in range(4))
    t = torch.arange(T, device="cuda") / VEST_FS
    d = top * centre + 15.0 * amp * torch.sin(2 * np.pi * (0.5 + 2.5 * freq) * t
                                              + 2 * np.pi * phase)
    return x, g, d.clamp(0.0, top)


def sinc_condition(x: torch.Tensor, d: torch.Tensor, window) -> torch.Tensor:
    """Per sample beyond the taps (|rint(d)| > K // 2), the float32 condition factor of y in
    float64: sum_k |e_k xpad[t + k]| / |sum_k e_k|, e_k = (-1)^(c_k + 1) w_k / (pi (c_k - d))."""
    K = len(window)
    half = K // 2
    x64, d64 = x.double(), d.double()
    xpad = torch.nn.functional.pad(x64[:, None], (half, half), mode="reflect")[:, 0]
    far = torch.round(d64).abs() > half
    num, den = torch.zeros_like(d64), torch.zeros_like(d64)
    for k, w in enumerate(window):
        c = k - half
        e = (1.0 if c % 2 else -1.0) * w / (np.pi * (c - d64))
        num += (e * xpad[:, k:k + x.shape[1]]).abs()
        den += e
    return (num / den.abs())[far]


def k7_checks(sk, label: str, x, g, d, window) -> tuple[float, float, float]:
    """K7 on one draw of ``[96, 8250]`` inputs: forward, ``grad_d`` and ``grad_x`` against
    the plain versions at the unchanged bars (y and s 1e-5 / 1e-5, and beyond the taps bit for
    bit; the gradients 2e-4 / 1e-3), after printing each side's largest error against the
    plain version evaluated in
    float64 (float64 copies of x and d, the same taps), inside and beyond the taps, and the
    largest float32 condition factor of y beyond them. Returns the three largest errors."""
    far = torch.round(d).abs() > len(window) // 2
    y_k, s_k = sk.sinc_fwd_kernel(x, d, window)
    y_p, s_p = sk.sinc_fwd_reference(x, d, window)
    y_64, s_64 = sk.sinc_fwd_reference(x.double(), d.double(), window)
    for name, a, r, r64 in (("y", y_k, y_p, y_64), ("s", s_k, s_p, s_64)):
        for region, sel in (("inside the taps", ~far), ("beyond the taps", far)):
            kp, k64, p64 = ((u[sel].double() - v[sel].double()).abs().max().item()
                            for u, v in ((a, r), (a, r64), (r, r64)))
            print(f"[vest-kernel] K7 {label}: sinc_delay_fwd {name} {region}: kernel vs plain "
                  f"{kp:.3e}; vs float64 kernel {k64:.3e}, plain {p64:.3e} (max |float64| "
                  f"{r64[sel].abs().max().item():.3e})")
        check(torch.equal(a[far], r[far]),
              f"sinc_delay_fwd {name} ({label}): kernel and plain differ beyond the taps")
    cond = sinc_condition(x, d, window)
    print(f"[vest-kernel] K7 {label}: {cond.numel()} samples beyond the taps, float32 condition "
          f"factor of y sum|e xpad| / |sum e| up to {cond.max().item():.1f} (median "
          f"{cond.median().item():.1f})")
    err_f = max(agree(f"sinc_delay_fwd y f32 [96, 8250] ({label})", y_k, y_p, 1e-5, 1e-5),
                agree(f"sinc_delay_fwd s f32 ({label})", s_k, s_p, 1e-5, 1e-5))
    err_d = agree(f"sinc_delay_grad_d dd f32 ({label})", sk.sinc_grad_d_kernel(x, d, g, window),
                  sk.sinc_grad_d_reference(x, d, g, window), 2e-4, 1e-3)
    err_x = agree(f"sinc_delay_grad_x dxpad f32 ({label})",
                  sk.sinc_grad_x_kernel(d, g, s_p, window),
                  sk.sinc_grad_x_reference(d, g, s_p, window), 2e-4, 1e-3)
    return err_f, err_d, err_x


def phase_vest_kernels() -> dict:
    """The vest slice's kernels against their plain versions at the vest shapes: K6 (the
    delay predictor's attention, ``[16, 8250, 4, 8]``, float32, and bfloat16 in and out
    through the boundary cast) and K7 (the sinc delay, ``[96, 8250]`` rows, delays uniform
    in [0, 41.25] with integers among them), with CUDA-event timings beside each bound and,
    for K6, ``scaled_dot_product_attention`` in float32 (forward and its autograd
    backward); K6's backward equal bit for bit to a second run, and K6 at the ragged
    T = 300 and 77 (below one tile). Then K3b at the vest encoder's T = 25 and K4 at its
    B*T = 400 rows, both dtypes, rate 0.1. Returns the K6 and K7 records by kernel name."""
    import torch.nn.functional as F

    from wav2vec_heart_sounds_tpu_torch.ops.kernels import attention, flash_kv as fk
    from wav2vec_heart_sounds_tpu_torch.ops.kernels import megakernel as mk
    from wav2vec_heart_sounds_tpu_torch.ops.kernels import sinc_delay as sk

    gen = torch.Generator(device="cuda").manual_seed(21)
    records = {}

    def randn(*shape, dtype=torch.float32, std=1.0):
        return (std * torch.randn(*shape, device="cuda", generator=gen)).to(dtype)

    def timed(name, kernel, plain, err, b, library=None, runs=20, label=""):
        # CUDA events around each call, and beside them the device time (device_ms: the
        # calls queued behind a spin kernel, no host launch work in it), as phase 5 has it
        ms, plain_ms = cuda_ms(kernel, runs), cuda_ms(plain, runs)
        lib_ms = cuda_ms(library, runs) if library is not None else None
        dev_ms = device_ms(kernel, runs)
        lib = f", library call {lib_ms:.4f} ms" if lib_ms is not None else ""
        print(f"[vest-kernel] {name}{label} f32: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms"
              f"{lib} (CUDA events, median of {runs}); device time kernel {dev_ms:.4f} ms "
              f"(device_ms); bound {b['bound_ms']:.4f} ms by {b['bound_by']} (bytes "
              f"{b['bytes_ms']:.4f} ms, operations {b['operations_ms']:.4f} ms; "
              f"{b['bound_ms'] / dev_ms:.0%} of it by device time)")
        return {"ms": ms, "plain_ms": plain_ms, "max_abs_err": err, **b, "library_ms": lib_ms,
                "device_ms": dev_ms}

    # K6 at [16, 8250, 4, 8], float32.
    B, Tv, Hk, dk = VEST_BATCH, VEST_T, KV_HEADS, KV_DIM
    q, k, v, g = (randn(B, Tv, Hk, dk) for _ in range(4))
    o_k, lse_k = fk.flash_kv_fwd_kernel(q, k, v)
    o_p, lse_p = fk.attention_kv_fwd_reference(q, k, v)
    err_f = max(agree("flash_kv_fwd o f32 [16, 8250, 4, 8]", o_k, o_p, 2e-5, 1e-4),
                agree("flash_kv_fwd lse f32", lse_k, lse_p, 2e-5, 1e-4))
    got = fk.flash_kv_bwd_kernel(q, k, v, o_p, lse_p, g)
    ref = fk.attention_kv_bwd_reference(q, k, v, o_p, lse_p, g)
    err_b = max(agree(f"flash_kv_bwd {name} f32", a, r, 1e-4, 1e-3)
                for name, a, r in zip(("dq", "dk", "dv"), got, ref))
    repeat_bits(fk, "[16, 8250, 4, 8]", q, k, v, o_p, lse_p, g, got)
    del o_k, lse_k, got, ref

    # Ragged lengths: T = 300 (a ragged key tile and query tile) and T = 77 (below one tile),
    # from a generator of their own, so that the inputs drawn after them stay as they were.
    ragged = torch.Generator(device="cuda").manual_seed(22)
    for Tr in (300, 77):
        qr, kr, vr, gr = (torch.randn(2, Tr, Hk, dk, device="cuda", generator=ragged)
                          for _ in range(4))
        o_r, lse_r = fk.attention_kv_fwd_reference(qr, kr, vr)
        o_rk, lse_rk = fk.flash_kv_fwd_kernel(qr, kr, vr)
        agree(f"flash_kv_fwd o f32 [2, {Tr}, 4, 8]", o_rk, o_r, 2e-5, 1e-4)
        agree(f"flash_kv_fwd lse f32 [2, {Tr}, 4, 8]", lse_rk, lse_r, 2e-5, 1e-4)
        got = fk.flash_kv_bwd_kernel(qr, kr, vr, o_r, lse_r, gr)
        for name, a, r in zip(("dq", "dk", "dv"), got,
                              fk.attention_kv_bwd_reference(qr, kr, vr, o_r, lse_r, gr)):
            agree(f"flash_kv_bwd {name} f32 [2, {Tr}, 4, 8]", a, r, 1e-4, 1e-3)
        repeat_bits(fk, f"[2, {Tr}, 4, 8]", qr, kr, vr, o_r, lse_r, gr, got)

    # bfloat16 in and out: float32 inside, kernels against the plain route (one bf16 ulp
    # at unit scale is 7.8e-3; the output is rounded once, each gradient once).
    def bf16_route():
        leaves = [t.to(torch.bfloat16).requires_grad_() for t in (q, k, v)]
        out = fk.flash_attention_kv(*leaves)
        out.backward(g.to(torch.bfloat16))
        return [out.detach()] + [t.grad for t in leaves]

    kernel_bf16 = bf16_route()
    with plain_route():
        plain_bf16 = bf16_route()
    for name, a, r in zip(("out", "dq", "dk", "dv"), kernel_bf16, plain_bf16):
        check(a.dtype == torch.bfloat16, f"flash_kv bf16 {name} is {a.dtype}")
        agree(f"flash_attention_kv bf16 {name}", a, r, 2e-2, 2e-2)
    del kernel_bf16, plain_bf16

    pairs = B * Hk * Tv * Tv
    qkv_bytes = 4 * B * Tv * Hk * dk
    lse_bytes = 4 * B * Hk * Tv
    # forward: q.k and p.v, 2 d FLOPs each per (query, key) pair, one exponential each;
    # backward: the five products of the gradient (q.k, g.v, ds k, ds^T q, p^T g), one
    # exponential. The kernels run the products on the tensor cores (3xTF32, three TF32
    # products each, counted once here: the function's work) and the exponentials on the
    # special-function units.
    fwd_flops, bwd_flops = 4 * dk * pairs, 10 * dk * pairs
    fwd_b = bound(4 * qkv_bytes + lse_bytes, fwd_flops, "tf32", pairs)
    bwd_b = bound(8 * qkv_bytes + lse_bytes, bwd_flops, "tf32", pairs)
    print(f"[vest-kernel] K6 work per layer: {pairs / 1e9:.3f} G (query, key) pairs, "
          f"{pairs / 1e9:.3f} G exponentials each way ({pairs / EXP_PER_S * 1e3:.4f} ms at "
          f"16 a clock an SM); products {fwd_flops / 1e9:.1f} GFLOP forward and "
          f"{bwd_flops / 1e9:.1f} backward ({fwd_flops / PEAK_FLOPS['tf32'] * 1e3:.4f} / "
          f"{bwd_flops / PEAK_FLOPS['tf32'] * 1e3:.4f} ms at the dense TF32 rate); bound "
          f"{fwd_b['bound_ms']:.4f} / {bwd_b['bound_ms']:.4f} ms by {fwd_b['bound_by']} / "
          f"{bwd_b['bound_by']}")

    def sdpa(a, b, c):
        return F.scaled_dot_product_attention(a.transpose(1, 2), b.transpose(1, 2),
                                              c.transpose(1, 2))

    records["flash_kv_fwd"] = timed("flash_kv_fwd", lambda: fk.flash_kv_fwd_kernel(q, k, v),
          lambda: fk.attention_kv_fwd_reference(q, k, v), err_f, fwd_b,
          library=lambda: sdpa(q, k, v), runs=10)
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    lib_out = sdpa(*leaves)
    g_heads = g.transpose(1, 2)
    records["flash_kv_bwd"] = timed("flash_kv_bwd",
                                    lambda: fk.flash_kv_bwd_kernel(q, k, v, o_p, lse_p, g),
          lambda: fk.attention_kv_bwd_reference(q, k, v, o_p, lse_p, g), err_b, bwd_b,
          library=lambda: torch.autograd.grad(lib_out, leaves, g_heads, retain_graph=True),
          runs=10)
    del q, k, v, g, o_p, lse_p, leaves, lib_out, g_heads
    torch.cuda.empty_cache()

    # K7 at [96, 8250]: every microphone of a B=16 batch in one launch, on three draws of
    # its inputs (k7_draws), each held at the same bars, and on delays smooth in time
    # (k7_smooth_inputs), as the delay predictor's clamped output gives them. Timed on the
    # phase's own draw (delays independent per sample: nearly every warp holds both forms)
    # and on the smooth one; the bound counts each form's float64 work in the built SASS.
    R = VEST_BATCH * VEST_MICS
    window = K7_WINDOW
    draws = k7_draws(gen)
    err7 = [k7_checks(sk, label, *inputs, window) for label, inputs in draws][0]
    smooth = k7_smooth_inputs()
    k7_checks(sk, "smooth delays", *smooth, window)
    rows_bytes = 4 * R * Tv
    for label, (x, g, d) in (("", draws[0][1]), (", smooth delays", smooth)):
        s_p = sk.sinc_fwd_reference(x, d, window)[1]
        for name, kernel, plain, err, nbytes in (
                ("sinc_delay_fwd", lambda: sk.sinc_fwd_kernel(x, d, window),
                 lambda: sk.sinc_fwd_reference(x, d, window), err7[0], 4 * rows_bytes),
                ("sinc_delay_grad_d", lambda: sk.sinc_grad_d_kernel(x, d, g, window),
                 lambda: sk.sinc_grad_d_reference(x, d, g, window), err7[1], 4 * rows_bytes),
                ("sinc_delay_grad_x", lambda: sk.sinc_grad_x_kernel(d, g, s_p, window),
                 lambda: sk.sinc_grad_x_reference(d, g, s_p, window), err7[2],
                 3 * rows_bytes + 4 * R * (Tv + 40))):
            b = k7_bound(name, nbytes, d)
            print(f"[vest-kernel] {name}{label}: far share {b['far_share']:.1%}; per tap of "
                  + "; ".join(f"{form} " + ", ".join(f"{v:.2f} {kind}" for kind, v in
                                                     b["per_tap"][form].items())
                              for form in ("near", "far"))
                  + " (the tap loop of the kernel built in that form, SASS)")
            rec = timed(name, kernel, plain, err, b, label=label)
            if label:
                records[name]["smooth_delays"] = rec
            else:
                records[name] = rec
    del draws, smooth, x, g, d, s_p

    # K3b at the vest encoder's T = 25 frames and K4 at its 400 rows, rate 0.1.
    seed, site, eps = 1618033988, 9, 1e-5
    for dtype in (torch.bfloat16, torch.float32):
        dt = "bf16" if dtype == torch.bfloat16 else "f32"
        tol = (3e-2, 2e-2) if dtype == torch.bfloat16 else (1e-4, 1e-4)
        qkv, dout = randn(B, 3 * H, VEST_FRAMES, D, dtype=dtype), randn(B, H, VEST_FRAMES, D,
                                                                        dtype=dtype)
        args = (VEST_FRAMES, RATE, seed, site)
        out_k, lse_k = attention.attention_qkv_fwd(qkv, *args, with_lse=True)
        out_p, lse_p = attention.attention_qkv_reference(qkv, *args, with_lse=True)
        agree(f"attention_qkv_fwd out {dt} T={VEST_FRAMES}", out_k, out_p, *tol)
        agree(f"attention_qkv_fwd lse {dt} T={VEST_FRAMES}", lse_k, lse_p, 1e-5, 1e-5)
        agree(f"attention_qkv_bwd dqkv {dt} T={VEST_FRAMES}",
              attention.attention_qkv_bwd(qkv, out_p, dout, lse_p, *args),
              attention.attention_qkv_bwd_reference(qkv, out_p, dout, lse_p, *args), *tol)
        rows = B * VEST_FRAMES
        x, gr = randn(rows, HIDDEN, dtype=dtype), randn(rows, HIDDEN, dtype=dtype)
        w1, b1 = randn(FFN, HIDDEN, dtype=dtype, std=HIDDEN ** -0.5), randn(FFN, dtype=dtype,
                                                                           std=0.1)
        w2, b2 = randn(HIDDEN, FFN, dtype=dtype, std=FFN ** -0.5), randn(HIDDEN, dtype=dtype,
                                                                        std=0.1)
        lw, lb = 1.0 + randn(HIDDEN, std=0.1), randn(HIDDEN, std=0.1)
        mk_args = (seed, 4, 5, RATE, RATE, eps)
        fwd_in = (x, w1, b1, w2, b2, lw, lb, *mk_args)
        for name, a, r in zip(("y", "s", "pre"), mk.ffn_mega_fwd_kernel(*fwd_in),
                              mk.ffn_mega_fwd_reference(*fwd_in)):
            agree(f"ffn_mega_fwd {name} {dt} [{rows}, {HIDDEN}]", a, r, *tol)
        _, s_p, pre_p = mk.ffn_mega_fwd_reference(*fwd_in)
        bwd_in = (gr, s_p, pre_p, w2, lw, *mk_args)
        colsum = (1e-1, 2e-2) if dtype == torch.bfloat16 else (1e-2, 1e-4)
        for i, (name, a, r) in enumerate(zip(("ds", "dhid", "dpre", "h", "db1", "db2",
                                              "dweight", "dbias"),
                                             mk.ffn_mega_bwd_kernel(*bwd_in),
                                             mk.ffn_mega_bwd_reference(*bwd_in))):
            agree(f"ffn_mega_bwd {name} {dt} [{rows}, {HIDDEN}]", a, r,
                  *(colsum if i >= 4 else tol))
    torch.cuda.empty_cache()
    return records


def attention_work(batch: int, dtype: torch.dtype) -> tuple[tuple, tuple]:
    """(bytes, operations) of the attention forward (q, k, v in; out and lse out) and of its
    backward (q, k, v, out, dout and lse in; dq, dk, dv out; the five score-shaped
    products) at the training shapes ``[batch, 12, 199, 64]``: the same for the packed (K3b)
    and the unpacked (K3a) routes."""
    size = torch.finfo(dtype).bits // 8
    qkv_bytes, out_bytes = batch * 3 * H * T * D * size, batch * H * T * D * size
    lse_bytes, flops = batch * H * T * 4, 4 * batch * H * T * T * D
    return ((qkv_bytes + out_bytes + lse_bytes, flops),
            (2 * qkv_bytes + 2 * out_bytes + lse_bytes, 2.5 * flops))


def phase_unpacked_attention() -> dict:
    """Phase 13: K3a at the training shapes ``[96, 12, 199, 64]``, q, k and v the head views
    of ``[B, T, H, d]`` projections (the model's layout), bfloat16 and float32, rate 0.1 and
    0, t = 199 and 150: its masks decoded bit for bit; its output, lse and gradients equal to
    K3b's on the packed tensor of the same q, k, v bit for bit (one kernel body); values and
    gradients against the plain version at K3b's bars; timed beside its bound and
    ``scaled_dot_product_attention`` (key mask, dropout) on the same views and its autograd
    backward. Returns the bfloat16 records."""
    import torch.nn.functional as F

    from wav2vec_heart_sounds_tpu_torch.ops import philox
    from wav2vec_heart_sounds_tpu_torch.ops.kernels import attention

    gen = torch.Generator(device="cuda").manual_seed(31)
    seed, site = 1414213562, 11
    for dtype in (torch.bfloat16, torch.float32):
        dt = "bf16" if dtype == torch.bfloat16 else "f32"
        fwd_mask, bwd_mask = attention_masks(seed, site, unpacked=True, dtype=dtype)
        want = philox.keep_mask(seed, site, fwd_mask.shape, RATE, "cuda")
        identical(f"attention_fwd (K3a) mask {dt} (decoded) vs plain", fwd_mask, want)
        identical(f"attention_bwd (K3a) mask {dt} (decoded from dv) vs plain", bwd_mask, want)
        del fwd_mask, bwd_mask, want

    records = {}
    for dtype in (torch.bfloat16, torch.float32):
        bf16 = dtype == torch.bfloat16
        dt = "bf16" if bf16 else "f32"
        elem = (1e-2, 1e-2) if bf16 else (1e-5, 1e-5)
        grad = (2e-2, 2e-2) if bf16 else (1e-4, 1e-4)
        proj = [torch.randn(TRAIN_BATCH, T, H, D, device="cuda", generator=gen).to(dtype)
                for _ in range(3)]
        q, k, v = (x.transpose(1, 2) for x in proj)                       # [B, H, T, d] views
        packed = torch.cat([q, k, v], dim=1).contiguous()
        dout = torch.randn(TRAIN_BATCH, H, T, D, device="cuda", generator=gen).to(dtype)
        for t in (T, 150):
            for rate in (RATE, 0.0):
                args = (t, rate, seed, site)
                tag = f"{dt} t={t} rate={rate}"
                out_a, lse_a = attention.attention_fwd(q, k, v, *args, with_lse=True)
                out_b, lse_b = attention.attention_qkv_fwd(packed, *args, with_lse=True)
                identical(f"attention_fwd (K3a) vs K3b out {tag}", out_a, out_b)
                identical(f"attention_fwd (K3a) vs K3b lse {tag}", lse_a, lse_b)
                grads = attention.attention_bwd(q, k, v, out_a, dout, lse_a, *args)
                identical(f"attention_bwd (K3a) vs K3b dq, dk, dv {tag}", torch.cat(grads, 1),
                          attention.attention_qkv_bwd(packed, out_b, dout, lse_b, *args))
                out_p, lse_p = attention.attention_reference(q, k, v, *args, with_lse=True)
                err_f = agree(f"attention_fwd out {tag}", out_a, out_p, *elem)
                agree(f"attention_fwd lse {tag}", lse_a, lse_p, 1e-5, 1e-5)
                ref = attention.attention_bwd_reference(q, k, v, out_p, dout, lse_p, *args)
                got = attention.attention_bwd(q, k, v, out_p, dout, lse_p, *args)
                err_b = max(agree(f"attention_bwd d{n} {tag}", a, r, *grad)
                            for n, a, r in zip("qkv", got, ref))
                if t == T and rate == RATE:
                    errs = (err_f, err_b)
        del out_a, out_b, lse_a, lse_b, grads, got, ref, packed
        args = (T, RATE, seed, site)
        keys = torch.ones(TRAIN_BATCH, 1, 1, T, dtype=torch.bool, device="cuda")
        fwd_b, bwd_b = (bound(*work, dtype) for work in attention_work(TRAIN_BATCH, dtype))
        leaves = [x.detach().requires_grad_() for x in (q, k, v)]
        lib_out = F.scaled_dot_product_attention(*leaves, attn_mask=keys, dropout_p=RATE)
        for name, kernel, plain, library, b, err in (
                ("attention_fwd", lambda: attention.attention_fwd(q, k, v, *args, with_lse=True),
                 lambda: attention.attention_reference(q, k, v, *args, with_lse=True),
                 lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=keys,
                                                        dropout_p=RATE), fwd_b, errs[0]),
                ("attention_bwd",
                 lambda: attention.attention_bwd(q, k, v, out_p, dout, lse_p, *args),
                 lambda: attention.attention_bwd_reference(q, k, v, out_p, dout, lse_p, *args),
                 lambda: torch.autograd.grad(lib_out, leaves, dout, retain_graph=True), bwd_b,
                 errs[1])):
            ms, plain_ms, lib_ms = cuda_ms(kernel), cuda_ms(plain), cuda_ms(library)
            print(f"[unpacked] {name} (K3a) {dt} [96, 12, 199, 64] views: kernel {ms:.4f} ms, "
                  f"plain {plain_ms:.4f} ms, library call (SDPA) {lib_ms:.4f} ms, bound "
                  f"{b['bound_ms']:.4f} ms by {b['bound_by']} (CUDA events, median of 20)")
            if bf16:
                records[name] = {"ms": ms, "plain_ms": plain_ms, "max_abs_err": err, **b,
                                 "library_ms": lib_ms}
        del proj, q, k, v, dout, out_p, lse_p, leaves, lib_out
        torch.cuda.empty_cache()
    for batch, frames in ((VEST_BATCH, VEST_FRAMES), (FUSION_BATCH, FUSION_FRAMES)):
        attention_routes(gen, batch, frames, seed, site)
    return records


def attention_routes(gen, batch: int, frames: int, seed: int, site: int, heads: int = H,
                     dim: int = D) -> None:
    """Both attention routes at the vest's (T = 25) or fusion's (T = 51) frames, or at another
    head count and head dim, bfloat16 and float32, rate 0.1 and 0, t = T and t < T: K3a on
    head views of ``[B, T, H, d]`` projections and K3b on the head view of the
    ``[B, T, 3H, d]`` projection of the same values equal bit for bit, the backward equal to
    a second run of itself, and both against the plain version at phase 5's bars."""
    from wav2vec_heart_sounds_tpu_torch.ops.kernels import attention

    H, D = heads, dim                   # noqa: N806  (the module's names, at other widths)
    for dtype in (torch.bfloat16, torch.float32):
        bf16 = dtype == torch.bfloat16
        elem, grad = ((1e-2, 1e-2), (2e-2, 2e-2)) if bf16 else ((1e-5, 1e-5), (1e-4, 1e-4))
        proj = torch.randn(batch, frames, 3 * H, D, device="cuda", generator=gen).to(dtype)
        packed = proj.transpose(1, 2)
        q, k, v = packed[:, :H], packed[:, H:2 * H], packed[:, 2 * H:]
        dout = torch.randn(batch, H, frames, D, device="cuda", generator=gen).to(dtype)
        for t in (frames, frames - 4):
            for rate in (RATE, 0.0):
                args = (t, rate, seed, site)
                tag = f"{str(dtype)[6:]} [{batch}, {H}, {frames}, {D}] t={t} rate={rate}"
                out_a, lse_a = attention.attention_fwd(q, k, v, *args, with_lse=True)
                out_b, lse_b = attention.attention_qkv_fwd(packed, *args, with_lse=True)
                identical(f"attention_fwd (K3a) vs K3b out {tag}", out_a, out_b)
                identical(f"attention_fwd (K3a) vs K3b lse {tag}", lse_a, lse_b)
                grads = torch.cat(attention.attention_bwd(q, k, v, out_b, dout, lse_b, *args), 1)
                dqkv = attention.attention_qkv_bwd(packed, out_b, dout, lse_b, *args)
                identical(f"attention_bwd (K3a) vs K3b dq, dk, dv {tag}", grads, dqkv)
                identical(f"attention_qkv_bwd dqkv {tag}, two runs", dqkv,
                          attention.attention_qkv_bwd(packed, out_b, dout, lse_b, *args))
                out_p, lse_p = attention.attention_qkv_reference(packed, *args, with_lse=True)
                agree(f"attention out {tag}", out_b, out_p, *elem)
                agree(f"attention lse {tag}", lse_b, lse_p, 1e-5, 1e-5)
                agree(f"attention dqkv {tag}", dqkv, attention.attention_qkv_bwd_reference(
                    packed, out_b, dout, lse_b, *args), *grad)
        del proj, packed, q, k, v, dout, out_a, out_b, grads, dqkv
    torch.cuda.empty_cache()


CONV_STAGES = ("conv_pack_kernel", "conv_fwd_wgmma_kernel", "conv_dpre_kernel",
               "conv_dx_wgmma_kernel", "conv_dw_wgmma_kernel", "conv_gelu_dw_reduce_kernel")


def conv_stage_times(x, w, pre, g, runs: int = 20) -> dict:
    """K8's bfloat16 stages, each launched alone, CUDA events (median of ``runs``): the pack,
    the forward GEMM, the dpre pass, and dx and dW (with their reduce) each as the backward
    with only that gradient less the dpre pass; then each stage kernel's device time in one
    whole forward + backward (``torch.profiler`` over 5 of each, each kernel's time over the
    launches the profile recorded)."""
    from wav2vec_heart_sounds_tpu_torch.ops.kernels import conv

    frames = conv._pack(x)
    wr = conv.relay_weight(w)
    out, pre_k = torch.empty_like(pre), torch.empty_like(pre)
    times = {"pack": cuda_ms(lambda: conv._pack(x), runs),
             "GEMM": cuda_ms(lambda: conv._fwd_frames(frames, wr, out, pre_k), runs),
             "dpre": cuda_ms(lambda: conv._dpre_frames(pre, g), runs)}
    for name, need in (("dx", (True, False)), ("dW + reduce", (False, True))):
        times[name] = cuda_ms(lambda: conv.conv_gelu_bwd_kernel(frames, w, pre, g, *need),
                              runs) - times["dpre"]
    cuda = torch.autograd.DeviceType.CUDA
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            conv.conv_gelu_fwd_kernel(x, w)
            conv.conv_gelu_bwd_kernel(frames, w, pre, g)
        torch.cuda.synchronize()
    device = {e.key: e.self_device_time_total / 1e3 / e.count for e in prof.key_averages()
              if e.device_type == cuda}
    for stage in CONV_STAGES:
        ms = next((v for k, v in device.items() if stage in k), None)
        times[f"{stage} (profiler)"] = ms
    return times


def phase_conv_kernel() -> dict:
    """Phase 14: K8 against its plain version at conv_1's shapes (``[96, 512, 12799]`` ->
    6399 frames and ``[96, 512, 12800]`` -> 6399 in bfloat16, a ragged
    ``[3, 256, 301]`` -> 128 channels too; float32 at B = 8, where the plain float32 conv is
    the comparison's cost): out and pre, then dx and dW from the plain ``pre`` and a random
    cotangent; bfloat16 within one ulp (1e-2), dW, a sum over 614304 rows, relative to its
    largest value. In bfloat16 the pack pass (the frame view) and the padded channels-last
    dpre equal their plain versions bit for bit. Timed beside its bound and cuDNN's
    ``conv1d`` followed by ``gelu`` (two calls; their autograd backward for the backward),
    each bfloat16 stage alone beside it. Returns the bfloat16 records at T = 12799."""
    import torch.nn.functional as F

    from wav2vec_heart_sounds_tpu_torch.ops.kernels import conv

    gen = torch.Generator(device="cuda").manual_seed(41)
    records = {}
    cases = ((torch.bfloat16, TRAIN_BATCH, CONV_C, CONV_C, CONV_T),
             (torch.bfloat16, TRAIN_BATCH, CONV_C, CONV_C, CONV_T + 1),
             (torch.bfloat16, 3, 256, 128, 301), (torch.float32, 8, CONV_C, CONV_C, CONV_T))
    for dtype, B, cin, cout, T in cases:
        bf16 = dtype == torch.bfloat16
        dt = "bf16" if bf16 else "f32"
        tol = (1e-2, 1e-2) if bf16 else (2e-5, 1e-5)
        grad = (1e-2, 1e-2) if bf16 else (1e-4, 1e-4)
        x = torch.randn(B, cin, T, device="cuda", generator=gen).to(dtype)
        w = (torch.randn(cout, cin, 3, device="cuda", generator=gen) / (3 * cin) ** 0.5).to(dtype)
        shape = f"[{B}, {cin}, {T}] -> {cout}"
        out_k, pre_k, frames = conv.conv_gelu_fwd_kernel(x, w, keep_frames=True)
        out_p, pre_p = conv.conv_gelu_fwd_reference(x, w)
        err_f = max(agree(f"conv_gelu_fwd out {dt} {shape}", out_k, out_p, *tol),
                    agree(f"conv_gelu_fwd pre {dt} {shape}", pre_k, pre_p, *tol))
        del out_k, pre_k
        g = torch.randn(out_p.shape, device="cuda", generator=gen).to(dtype)
        if bf16:
            identical(f"conv_gelu pack (frame view) {shape}", frames.xf,
                      conv.pack_frames_reference(x))
            identical(f"conv_gelu dpre (padded, channels last) {shape}",
                      conv._dpre_frames(pre_p, g), conv.dpre_frames_reference(pre_p, g))
        dx_k, dw_k = conv.conv_gelu_bwd_kernel(frames if bf16 else x, w, pre_p, g)
        dx_p, dw_p = conv.conv_gelu_bwd_reference(x, w, pre_p, g)
        top = dw_p.float().abs().max().item()
        err_b = max(agree(f"conv_gelu_bwd dx {dt} {shape}", dx_k, dx_p, *grad),
                    agree(f"conv_gelu_bwd dw {dt} (atol {grad[0]:g} of max |dw| {top:.3e})",
                          dw_k, dw_p, grad[0] * top, grad[1]))
        del dx_k, dw_k, dx_p, dw_p
        if B < 8 or (bf16 and T != CONV_T):
            del x, w, out_p, pre_p, g, frames
            continue
        saved = frames if bf16 else x           # what the training step's backward reads
        size = torch.finfo(dtype).bits // 8
        frames_n = B * conv.out_length(T)
        x_bytes, w_bytes, out_bytes = x.numel() * size, w.numel() * size, frames_n * cout * size
        flops = 2 * frames_n * cout * 3 * cin
        fwd_b = {**bound(x_bytes + w_bytes + 2 * out_bytes, flops, dtype), "flops": flops}
        bwd_b = {**bound(2 * x_bytes + 2 * w_bytes + 2 * out_bytes, 2 * flops, dtype),
                 "flops": 2 * flops}
        leaves = [x.detach().requires_grad_(), w.detach().requires_grad_()]
        lib_out = F.gelu(F.conv1d(*leaves, stride=2))
        for name, kernel, plain, library, b, err in (
                ("conv_gelu_fwd", lambda: conv.conv_gelu_fwd_kernel(x, w),
                 lambda: conv.conv_gelu_fwd_reference(x, w),
                 lambda: F.gelu(F.conv1d(x, w, stride=2)), fwd_b, err_f),
                ("conv_gelu_bwd", lambda: conv.conv_gelu_bwd_kernel(saved, w, pre_p, g),
                 lambda: conv.conv_gelu_bwd_reference(x, w, pre_p, g),
                 lambda: torch.autograd.grad(lib_out, leaves, g, retain_graph=True), bwd_b,
                 err_b)):
            ms, plain_ms, lib_ms = cuda_ms(kernel), cuda_ms(plain), cuda_ms(library)
            rate = b["flops"] / ms / 1e9
            print(f"[conv] {name} (K8) {dt} {shape}: kernel {ms:.4f} ms ({rate:.1f} TFLOP/s), "
                  f"plain {plain_ms:.4f} ms, library (cuDNN conv1d + gelu, two calls) "
                  f"{lib_ms:.4f} ms, bound {b['bound_ms']:.4f} ms by {b['bound_by']} (CUDA "
                  f"events, median of 20)")
            b = {k: v for k, v in b.items() if k != "flops"}
            if bf16:
                records[name] = {"ms": ms, "plain_ms": plain_ms, "max_abs_err": err, **b,
                                 "library_ms": lib_ms}
        if bf16:
            stage_bounds = {"pack": bound(2 * x_bytes, 0, dtype),
                            "GEMM": bound(x_bytes + w_bytes + 2 * out_bytes, flops, dtype),
                            "dpre": bound(3 * out_bytes, 0, dtype),
                            "dx": bound(out_bytes + w_bytes + x_bytes, flops, dtype),
                            "dW + reduce": bound(out_bytes + x_bytes + w_bytes, flops, dtype)}
            times = conv_stage_times(x, w, pre_p, g)
            for stage, ms in times.items():
                b = stage_bounds.get(stage)
                extra = f", bound {b['bound_ms']:.4f} ms by {b['bound_by']}" if b else ""
                text = "not found" if ms is None else f"{ms:.4f} ms"
                print(f"[conv] K8 bf16 {shape} stage {stage}: {text}{extra}")
        del x, w, out_p, pre_p, g, leaves, lib_out, frames, saved
        torch.cuda.empty_cache()
    return records


# The positional convolution (csrc/pos_conv.cu) at the shapes the paths run it:
# (label, B, T, D, groups, kernel).
POS_CONV_SHAPES = (("base", TRAIN_BATCH, T, HIDDEN, 16, 128),
                   ("large", TRAIN_BATCH, T, 1024, 16, 128),
                   ("fusion", FUSION_BATCH, FUSION_FRAMES, HIDDEN, 16, 128),
                   ("vest", VEST_BATCH, VEST_FRAMES, HIDDEN, 16, 128),
                   ("tiny", 4, 37, 32, 2, 16))


def phase_pos_conv() -> dict:
    """Phase 25: the positional convolution's kernels against the plain version
    (``pos_conv_gelu_plain``, float32 from the same bfloat16 tensors, TF32 off) at
    ``POS_CONV_SHAPES``. Tolerances: out and pre one bfloat16 rounding of the float32 value
    (rtol 2^-7, one ulp, as the two sums round in different orders) with atol 1e-3 of the
    largest value for near-cancelling sums; dx, dW and db within 1e-2 of their largest value:
    the kernels take the GELU's gradient at the rounded pre and round dpre to bfloat16 (each
    term off by up to 2^-9, errors that partly cancel over 6144 to 2.4M terms), which the
    float32 plain version does not. A second backward equals the first bit for bit (dW and db
    through partials summed in a fixed order). Each wrapper launches once a call and
    ``posconv.launches`` counts one a call under a profiler; cuDNN's flags read as before.
    Timed by device time beside the bound and, on the same tensors, the plain version in
    bfloat16 on cuDNN's default algorithms and on its deterministic ones (forward, and its
    autograd backward). Returns the base shape's records by kernel name (the kernels line)."""
    from wav2vec_heart_sounds_tpu_torch.ops.kernels import pos_conv as pc
    from wav2vec_heart_sounds_tpu_torch.utils import observe

    flags = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    gen = torch.Generator(device="cuda").manual_seed(43)
    records, kernels = {}, {}
    for label, B, frames, d, groups, k in POS_CONV_SHAPES:
        c = d // groups
        shape = f"{label} [{B}, {frames}, {d}] / {groups} groups, k {k}"
        x = torch.randn(B, frames, d, device="cuda", generator=gen).bfloat16()
        w = (torch.randn(d, c, k, device="cuda", generator=gen) / (c * k) ** 0.5).bfloat16()
        b = (0.1 * torch.randn(d, device="cuda", generator=gen)).bfloat16()
        g = torch.randn(B, frames, d, device="cuda", generator=gen).bfloat16()
        out_k, pre_k = pc.pos_conv_fwd_kernel(x, w, b, groups)
        dx_k, dw_k, db_k = pc.pos_conv_bwd_kernel(x, w, pre_k, g, groups)
        again = pc.pos_conv_bwd_kernel(x, w, pre_k, g, groups)
        for name, first, second in zip(("dx", "dW", "db"), (dx_k, dw_k, db_k), again):
            identical(f"pos_conv_bwd {name} twice, {shape}", second, first)
        del again
        leaves = [v.float().requires_grad_() for v in (x, w, b)]
        h = pc.pos_conv_gelu_plain(*leaves, groups)
        pre_p = pos_conv_pre_plain(*(v.detach() for v in leaves), groups)
        grads = torch.autograd.grad(h, leaves, g.float())
        err = {}
        for name, got, ref in (("out", out_k, h.detach()), ("pre", pre_k, pre_p)):
            top = ref.abs().max().item()
            err[name] = agree(f"pos_conv_fwd {name} {shape}", got, ref, 1e-3 * top, 2 ** -7)
        for name, got, ref in zip(("dx", "dW", "db"), (dx_k, dw_k, db_k), grads):
            top = ref.abs().max().item()
            err[name] = agree(f"pos_conv_bwd {name} {shape} (atol 1e-2 of max {top:.3e})",
                              got, ref, 1e-2 * top, 0.0)
        del h, pre_p, grads, leaves, dx_k, dw_k, db_k
        calls = (pc.pos_conv_fwd_kernel.launches, pc.pos_conv_bwd_kernel.launches)
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            start = observe.clock()
            leaves = [v.detach().requires_grad_() for v in (x, w, b)]
            pc.pos_conv_gelu(*leaves, groups).backward(g)
            counted = observe.counters(start, observe.clock()).get("posconv.launches")
        launched = (pc.pos_conv_fwd_kernel.launches - calls[0],
                    pc.pos_conv_bwd_kernel.launches - calls[1])
        check(launched == (1, 1) and counted == 2,
              f"pos_conv {shape}: launches {launched}, posconv.launches {counted}; "
              "expected (1, 1) and 2")
        print(f"[pos_conv] {shape}: launches fwd+bwd 1+1, posconv.launches 2")
        flops = 2 * B * frames * d * c * k
        act = B * frames * d * 2
        fwd_b = bound(2 * act + act + w.numel() * 2, flops, torch.bfloat16)
        bwd_b = bound(4 * act + 2 * w.numel() * 2, 2 * flops, torch.bfloat16)
        lib_leaves = [v.detach().requires_grad_() for v in (x, w, b)]
        lib_out = pc.pos_conv_gelu_plain(*lib_leaves, groups)
        heavy = label in ("base", "fusion", "vest")      # cuDNN's default dgrad engine: slow
        lib_runs = dict(runs=2, batches=1) if heavy else {}
        times = {
            "fwd": device_ms(lambda: pc.pos_conv_fwd_kernel(x, w, b, groups)),
            "bwd": device_ms(lambda: pc.pos_conv_bwd_kernel(x, w, pre_k, g, groups)),
            "library_fwd": device_ms(lambda: pc.pos_conv_gelu_plain(x, w, b, groups)),
            "library_bwd": device_ms(lambda: torch.autograd.grad(lib_out, lib_leaves, g,
                                                                 retain_graph=True),
                                     **lib_runs)}
        with deterministic_cudnn():
            det_out = pc.pos_conv_gelu_plain(*lib_leaves, groups)
            times["deterministic_fwd"] = device_ms(
                lambda: pc.pos_conv_gelu_plain(x, w, b, groups))
            times["deterministic_bwd"] = device_ms(
                lambda: torch.autograd.grad(det_out, lib_leaves, g, retain_graph=True))
        for part, b_ in (("fwd", fwd_b), ("bwd", bwd_b)):
            rate = (flops if part == "fwd" else 2 * flops) / times[part] / 1e9
            print(f"[pos_conv] {part} {shape}: kernel {times[part]:.4f} ms ({rate:.1f} TFLOP/s), "
                  f"bound {b_['bound_ms']:.4f} ms by {b_['bound_by']}, cuDNN default "
                  f"{times['library_' + part]:.4f} ms, cuDNN deterministic "
                  f"{times['deterministic_' + part]:.4f} ms (device time)")
        records[label] = {**{k_: round(v, 4) for k_, v in times.items()},
                          "bound_fwd_ms": fwd_b["bound_ms"], "bound_bwd_ms": bwd_b["bound_ms"],
                          "max_err": err}
        if label == "base":                        # the main path's shape, for the kernels line
            for part, b_, names in (("fwd", fwd_b, ("out", "pre")),
                                    ("bwd", bwd_b, ("dx", "dW", "db"))):
                kernels["pos_conv_" + part] = {
                    "ms": times[part], "max_abs_err": max(err[n] for n in names), **b_,
                    "library_ms": times["library_" + part],
                    "deterministic_ms": times["deterministic_" + part]}
        del x, w, b, g, out_k, pre_k, lib_out, lib_leaves, det_out
        torch.cuda.empty_cache()
    check((torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark) == flags,
          "pos_conv: cuDNN's flags changed")
    print(json.dumps({"pos_conv": {"source": CSRC + "pos_conv.cu", "replaces": None,
                                   "shapes": records}}))
    return kernels


def pos_conv_pre_plain(x, w, b, groups):
    """The plain version's pre-activation: the conv plus bias, an even kernel's trailing
    frame dropped, on ``[B, T, D]``."""
    import torch.nn.functional as F

    k = w.shape[-1]
    return F.conv1d(x.transpose(1, 2), w, b, padding=k // 2,
                    groups=groups)[..., :x.shape[1]].transpose(1, 2)


# Kernel launches of one training step of wav2vec2-base (12 layers): (forward, backward), on
# the default FFN route (K4) and on the decomposed control (``ffn_mega=False``: K5 + K2). The
# positional conv's kernels run once a step in bfloat16 (the main path); a float32 step
# keeps nn.Conv1d's call (``float32_step``).
PER_STEP = {"dropout": (2, 2), "resid_fwd": (12, 0), "resid_bwd": (0, 12),
            "attention_qkv_fwd": (12, 0), "attention_qkv_bwd": (0, 12),
            "attention_fwd": (0, 0), "attention_bwd": (0, 0),
            "conv_gelu_fwd": (0, 0), "conv_gelu_bwd": (0, 0),
            "ffn_mega_fwd": (12, 0), "ffn_mega_bwd": (0, 12),
            "ffn_act_fwd": (0, 0), "ffn_act_bwd": (0, 0),
            "flash_kv_fwd": (0, 0), "flash_kv_bwd": (0, 0), "sinc_delay_fwd": (0, 0),
            "sinc_delay_grad_d": (0, 0), "sinc_delay_grad_x": (0, 0),
            "pos_conv_fwd": (1, 0), "pos_conv_bwd": (0, 1)}
PER_STEP_SPLIT = {**PER_STEP, "resid_fwd": (24, 0), "resid_bwd": (0, 24),
                  "ffn_mega_fwd": (0, 0), "ffn_mega_bwd": (0, 0),
                  "ffn_act_fwd": (12, 0), "ffn_act_bwd": (0, 12)}
# The opt-in route (qkv_fuse=False, conv_fuse=True; K4 on): the unpacked attention K3a in
# every layer instead of K3b, and K8 on conv_1 (the only layer JAX's gate picks at 64000
# samples).
PER_STEP_GATED = {**PER_STEP, "attention_qkv_fwd": (0, 0), "attention_qkv_bwd": (0, 0),
                  "attention_fwd": (12, 0), "attention_bwd": (0, 12),
                  "conv_gelu_fwd": (1, 0), "conv_gelu_bwd": (0, 1)}
# The fusion step: two branches of the default route (4 s at 4125 Hz: T' = 51, so no K8),
# the positional conv once a branch.
PER_STEP_FUSION = {k: (2 * f, 2 * b) for k, (f, b) in PER_STEP.items()}
# The vest step (6 microphones, LoRA on q/v): K1 runs at the feature projection, the
# encoder input and the 24 LoRA bypasses (two per layer); K6 once per delay-predictor layer
# (its backward wrapper launches the delta pre-pass, the fused pass and the dq reduce); K7
# once for all microphones.
# K7's input gradient runs only when the waveform itself needs a gradient, never in
# training (the data needs none; the JAX package's XLA drops that pallas_call too):
# phase 9 asks for it, and so its launches come from there.
PER_STEP_VEST = {**PER_STEP, "dropout": (26, 26), "flash_kv_fwd": (2, 0),
                 "flash_kv_bwd": (0, 2), "sinc_delay_fwd": (1, 0), "sinc_delay_grad_d": (0, 1)}
PER_STEP_VEST_INPUT_GRAD = {**PER_STEP_VEST, "sinc_delay_grad_x": (0, 1)}
# Kernels that an eval forward launches (per batch): wav2vec2-base's attention and the
# positional conv's forward, and on the vest the delay predictor's attention and the sinc
# delay.
EVAL_PER_BATCH = {"attention_qkv_fwd": 12, "pos_conv_fwd": 1}
EVAL_PER_BATCH_VEST = {**EVAL_PER_BATCH, "flash_kv_fwd": 2, "sinc_delay_fwd": 1}
EVAL_PER_BATCH_GATED = {"attention_fwd": 12, "conv_gelu_fwd": 1, "pos_conv_fwd": 1}
EVAL_PER_BATCH_FUSION = {"attention_qkv_fwd": 24, "pos_conv_fwd": 2}


def float32_step(per_step: dict) -> dict:
    """``per_step`` for a float32 model: the positional conv keeps nn.Conv1d's call there, so
    its kernels do not launch."""
    return {**per_step, "pos_conv_fwd": (0, 0), "pos_conv_bwd": (0, 0)}


def per_step_text(per_step: dict) -> str:
    return ", ".join(f"{k} {f}+{b}" for k, (f, b) in per_step.items())


def classifier_config(ffn_mega: bool = True, **routes):
    """wav2vec2-base at full width and depth, the 512x3 head, random weights; ``routes``
    sets ``qkv_fuse`` / ``conv_fuse``."""
    from wav2vec_heart_sounds_tpu_torch.models.classifier import ClassifierConfig
    from wav2vec_heart_sounds_tpu_torch.models.wav2vec2 import Wav2Vec2Config

    return ClassifierConfig(num_classes=2, head_hidden=(512, 512, 512), fs=FS, random_init=True,
                            encoder=Wav2Vec2Config(ffn_mega=ffn_mega, **routes))


def train_step(model, x, y, per_step: dict | None, step_seed: int = 5):
    """One training step from a fixed generator (``step_seed``): (loss, gradient norm by
    trained parameter, and ``"input"`` when ``x`` needs a gradient). With ``per_step``, each
    kernel must launch exactly that often; without, none may launch."""
    from wav2vec_heart_sounds_tpu_torch.train.losses import cross_entropy

    model.zero_grad(set_to_none=True)
    x.grad = None
    reset_counts()
    loss = cross_entropy(model(x, train=True, generator=torch.Generator().manual_seed(step_seed)),
                         y)
    fwd = counts()
    loss.backward()
    torch.cuda.synchronize()
    bwd = {k: v - fwd[k] for k, v in counts().items()}
    if per_step is None:
        check(not any(fwd.values()) and not any(bwd.values()), "plain route launched a kernel")
    else:
        for name, (f, b) in per_step.items():
            check(fwd[name] == f and bwd[name] == b,
                  f"{name}: {fwd[name]} + {bwd[name]} launches, expected {f} + {b}")
    norms = {n: p.grad.norm().item() for n, p in model.named_parameters() if p.requires_grad}
    if x.requires_grad:
        norms["input"] = x.grad.norm().item()
    return loss.detach().item(), norms


def worst_norm_gap(norms: dict, ref: dict, floor: float = 1e-6) -> float:
    top = max(ref.values())
    return max(abs(norms[n] - ref[n]) / (ref[n] + floor * top) for n in ref)


STEP_SEEDS = (5, 6, 7, 8)      # generator seeds of phase 6's steps (masks, SpecAugment spans)


def phase_train_step() -> None:
    """Phase 6: one full-width training step (B=8, dropout and SpecAugment on). float32:
    the kernels (K4 on) against all-plain versions. bfloat16: the K4 route against the
    decomposed K5 route, from the same state and step seeds (identical masks), each route's
    distance to the float32 step averaged over four step seeds."""
    from wav2vec_heart_sounds_tpu_torch.models.build import build_classifier

    B = 8
    gen = torch.Generator(device="cuda").manual_seed(3)
    x = 0.3 * torch.randn(B, int(WINDOW_S * FS), device="cuda", generator=gen)
    y = torch.arange(B, device="cuda") % 2

    model = build_classifier(classifier_config(), seed=0, device="cuda", dtype=torch.float32,
                             train=True)
    loss_k, norms_k = train_step(model, x, y, float32_step(PER_STEP))
    with plain_route():
        loss_p, norms_p = train_step(model, x, y, None)
    worst = worst_norm_gap(norms_k, norms_p)
    print(f"[train-step] wav2vec2-base f32 B={B}, dropout {RATE} and SpecAugment on: loss "
          f"kernels {loss_k:.7f} vs plain {loss_p:.7f}; {len(norms_p)} gradient norms, worst "
          f"relative difference {worst:.3e} (limit 1e-3); launches fwd+bwd "
          + per_step_text(float32_step(PER_STEP)))
    check(abs(loss_k - loss_p) <= 1e-4 * max(1.0, abs(loss_p)), "training-step losses differ")
    check(worst <= 1e-3, f"gradient norms differ between kernel and plain routes: {worst}")
    check(all(np.isfinite(v) and v > 0 for v in norms_k.values()), "a gradient is 0 or not finite")
    # the float32 reference of the bf16 A/B below, at each of its step seeds
    ref_steps = [(loss_k, norms_k)] + [train_step(model, x, y, float32_step(PER_STEP), s)
                                       for s in STEP_SEEDS[1:]]
    del model

    # bf16 A/B. Both routes draw the same masks and differ only where bf16 rounds (K4's own
    # products against cuBLAS's: pre, y2 and dh may differ by one ulp, 2^-8 relative). One
    # bf16 step's gradient norms are themselves far from float32: measured on the H100 at
    # B=8, each route's norms stray up to ~8-11% from the f32 step's (the worst are the key
    # biases, whose true gradient is 0, and the first layers), and the K5 route's kernels vs
    # its own plain versions differ by up to 29%. Which route strays further in one step
    # depends on the rounding of everything both share: with the same K4 and K5 kernels, the
    # largest per-parameter excess read 8.9e-2, 7.3e-2 and 2.0e-2 under three attention
    # implementations (PERF.md). So the distances are averaged over four step seeds
    # (other dropout masks and SpecAugment spans, the same state and batch). The check: the
    # loss within 1e-2 relative at every seed, and for every parameter, K4's mean distance to
    # the f32 norm may exceed K5's by at most 5e-2 of the mean f32 norm (floored at 1e-4 of
    # the largest).
    results = {}
    for mega, per_step in ((True, PER_STEP), (False, PER_STEP_SPLIT)):
        model = build_classifier(classifier_config(mega), seed=0, device="cuda",
                                 dtype=torch.bfloat16, train=True)
        results[mega] = [train_step(model, x, y, per_step, s) for s in STEP_SEEDS]
        del model

    def mean_distance(steps):
        return {n: float(np.mean([abs(st[1][n] - ref[1][n]) for st, ref in zip(steps, ref_steps)]))
                for n in norms_k}

    ref_mean = {n: float(np.mean([ref[1][n] for ref in ref_steps])) for n in norms_k}
    top = max(ref_mean.values())
    dist_4, dist_5 = mean_distance(results[True]), mean_distance(results[False])
    excess = max((dist_4[n] - dist_5[n]) / (ref_mean[n] + 1e-4 * top) for n in norms_k)
    rel = max(abs(a[0] - b[0]) / max(1.0, abs(b[0])) for a, b in zip(results[True], results[False]))
    (loss_4, norms_4), (loss_5, norms_5) = results[True][0], results[False][0]
    one_seed = max((abs(norms_4[n] - norms_k[n]) - abs(norms_5[n] - norms_k[n]))
                   / (norms_k[n] + 1e-4 * max(norms_k.values())) for n in norms_k)

    def global_error(norms):
        total = sum(v * v for v in norms.values()) ** 0.5
        ref = sum(v * v for v in norms_k.values()) ** 0.5
        return abs(total - ref) / ref

    print(f"[train-step] wav2vec2-base bf16 B={B}, K4 route vs K5 route (same state, seed and "
          f"masks): loss {loss_4:.6f} vs {loss_5:.6f} (largest relative difference over "
          f"{len(STEP_SEEDS)} step seeds {rel:.3e}, limit 1e-2; f32 {loss_k:.6f}); at step "
          f"seed {STEP_SEEDS[0]}, against the f32 step's gradient norms (floor 1e-4 of the "
          f"largest), K4 worst {worst_norm_gap(norms_4, norms_k, 1e-4):.3e} and global "
          f"{global_error(norms_4):.3e}, K5 worst {worst_norm_gap(norms_5, norms_k, 1e-4):.3e} "
          f"and global {global_error(norms_5):.3e}, K4's largest excess over K5 {one_seed:.3e}; "
          f"K4's largest excess over K5 in the mean distance over the seeds {excess:.3e} of "
          f"the mean f32 norm (limit 5e-2); K4 vs K5 directly, worst "
          f"{worst_norm_gap(norms_4, norms_5, 1e-4):.3e}")
    check(rel <= 1e-2, "bf16 K4 and K5 routes: losses differ")
    check(excess <= 5e-2, f"bf16 K4 route's gradient norms stray further from f32 than K5's: "
                          f"{excess}")
    check(all(np.isfinite(v) for v in norms_4.values()), "a bf16 K4 gradient is not finite")


# Wav2Vec2Config.tiny() (hidden 32, head dim 16, FFN 64) on the card: every kernel of the
# encoder takes these widths. Per route, the launches of one training step (forward,
# backward): K1 at the feature projection and the encoder input; K2 ends the attention
# sublayer of both layers (and on the decomposed route the FFN sublayer too), K3b and K4 (or
# K5) once a layer.
TINY_ROUTES = (
    ("K4 route", True, {"dropout": (2, 2), "resid_fwd": (2, 0), "resid_bwd": (0, 2),
                        "attention_qkv_fwd": (2, 0), "attention_qkv_bwd": (0, 2),
                        "ffn_mega_fwd": (2, 0), "ffn_mega_bwd": (0, 2)}),
    ("K5 route", False, {"dropout": (2, 2), "resid_fwd": (4, 0), "resid_bwd": (0, 4),
                         "attention_qkv_fwd": (2, 0), "attention_qkv_bwd": (0, 2),
                         "ffn_act_fwd": (2, 0), "ffn_act_bwd": (0, 2)}))
TINY_EVAL = {"attention_qkv_fwd": 2}       # an eval forward: K3b once a layer


def phase_tiny() -> None:
    """Phase 17: the kernels at the widths of other configs against their plain versions
    (K2 at ``K2_WIDTHS`` runs in phase 5): K3a and K3b at the test config's head dim 16 (its
    2 heads and 399 frames), and at head dims 32 and 128; K4 at ``K4_WIDTHS``. Then
    ``Wav2Vec2Config.tiny()`` on the card, float32, dropout and SpecAugment on, B=2 windows
    of 1 s at 4 kHz, on both FFN routes: one eval forward and one training step, each against
    the same on the CPU from the same state dict and step seed (logits at 1e-5 absolute and
    1e-4 relative; the loss at 1e-4 relative, each gradient norm at 1e-3 relative, the key
    biases, whose true gradient is 0, held below 1e-5 of the largest norm), with the exact
    launches of every kernel."""
    from wav2vec_heart_sounds_tpu_torch.models.build import build_classifier
    from wav2vec_heart_sounds_tpu_torch.models.classifier import ClassifierConfig
    from wav2vec_heart_sounds_tpu_torch.models.wav2vec2 import Wav2Vec2Config

    gen = torch.Generator(device="cuda").manual_seed(17)
    for batch, heads, frames, dim in ((2, 2, 399, 16), (4, 4, 199, 32), (4, 4, 199, 128)):
        attention_routes(gen, batch, frames, 2718281828, 9, heads=heads, dim=dim)
    k4_widths()

    B, fs = 2, 4000
    gen = torch.Generator().manual_seed(17)
    x = 0.3 * torch.randn(B, fs, generator=gen)
    y = torch.arange(B) % 2
    for route, mega, launches in TINY_ROUTES:
        per_step = {**dict.fromkeys(kernel_wrappers(), (0, 0)), **launches}
        cfg = ClassifierConfig(num_classes=2, head_hidden=(16,), fs=fs, random_init=True,
                               encoder=Wav2Vec2Config.tiny(ffn_mega=mega))
        card = build_classifier(cfg, seed=0, device="cuda", dtype=torch.float32, train=True)
        cpu = build_classifier(cfg, seed=1, device="cpu", dtype=torch.float32, train=True)
        cpu.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()}, strict=True)
        reset_counts()
        with torch.no_grad():
            logits = card(x.cuda()).cpu()
            want = cpu(x)
        eval_launches = {n: v for n, v in counts().items() if v}
        check(eval_launches == TINY_EVAL, f"tiny eval forward's launches: {eval_launches}")
        err = (logits - want).abs().max().item()
        check(torch.allclose(logits, want, atol=1e-5, rtol=1e-4),
              f"tiny eval logits, card vs CPU: {err}")
        loss_k, norms_k = train_step(card, x.cuda(), y.cuda(), per_step)
        loss_c, norms_c = train_step(cpu, x, y, None)
        noise = [n for n in norms_c if n.endswith("k_proj.bias")]
        top = max(norms_c.values())
        check(all(max(norms_k[n], norms_c[n]) < 1e-5 * top for n in noise),
              f"tiny key-bias gradients are not ~0: {[(norms_k[n], norms_c[n]) for n in noise]}")
        worst = worst_norm_gap({n: v for n, v in norms_k.items() if n not in noise},
                               {n: v for n, v in norms_c.items() if n not in noise})
        print(f"[tiny] Wav2Vec2Config.tiny() f32 B={B}, {route}: eval logits card vs CPU "
              f"max_abs_err={err:.3e} (atol 1e-5, rtol 1e-4), eval launches "
              f"{json.dumps(eval_launches)}; training step (dropout 0.1, SpecAugment on): loss "
              f"card {loss_k:.7f} vs CPU {loss_c:.7f}; {len(norms_c)} gradient norms, worst "
              f"relative difference {worst:.3e} (limit 1e-3) outside the {len(noise)} key "
              f"biases (at most {max(max(norms_k[n], norms_c[n]) for n in noise) / top:.1e} of "
              f"the largest, limit 1e-5); kernel launches fwd+bwd {per_step_text(launches)}")
        check(abs(loss_k - loss_c) <= 1e-4 * max(1.0, abs(loss_c)), "tiny step losses differ")
        check(worst <= 1e-3, f"tiny gradient norms differ between card and CPU: {worst}")
        check(all(np.isfinite(v) for v in norms_k.values()), "a tiny gradient is not finite")
        del card, cpu


def phase_gated_step() -> None:
    """Phase 15: one full-width float32 training step on the opt-in route (``qkv_fuse=False``,
    ``conv_fuse=True``: K3a in every layer, K8 on conv_1; B=2, 64000-sample windows, dropout
    and SpecAugment on), the kernels against all-plain versions from one state and one seed:
    the loss within 1e-4 relative, every gradient norm within 1e-3 relative, and the exact
    launches (K3a 12+12, K8 1+1, K3b none)."""
    from wav2vec_heart_sounds_tpu_torch.models.build import build_classifier

    B = 2
    gen = torch.Generator(device="cuda").manual_seed(13)
    x = 0.3 * torch.randn(B, int(WINDOW_S * FS), device="cuda", generator=gen)
    y = torch.arange(B, device="cuda") % 2
    model = build_classifier(classifier_config(qkv_fuse=False, conv_fuse=True), seed=0,
                             device="cuda", dtype=torch.float32, train=True)
    loss_k, norms_k = train_step(model, x, y, float32_step(PER_STEP_GATED))
    with plain_route():
        loss_p, norms_p = train_step(model, x, y, None)
    worst = worst_norm_gap(norms_k, norms_p)
    print(f"[gated-step] wav2vec2-base f32 B={B}, qkv_fuse=False, conv_fuse=True, dropout "
          f"{RATE} and SpecAugment on: loss kernels {loss_k:.7f} vs plain {loss_p:.7f}; "
          f"{len(norms_p)} gradient norms, worst relative difference {worst:.3e} (limit 1e-3); "
          f"launches fwd+bwd " + per_step_text({k: v for k, v in
                                                float32_step(PER_STEP_GATED).items() if any(v)}))
    check(abs(loss_k - loss_p) <= 1e-4 * max(1.0, abs(loss_p)), "gated-route losses differ")
    check(worst <= 1e-3, f"gated-route gradient norms differ between kernel and plain: {worst}")
    check(all(np.isfinite(v) and v > 0 for v in norms_k.values()), "a gradient is 0 or not finite")


def fusion_fragments(n: int, seed: int):
    """bench.py's fusion windows: a 90 + 250 Hz PCG and a 1.2 Hz ECG, each with its own
    noise, ``[16500, 2]`` (4 s at 4125 Hz), abs-max normalised; labels alternate."""
    from wav2vec_heart_sounds_tpu_torch.data.fragments import Fragment

    win = int(round(WINDOW_S * FUSION_FS))
    rng = np.random.default_rng(seed)
    t = np.arange(win) / FUSION_FS
    pcg = np.sin(2 * np.pi * 90 * t) + 0.4 * np.sin(2 * np.pi * 250 * t)
    ecg = np.sin(2 * np.pi * 1.2 * t)
    frags = []
    for i in range(n):
        wave = np.stack([pcg + 0.05 * rng.normal(size=win), ecg + 0.02 * rng.normal(size=win)],
                        axis=1)
        frags.append(Fragment((wave / np.max(np.abs(wave))).astype(np.float32), i % 2, f"p{i}"))
    return frags


def phase_fusion_training(card: str) -> dict:
    """Phase 16a: ``SupervisedTrainer.fit`` on bench.py's fusion config (``run_fusion_bench``:
    two full-width wav2vec2-base branches built by ``build_two_branch``, B=64, 4 s windows
    at 4125 Hz on two channels over the int16 wire, AdamW at 1e-4, bf16): one epoch of 4
    steps and a validation batch, finite losses, exact launches per step (K1 4+4, K2, K3b
    and K4 24+24), then fusion training windows/s (median of 3 timed epochs). Returns the
    launches of the fit."""
    from wav2vec_heart_sounds_tpu_torch.data.fragments import FragmentDataset
    from wav2vec_heart_sounds_tpu_torch.data.loader import Batcher
    from wav2vec_heart_sounds_tpu_torch.experiments.common import make_loader
    from wav2vec_heart_sounds_tpu_torch.models.build import build_two_branch
    from wav2vec_heart_sounds_tpu_torch.models.classifier import ClassifierConfig
    from wav2vec_heart_sounds_tpu_torch.train.classifier import SupervisedTrainer

    steps, win = 4, int(round(WINDOW_S * FUSION_FS))
    train = make_loader(FragmentDataset(fusion_fragments(FUSION_BATCH * steps, 0), fs=FUSION_FS),
                        FUSION_BATCH, True, 0, win)
    valid = Batcher(FragmentDataset(fusion_fragments(FUSION_BATCH, 1), fs=FUSION_FS),
                    FUSION_BATCH, train=False)
    steps, valid_batches = len(train), len(valid)
    branch = ClassifierConfig(num_classes=2, num_channels=1, random_init=True, fs=FUSION_FS)
    model = build_two_branch(branch, branch, seed=0, device="cuda", dtype=torch.bfloat16,
                             train=True)
    trainer = SupervisedTrainer(model, optimizer_name="adamw", lr=1e-4,
                                log=lambda line: print(f"[fusion] {line}"))
    losses, step = [], trainer._train_step

    def recorded_step(*args):
        loss, preds = step(*args)
        losses.append(loss)
        return loss, preds

    trainer._train_step = recorded_step
    trainer._run_epoch(train, True, 1)                                   # warm-up step
    torch.cuda.synchronize()
    losses.clear()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    best = trainer.fit(train, valid, 1)
    torch.cuda.synchronize()
    got = counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    values = [float(v) for v in losses]
    trained = sum(p.numel() for p in trainer.optimizer.params)
    print(f"[fusion] fit: {steps} steps of B={FUSION_BATCH} ({steps * FUSION_BATCH} windows of "
          f"2 x {win}) + {valid_batches} valid batch(es); {trained} trained parameters; losses "
          f"{', '.join(f'{v:.5f}' for v in values)}; best valid MCC {best:.4f}; peak device "
          f"memory {peak:.2f} GiB")
    check(len(values) == steps and all(np.isfinite(values)), f"fusion training losses {values}")
    for name, (f, b) in PER_STEP_FUSION.items():
        want = (f + b) * steps + EVAL_PER_BATCH_FUSION.get(name, 0) * valid_batches
        check(got[name] == want, f"fusion {name}: {got[name]} launches in fit, expected {want}")
    print(f"[fusion] launches in fit: {json.dumps(got)} (per train step fwd+bwd: "
          + per_step_text({k: v for k, v in PER_STEP_FUSION.items() if any(v)})
          + "; attention_qkv_fwd 24 per valid batch)")
    trainer._train_step = step
    runs = [timed_epoch(trainer, train) for _ in range(3)]
    print(f"[fusion] {steps * FUSION_BATCH} windows per epoch ({steps} steps of {FUSION_BATCH}, "
          f"bf16, two wav2vec2-base branches + 256x128 head, AdamW): "
          f"{steps * FUSION_BATCH / np.median(runs):.1f} fusion training windows/s on {card} "
          f"(median of 3 epochs: {', '.join(f'{s * 1e3:.1f}' for s in runs)} ms; host clock, "
          f"batching and transfer included)")
    return got


def phase_fusion_runner() -> None:
    """Phase 16b: the CinC runner ``experiments.cinc.run(mode="pcg_ecg")`` on phase 8's
    synthetic PCG+ECG directory, host chain (PCG and ECG chains), full width, bfloat16,
    4 s windows at 4125 Hz, one epoch of 2 steps for each of its three trainings (PCG branch,
    ECG branch, fusion): finite losses, finite statistics, a ``big_rnn:2:wav2vec`` record."""
    from wav2vec_heart_sounds_tpu_torch.experiments import cinc as runner

    losses = []

    class RecordingTrainer(runner.SupervisedTrainer):
        def _train_step(self, *args):
            loss, preds = super()._train_step(*args)
            losses.append(loss)
            return loss, preds

    with tempfile.TemporaryDirectory() as tmp, \
            mock.patch.object(runner, "SupervisedTrainer", RecordingTrainer):
        csv = synthetic_cinc(Path(tmp))
        results = Path(tmp) / "results.json"
        reset_counts()
        t0 = time.perf_counter()
        record = runner.run(tmp, csv, mode="pcg_ecg", fs=FUSION_FS, window_s=WINDOW_S, epochs=1,
                            augment=False, random_init=True, batch_size=4, max_batches=2,
                            results_json=str(results))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        got = counts()
        values = [float(v) for v in losses]
        stats = [v for level in ("fragment", "patient") for v in record[level].values()]
        print(f"[fusion-runner] experiments.cinc.run(mode='pcg_ecg'), host chain: {seconds:.1f} "
              f"s; train losses (PCG branch, ECG branch, fusion) "
              f"{', '.join(f'{v:.5f}' for v in values)}; topology {record['topology']}; "
              f"fragment {json.dumps(record['fragment'])}; patient "
              f"{json.dumps(record['patient'])}; launches K3b {got['attention_qkv_fwd']}+"
              f"{got['attention_qkv_bwd']}, K4 {got['ffn_mega_fwd']}+{got['ffn_mega_bwd']}")
        check(len(values) == 6 and all(np.isfinite(values)), f"fusion runner losses {values}")
        check(record["topology"] == "big_rnn:2:wav2vec", f"topology {record['topology']}")
        check(all(np.isfinite(v) for v in stats), "fusion runner statistics not finite")
        check(json.loads(results.read_text())[-1]["topology"] == "big_rnn:2:wav2vec",
              "the fusion results record is missing")
        check(got["ffn_mega_bwd"] == 12 * 2 + 12 * 2 + 24 * 2, f"K4 launches: {got}")
        check(got["pos_conv_bwd"] == 2 + 2 + 2 * 2, f"positional conv launches: {got}")


def timed_epoch(trainer, batcher) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer._run_epoch(batcher, True, None)
    torch.cuda.synchronize()
    return time.perf_counter() - t0


# The routes phase 7 trains: (name, encoder fields, launches per step, per valid batch).
ROUTES = (("K4", {}, PER_STEP, EVAL_PER_BATCH),
          ("K5 (control)", {"ffn_mega": False}, PER_STEP_SPLIT, EVAL_PER_BATCH),
          ("opt-in K3a + K8", {"qkv_fuse": False, "conv_fuse": True}, PER_STEP_GATED,
           EVAL_PER_BATCH_GATED))


def phase_training(card: str) -> dict:
    """Phase 7: ``SupervisedTrainer.fit`` at B=96 bf16 on the K4 route (the main path), the
    decomposed route's ``fit`` as the A/B control, and the opt-in route (``qkv_fuse=False``,
    ``conv_fuse=True``: K3a and K8), then training windows/s of the three in turns. Returns
    the launches: each kernel's count from the ``fit`` of the route that runs it (K5 runs
    only on the control, K3a and K8 only on the opt-in route)."""
    from wav2vec_heart_sounds_tpu_torch.data.fragments import FragmentDataset
    from wav2vec_heart_sounds_tpu_torch.data.loader import Batcher
    from wav2vec_heart_sounds_tpu_torch.experiments.cinc import _device_prep
    from wav2vec_heart_sounds_tpu_torch.experiments.common import make_loader
    from wav2vec_heart_sounds_tpu_torch.models.build import build_classifier
    from wav2vec_heart_sounds_tpu_torch.train.classifier import SupervisedTrainer

    win_len = int(WINDOW_S * FS)
    train = make_loader(FragmentDataset(synthetic_recordings(1, TRAIN_PATIENTS, TRAIN_WINDOWS),
                                        fs=FS_WIRE), TRAIN_BATCH, train=True)
    valid = Batcher(FragmentDataset(synthetic_recordings(2), fs=FS_WIRE), TRAIN_BATCH,
                    train=False)
    steps, valid_batches = len(train), len(valid)
    trainers, launches = {}, {}
    for route, fields, per_step, per_valid in ROUTES:
        model = build_classifier(classifier_config(**fields), seed=0, device="cuda",
                                 dtype=torch.bfloat16, train=True)
        trainer = SupervisedTrainer(model, optimizer_name="sgd", lr=1e-3,
                                    device_preprocess=_device_prep(FS_WIRE, FS, win_len, "cuda"),
                                    log=lambda line, r=route: print(f"[train] {r}: {line}"))
        losses, step = [], trainer._train_step

        def recorded_step(*args, step=step, losses=losses):
            loss, preds = step(*args)
            losses.append(loss)
            return loss, preds

        trainer._train_step = recorded_step
        trainer._run_epoch(train, True, 1)                               # warm-up step
        torch.cuda.synchronize()
        losses.clear()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        best = trainer.fit(train, valid, 1)
        torch.cuda.synchronize()
        got = counts()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        values = [float(v) for v in losses]
        print(f"[train] {route} fit: {steps} steps of B={TRAIN_BATCH} ({steps * TRAIN_BATCH} "
              f"windows) + {valid_batches} valid batches; losses "
              f"{', '.join(f'{v:.5f}' for v in values)}; best valid MCC {best:.4f}; peak "
              f"device memory {peak:.2f} GiB")
        check(len(values) == steps and all(np.isfinite(values)), f"training losses {values}")
        for name, (f, b) in per_step.items():
            want = (f + b) * steps + per_valid.get(name, 0) * valid_batches
            check(got[name] == want, f"{route} {name}: {got[name]} launches in fit, "
                                     f"expected {want}")
        print(f"[train] {route} launches in fit: {json.dumps(got)} (per train step fwd+bwd: "
              + per_step_text(per_step) + "; per valid batch "
              + ", ".join(f"{k} {n}" for k, n in per_valid.items()) + ")")
        for name, (f, b) in per_step.items():          # the first route that runs it
            if f + b and name not in launches:
                launches[name] = got[name]
        trainer._train_step = step
        trainers[route] = trainer

    names = [route for route, *_ in ROUTES]
    runs = {route: [] for route in names}
    for route in names + names[::-1] + names:                            # in turns
        runs[route].append(timed_epoch(trainers[route], train))
    for route in names:
        print(f"[train] {route} route: {steps * TRAIN_BATCH} windows per epoch ({steps} steps of "
              f"{TRAIN_BATCH}, bf16 wav2vec2-base + 512x3 head, SGD): "
              f"{steps * TRAIN_BATCH / np.median(runs[route]):.1f} training windows/s on {card} "
              f"(median of 3 epochs: {', '.join(f'{s * 1e3:.1f}' for s in runs[route])} ms; "
              f"host clock, batching, transfer and preprocessing included)")
    return launches


def vest_config(lora: bool = True):
    """bench.py's vest config: 6 microphones at 4125 Hz, LoRA on q/v, the 256 head,
    full-width wav2vec2-base, random weights."""
    from wav2vec_heart_sounds_tpu_torch.models.classifier import ClassifierConfig

    return ClassifierConfig(num_classes=2, num_channels=VEST_MICS, random_init=True, lora=lora,
                            fs=VEST_FS, head_hidden=(256,))


def phase_vest_step() -> dict:
    """One full-width float32 vest training step (B=2, 6 microphones, LoRA, the freeze mask,
    dropout and SpecAugment on), the kernels against all-plain versions from one state and
    one seed: the loss within 1e-4 relative, every trained parameter's gradient norm (and
    the waveform's, which this step also asks for, so K7's input gradient runs) within
    1e-3 relative, the exact launches of every kernel. Returns the kernel route's launches."""
    from wav2vec_heart_sounds_tpu_torch.models.build import build_classifier
    from wav2vec_heart_sounds_tpu_torch.models.classifier import apply_trainable_mask

    B = 2
    cfg = vest_config()
    model = build_classifier(cfg, seed=0, device="cuda", dtype=torch.float32, train=True)
    trained = apply_trainable_mask(model, cfg)
    cpu = torch.Generator().manual_seed(7)
    with torch.no_grad():                # lora_b starts at 0: give lora_a a gradient too
        for name, p in model.named_parameters():
            if name.endswith("lora_b"):
                p.copy_(0.02 * torch.randn(p.shape, generator=cpu))
    gen = torch.Generator(device="cuda").manual_seed(8)
    x = 0.3 * torch.randn(B, VEST_T, VEST_MICS, device="cuda", generator=gen)
    x.requires_grad_()
    y = torch.arange(B, device="cuda") % 2
    loss_k, norms_k = train_step(model, x, y, float32_step(PER_STEP_VEST_INPUT_GRAD))
    launches = counts()
    with plain_route():
        loss_p, norms_p = train_step(model, x, y, None)
    # The delay predictor's key biases have a true gradient of 0 (softmax ignores a shift
    # of every score of a query), so their norms are float32 rounding noise of the sum over
    # 8250 keys (measured 3e-7 vs 2e-7, kernels vs plain, on the H100): they are held to
    # being that small instead of to each other.
    noise = [n for n in norms_p if n.endswith("key.bias")]
    top = max(norms_p.values())
    check(all(max(norms_k[n], norms_p[n]) < 1e-5 * top for n in noise),
          f"key-bias gradients are not ~0: {[(norms_k[n], norms_p[n]) for n in noise]}")
    worst = worst_norm_gap({n: v for n, v in norms_k.items() if n not in noise},
                           {n: v for n, v in norms_p.items() if n not in noise})
    frozen = sum(1 for p in model.parameters() if not p.requires_grad)
    print(f"[vest-step] vest classifier f32 B={B} (6 mics x {VEST_T} samples, LoRA r=8), "
          f"dropout and SpecAugment on: loss kernels {loss_k:.7f} vs plain {loss_p:.7f}; "
          f"{len(norms_p) - 1} trained gradient norms ({frozen} frozen tensors) and the "
          f"waveform's, worst relative difference {worst:.3e} (limit 1e-3) outside the "
          f"{len(noise)} key biases (true gradient 0; at most "
          f"{max(max(norms_k[n], norms_p[n]) for n in noise) / top:.1e} of the largest norm, "
          f"limit 1e-5); launches fwd+bwd "
          + per_step_text({k: v for k, v in float32_step(PER_STEP_VEST_INPUT_GRAD).items()
                           if any(v)}))
    check(len(norms_k) == len(trained) + 1, "a trained parameter got no gradient")
    check(abs(loss_k - loss_p) <= 1e-4 * max(1.0, abs(loss_p)), "vest step losses differ")
    check(worst <= 1e-3, f"vest gradient norms differ between kernel and plain routes: {worst}")
    check(all(np.isfinite(v) and v > 0 for v in norms_k.values()), "a gradient is 0 or not finite")
    return launches


def vest_fragments(n: int, seed: int):
    """bench.py's vest windows: a two-tone beat plus independent noise on each microphone,
    ``[8250, 6]``, abs-max normalised; labels alternate."""
    from wav2vec_heart_sounds_tpu_torch.data.fragments import Fragment

    rng = np.random.default_rng(seed)
    t = np.arange(VEST_T) / VEST_FS
    base = np.sin(2 * np.pi * 85 * t) + 0.3 * np.sin(2 * np.pi * 190 * t)
    frags = []
    for i in range(n):
        wave = (base[:, None] + 0.05 * rng.normal(size=(VEST_T, VEST_MICS))).astype(np.float32)
        frags.append(Fragment(wave / np.max(np.abs(wave)), i % 2, f"p{i}"))
    return frags


def phase_vest_training(card: str) -> dict:
    """``SupervisedTrainer.fit`` on bench.py's vest config (B=16, bfloat16, AdamW at 1e-4,
    the LoRA freeze mask, lazy host augmentation with 15 augmented copies per window):
    finite losses, exact launches per step, vest training windows/s (median of 3 timed
    epochs); then the same with the augmentation on the card (exact launches, a finite
    loss, windows/s). Returns the launches of the fit."""
    from functools import partial

    from wav2vec_heart_sounds_tpu_torch.augment.pipelines import AugmentConfig
    from wav2vec_heart_sounds_tpu_torch.augment.torchaug import augment_multi_pcg_batch
    from wav2vec_heart_sounds_tpu_torch.data.fragments import FragmentDataset
    from wav2vec_heart_sounds_tpu_torch.data.loader import Batcher
    from wav2vec_heart_sounds_tpu_torch.data.vest import multi_augment, multi_augment_host_residual
    from wav2vec_heart_sounds_tpu_torch.experiments.common import make_loader
    from wav2vec_heart_sounds_tpu_torch.models.build import build_classifier
    from wav2vec_heart_sounds_tpu_torch.train.classifier import SupervisedTrainer

    steps = 4
    train_ds = FragmentDataset(vest_fragments(-(-VEST_BATCH * steps // 16), 0), fs=VEST_FS,
                               augment_num=15, augment_fn=partial(multi_augment,
                                                                  cfg=AugmentConfig()))
    train = make_loader(train_ds, VEST_BATCH, True, 0, VEST_T)
    valid = Batcher(FragmentDataset(vest_fragments(VEST_BATCH, 1), fs=VEST_FS), VEST_BATCH,
                    train=False)
    steps, valid_batches = len(train), len(valid)
    cfg = vest_config()
    model = build_classifier(cfg, seed=0, device="cuda", dtype=torch.bfloat16, train=True)
    trainer = SupervisedTrainer(model, optimizer_name="adamw", lr=1e-4, classifier_config=cfg,
                                log=lambda line: print(f"[vest-train] {line}"))
    losses, step = [], trainer._train_step

    def recorded_step(*args):
        loss, preds = step(*args)
        losses.append(loss)
        return loss, preds

    trainer._train_step = recorded_step
    trainer._run_epoch(train, True, 1)                                   # warm-up step
    torch.cuda.synchronize()
    losses.clear()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    best = trainer.fit(train, valid, 1)
    torch.cuda.synchronize()
    got = counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    values = [float(v) for v in losses]
    trained = sum(p.numel() for p in trainer.optimizer.params)
    print(f"[vest-train] fit: {steps} steps of B={VEST_BATCH} ({steps * VEST_BATCH} windows of "
          f"{VEST_MICS} x {VEST_T}) + {valid_batches} valid batch(es); {trained} trained "
          f"parameters; losses {', '.join(f'{v:.5f}' for v in values)}; best valid MCC "
          f"{best:.4f}; peak device memory {peak:.2f} GiB")
    check(len(values) == steps and all(np.isfinite(values)), f"vest training losses {values}")
    for name, (f, b) in PER_STEP_VEST.items():
        want = (f + b) * steps + EVAL_PER_BATCH_VEST.get(name, 0) * valid_batches
        check(got[name] == want, f"vest {name}: {got[name]} launches in fit, expected {want}")
    print(f"[vest-train] launches in fit: {json.dumps(got)} (per train step fwd+bwd: "
          + per_step_text({k: v for k, v in PER_STEP_VEST.items() if any(v)})
          + "; per valid batch attention_qkv_fwd 12, flash_kv_fwd 2, sinc_delay_fwd 1)")
    trainer._train_step = step
    runs = [timed_epoch(trainer, train) for _ in range(3)]
    print(f"[vest-train] {steps * VEST_BATCH} windows per epoch ({steps} steps of {VEST_BATCH}, "
          f"bf16, 6-mic beamformer + LoRA wav2vec2-base + 256 head, AdamW): "
          f"{steps * VEST_BATCH / np.median(runs):.1f} vest training windows/s on {card} "
          f"(median of 3 epochs: {', '.join(f'{s * 1e3:.1f}' for s in runs)} ms; host clock, "
          f"host augmentation, batching and transfer included)")

    # The same model and config with the augmentation on the card, as
    # experiments.multichannel.run builds it for device_augment=True without a noise bank:
    # the host keeps the head of the pipeline (vest_dataset's multi_augment_host_residual),
    # augment_multi_pcg_batch runs the rest on the card as the trainer's batch transform.
    device_ds = FragmentDataset(
        vest_fragments(-(-VEST_BATCH * steps // 16), 0), fs=VEST_FS, augment_num=15,
        augment_fn=partial(multi_augment_host_residual, cfg=AugmentConfig(),
                           recorded_on_device=False))
    device_train = make_loader(device_ds, VEST_BATCH, True, 0, VEST_T)
    trainer.batch_transform = partial(augment_multi_pcg_batch, fs=VEST_FS, noise_bank=None)
    trainer._run_epoch(device_train, True, 1)                            # warm-up step
    torch.cuda.synchronize()
    reset_counts()
    runs = [timed_epoch(trainer, device_train) for _ in range(3)]
    got_device = counts()
    for name, (f, b) in PER_STEP_VEST.items():
        want = 3 * steps * (f + b)
        check(got_device[name] == want,
              f"vest {name}, device augmentation: {got_device[name]} launches, expected {want}")
    loss = trainer._run_epoch(device_train, True, 1)[1]
    check(np.isfinite(loss), f"vest training loss with device augmentation: {loss}")
    trainer.batch_transform = None
    print(f"[vest-train] device augmentation: launches in 3 epochs of {steps} steps "
          f"{json.dumps({k: v for k, v in got_device.items() if v})}; "
          f"{steps * VEST_BATCH / np.median(runs):.1f} vest training windows/s on {card} "
          f"(median of 3 epochs: {', '.join(f'{s * 1e3:.1f}' for s in runs)} ms; host clock, "
          f"the host head of the augmentation, batching, transfer and augment_multi_pcg_batch "
          f"on the card included)")
    return got


def synthetic_vest(directory: Path, seed: int = 0) -> str:
    """A vest-layout directory: 8 recordings of 8 s at 4125 Hz, 9-column int16 WAVs (PCG
    microphones 1-7, ECG leads E and E2), written with ``scipy.io.wavfile``, and a split
    CSV (4 train, 2 valid, 2 test; half abnormal, with a murmur-like band on every
    microphone, each microphone a little delayed). Returns the CSV's path."""
    from scipy.io import wavfile

    rng = np.random.default_rng(seed)
    n = 8 * VEST_FS
    t = np.arange(n) / VEST_FS
    lines = ["patient,label,split"]
    for i, split in enumerate(("train",) * 4 + ("valid",) * 2 + ("test",) * 2):
        abnormal = i % 2
        rate, f0 = rng.uniform(0.9, 1.6), rng.uniform(40, 90)
        cols = []
        for mic in range(7):
            phase = (t * rate + 0.01 * mic) % 1.0
            beat = np.exp(-((phase - 0.10) / 0.02) ** 2) + 0.7 * np.exp(-((phase - 0.40) / 0.02) ** 2)
            x = beat * np.sin(2 * np.pi * f0 * t) + 0.02 * rng.normal(size=n)
            if abnormal:
                x += 0.3 * (0.20 < phase) * (phase < 0.35) * rng.normal(size=n)
            cols.append(x)
        ecg = np.sin(2 * np.pi * rate * t) ** 15
        cols += [ecg, -ecg]
        sig = np.stack(cols, axis=1)
        wavfile.write(str(directory / f"vest{i:02d}_rec.wav"), VEST_FS,
                      np.round(sig / np.abs(sig).max() * 30000).astype(np.int16))
        lines.append(f"vest{i:02d},{1 if abnormal else -1},{split}")
    path = directory / "split.csv"
    path.write_text("\n".join(lines) + "\n")
    return str(path)


def phase_vest_runner() -> None:
    """The vest runner ``experiments.multichannel.run`` on a synthetic vest directory, full
    width, bfloat16, one epoch of 2 steps of 16, LoRA (``random_init=False``: offline the
    builder keeps its random weights), ``fit_svm=False``: (a) the host chain
    (``multi_augment``) with cross-entropy, (b) ``device_augment=True`` with the
    contrastive-focal loss. Finite losses and statistics, a results record, and the K6 and
    K7 backward launches of the 2 steps (K7's input gradient: none, the data needs none)."""
    from wav2vec_heart_sounds_tpu_torch.experiments import multichannel as runner

    losses = []

    class RecordingTrainer(runner.SupervisedTrainer):
        def _train_step(self, *args):
            loss, preds = super()._train_step(*args)
            losses.append(loss)
            return loss, preds

    with tempfile.TemporaryDirectory() as tmp, \
            mock.patch.object(runner, "SupervisedTrainer", RecordingTrainer):
        csv = synthetic_vest(Path(tmp))
        results = Path(tmp) / "results.json"
        for label, kw in (("host chain, cross-entropy", dict(loss="ce")),
                          ("device augmentation, contrastive-focal",
                           dict(loss="contrastive-focal", device_augment=True))):
            losses.clear()
            reset_counts()
            t0 = time.perf_counter()
            record = runner.run(tmp, csv, fs=VEST_FS, window_s=2.0, epochs=1, augment=True,
                                random_init=False, fit_svm=False, batch_size=VEST_BATCH,
                                max_batches=2, results_json=str(results), **kw)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            got = counts()
            values = [float(v) for v in losses]
            stats = [v for level in ("fragment", "patient") for v in record["mlp"][level].values()]
            print(f"[vest-runner] experiments.multichannel.run, {label}: {seconds:.1f} s; train "
                  f"losses {', '.join(f'{v:.5f}' for v in values)}; mlp fragment "
                  f"{json.dumps(record['mlp']['fragment'])}; launches K6 "
                  f"{got['flash_kv_fwd']}+{got['flash_kv_bwd']}, K7 {got['sinc_delay_fwd']}+"
                  f"{got['sinc_delay_grad_d']}+{got['sinc_delay_grad_x']}, K1 {got['dropout']}")
            check(len(values) == 2 and all(np.isfinite(values)), f"vest runner losses {values}")
            check(all(np.isfinite(v) for v in stats), "vest runner statistics not finite")
            check(json.loads(results.read_text())[-1]["loss"] == record["loss"],
                  "the vest results record is missing")
            check(got["flash_kv_bwd"] == 2 * len(values) and got["sinc_delay_grad_d"] ==
                  len(values) and got["sinc_delay_grad_x"] == 0 and got["flash_kv_fwd"] >
                  2 * len(values), f"K6/K7 launches in the vest runner: {got}")
            check(got["pos_conv_bwd"] == len(values),
                  f"positional conv backward launches in the vest runner: {got}")


def synthetic_cinc(directory: Path, seed: int = 0) -> str:
    """A CinC-layout directory: 8 PCG+ECG records of 12 s at 2 kHz, written with the port's
    ``wfdb_io``, and a ``split.csv`` (4 train, 2 valid, 2 test; half abnormal, with a
    murmur-like band). Returns the CSV's path."""
    from wav2vec_heart_sounds_tpu_torch.data import wfdb_io

    rng = np.random.default_rng(seed)
    t = np.arange(12 * FS_WIRE) / FS_WIRE
    lines = ["# synthetic CinC 2016 layout", "patient,abnormality,split"]
    for i, split in enumerate(("train",) * 4 + ("valid",) * 2 + ("test",) * 2):
        abnormal = i % 2
        phase = (t * rng.uniform(0.9, 1.6) + rng.uniform()) % 1.0
        beat = np.exp(-((phase - 0.10) / 0.02) ** 2) + 0.7 * np.exp(-((phase - 0.40) / 0.02) ** 2)
        pcg = beat * np.sin(2 * np.pi * rng.uniform(40, 90) * t) + 0.02 * rng.normal(size=t.size)
        if abnormal:
            pcg += 0.3 * (0.20 < phase) * (phase < 0.35) * rng.normal(size=t.size)
        ecg = np.sin(2 * np.pi * 1.2 * t) ** 15
        wfdb_io.write_record(str(directory / f"a{i:04d}"), np.stack([pcg, ecg], 1), FS_WIRE,
                             sig_names=["PCG", "ECG"])
        lines.append(f"a{i:04d},{1 if abnormal else -1},{split}")
    path = directory / "split.csv"
    path.write_text("\n".join(lines) + "\n")
    return str(path)


def phase_runner() -> None:
    """The CinC runner ``experiments.cinc.run`` on a synthetic CinC directory, full width,
    bfloat16, 16 kHz, one epoch of two steps: (a) the raw wire with augmentation on the
    card, (b) the host chain with one augmented copy per record. Finite losses, fragment
    and patient statistics, a results record, and K4's launches, 12 + 12 per train step."""
    from wav2vec_heart_sounds_tpu_torch.experiments import cinc as runner

    losses = []

    class RecordingTrainer(runner.SupervisedTrainer):
        def _train_step(self, *args):
            loss, preds = super()._train_step(*args)
            losses.append(loss)
            return loss, preds

    with tempfile.TemporaryDirectory() as tmp, \
            mock.patch.object(runner, "SupervisedTrainer", RecordingTrainer):
        csv = synthetic_cinc(Path(tmp))
        results = Path(tmp) / "results.json"
        for label, kw in (("raw wire, augmentation on the card", dict(wire="raw")),
                          ("host chain, one augmented copy", dict(augment_num=1))):
            losses.clear()
            reset_counts()
            t0 = time.perf_counter()
            record = runner.run(tmp, csv, mode="pcg", fs=FS, window_s=WINDOW_S, epochs=1,
                                augment=True, random_init=True, batch_size=4, max_batches=2,
                                results_json=str(results), fs_wire=FS_WIRE, **kw)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            got = counts()
            values = [float(v) for v in losses]
            stats = [v for level in ("fragment", "patient") for v in record[level].values()]
            print(f"[runner] experiments.cinc.run, {label}: {seconds:.1f} s; train losses "
                  f"{', '.join(f'{v:.5f}' for v in values)}; fragment "
                  f"{json.dumps(record['fragment'])}; patient {json.dumps(record['patient'])}; "
                  f"K4 launches {got['ffn_mega_fwd']}+{got['ffn_mega_bwd']}")
            check(len(values) == 2 and all(np.isfinite(values)), f"runner losses {values}")
            check(all(np.isfinite(v) for v in stats), "runner statistics not finite")
            check(json.loads(results.read_text())[-1]["wire"] == record["wire"],
                  "the results record is missing")
            check(got["ffn_mega_fwd"] == got["ffn_mega_bwd"] == 12 * len(values),
                  f"K4 launches in the runner: {got}")
            check(got["pos_conv_bwd"] == len(values),
                  f"positional conv backward launches in the runner: {got}")


# The vocoders at full width (bench.py's gen modes, bench.py:44-205): (name, check frames,
# sampling batch, frames and sampler arguments, training batch and frames).
VOCODERS = (("diffwave", 16, 16, 96, {"fast": True}, 16, 80),
            ("wavegrad", 16, 8, 80, {"num_steps": 6}, 16, 80))
VOCODER_CHECK_BATCH, VOCODER_WINDOW_CALLS = 2, 10
# Adam's first update is about lr * sign(g): an element whose gradient is near 0 may take
# the other sign on the card, so a tensor's update is held to its L2 norm, not per element.
# The H100 showed 2.1e-4 (DiffWave) and 1.0e-4 (WaveGrad, whose clip acts at a norm of 29).
VOCODER_UPDATE_GAP = 2e-3
# The bf16 compute dtype against float32 from one state dict, as a share of the float32
# output's largest value: the H100 measured 7.8e-3 (DiffWave) and 6.5e-2 (WaveGrad, whose
# U-net rounds to bf16 at every layer), the CPU 1.0e-2 and 4.7e-2; the bar is 3x the
# largest. A layer left in the wrong dtype or a weight that did not load is off by O(1).
VOCODER_BF16_FORWARD = 0.2


def seeded_vocoder(name: str, seed: int = 0):
    """A full-width vocoder on the CPU from ``seed``, its zero-initialised tensors (DiffWave's
    output projection, every bias) drawn too so that every layer shapes the output."""
    from wav2vec_heart_sounds_tpu_torch.models.registry import get_spec

    model = get_spec(name).build_model(2, seed=seed, device="cpu")
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for p in model.parameters():
            if not p.abs().max():
                p.normal_(0.0, 0.05, generator=gen)
    return model


def vocoder_inputs(name: str, batch: int, frames: int, seed: int, device="cpu") -> dict:
    from wav2vec_heart_sounds_tpu_torch.models.registry import get_spec

    spec = get_spec(name)
    gen = torch.Generator().manual_seed(seed)
    n_mels = spec.mel("pcg").n_mels
    b = {"ref_audio": 0.3 * torch.randn(batch, spec.hop_length * frames, generator=gen),
         "con_spec": torch.rand(batch, n_mels, frames, generator=gen),
         "label": torch.arange(batch) % 2}
    return {k: v.to(device) for k, v in b.items()}


def vocoder_draws(name: str, ref: torch.Tensor, seed: int) -> tuple:
    """The loss strategy's draws, made once on the CPU and given to both devices."""
    gen = torch.Generator().manual_seed(seed)
    batch = ref.shape[0]
    noise = torch.randn(ref.shape, generator=gen)
    if name == "diffwave":
        return torch.randint(0, 50, (batch,), generator=gen), noise
    return (torch.randint(1, 1001, (batch,), generator=gen), torch.rand(batch, generator=gen),
            noise)


def trainer_step(model, loss, batch: dict, draws) -> tuple[float, dict, dict]:
    """One ``GenerativeTrainer.train_step`` of ``model`` with the given draws: the pre-clip
    global gradient norm, each parameter's Adam first-moment norm, and each parameter's
    update (on the CPU)."""
    from wav2vec_heart_sounds_tpu_torch.train.generative import GenerativeTrainer

    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    with tempfile.TemporaryDirectory() as tmp:
        trainer = GenerativeTrainer(model, loss, tmp, log=lambda line: None)
        trainer.train_step(batch, draws)
    norm = torch.linalg.vector_norm(torch.stack([p.grad.norm() for p in model.parameters()]))
    names = [n for n, _ in model.named_parameters()]
    moments = {n: m.norm().item() for n, m in zip(names, trainer.optimizer.state[0])}
    update = {n: (p.detach() - before[n]).float().cpu() for n, p in model.named_parameters()}
    return norm.item(), moments, update


def timed_windows(fn, calls: int = VOCODER_WINDOW_CALLS, windows: int = 3) -> list[float]:
    """Seconds of ``windows`` windows of ``calls`` calls each (host clock, synchronised)."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(windows):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        out.append(time.perf_counter() - t0)
    return out


def phase_vocoders(card: str) -> None:
    """Phase 18: DiffWave (``DiffWaveConfig()``: 30 x 64 channels, 80 mels, hop 256) and
    WaveGrad (``WaveGradConfig()``: 128 mels, hop 300, 15,956,161 parameters) at full width,
    float32, TF32 off. Each from a seed on the CPU (zero-initialised tensors drawn too), the
    state dict moved to the card: at B = 2 and 16 frames the forward, card against CPU, at
    1e-4 of the output's largest value, and one loss with its gradient from the same injected
    draws: the loss at 1e-4 relative, each parameter's gradient norm at 1e-3 relative (floored
    at 1e-6 of the largest norm); then one ``GenerativeTrainer.train_step`` on each from those
    weights and draws: the pre-clip global norm and each Adam first moment's norm at 1e-3
    relative, and each parameter's update within ``VOCODER_UPDATE_GAP`` of its L2 norm. No
    port kernel may launch (the vocoders run none). The bf16 arm (``bf16_arm``): the same
    weights built at the bf16 compute dtype keep float32 parameters through a ``train_step``,
    and their forward is within ``VOCODER_BF16_FORWARD`` of the float32 one. Then
    bench.py's gen modes on the card, each the median of 3 windows of 10 calls with the
    spread: DiffWave fast sampling (B = 16, 96 frames, 6 steps), WaveGrad sampling (B = 8, 80
    frames, 6 steps) and ``GenerativeTrainer.train_step`` of both (B = 16, 80 frames), in
    float32 and at the bf16 compute dtype (``gen-train``'s default), in audio-s/s (seconds
    of 4 kHz audio generated, or trained on, per wall second)."""
    import copy
    from wav2vec_heart_sounds_tpu_torch.models.registry import get_spec
    from wav2vec_heart_sounds_tpu_torch.train.generative import GenerativeTrainer

    for name, frames, s_batch, s_frames, s_kw, t_batch, t_frames in VOCODERS:
        t0 = time.perf_counter()
        spec = get_spec(name)
        cpu = seeded_vocoder(name)
        dev = copy.deepcopy(cpu).to("cuda")
        b = vocoder_inputs(name, VOCODER_CHECK_BATCH, frames, seed=18)
        bc = {k: v.cuda() for k, v in b.items()}
        args = ((b["ref_audio"], torch.tensor([3, 41]), b["con_spec"], b["label"])
                if name == "diffwave" else
                (b["ref_audio"], b["con_spec"], torch.tensor([0.3, 0.9]), b["label"]))
        reset_counts()
        with torch.no_grad():
            want = cpu(*args)
            got = dev(*(a.cuda() for a in args)).cpu()
        scale = want.abs().max().item()
        fwd_err = (got - want).abs().max().item()
        check(scale > 0.1 and fwd_err <= 1e-4 * scale,
              f"{name} forward card vs CPU: {fwd_err} of {scale}")
        draws = vocoder_draws(name, b["ref_audio"], seed=19)
        bf16_arm(name, spec, cpu, args, got, draws)
        losses, norms = [], []
        for model, batch, dev_draws in ((cpu, b, draws), (dev, bc, [d.cuda() for d in draws])):
            model.zero_grad(set_to_none=True)
            loss = spec.loss(model, batch, None, dev_draws)
            loss.backward()
            losses.append(loss.item())
            norms.append({n: p.grad.norm().item() for n, p in model.named_parameters()})
        torch.cuda.synchronize()
        check(not any(counts().values()), f"{name} launched a port kernel: {counts()}")
        worst = worst_norm_gap(norms[1], norms[0])
        print(f"[vocoders] {name} f32 B={VOCODER_CHECK_BATCH}, {frames} frames: forward card vs "
              f"CPU max_abs_err={fwd_err:.3e} of {scale:.3e} (limit 1e-4 of it); loss card "
              f"{losses[1]:.7f} vs CPU {losses[0]:.7f}; {len(norms[0])} gradient norms, worst "
              f"relative difference {worst:.3e} (limit 1e-3); no port kernel launched")
        check(abs(losses[1] - losses[0]) <= 1e-4 * abs(losses[0]), f"{name} losses differ")
        check(worst <= 1e-3, f"{name} gradient norms differ between card and CPU: {worst}")
        steps = [trainer_step(model, spec.loss, b, step_draws)
                 for model, step_draws in ((cpu, draws), (dev, [d.cuda() for d in draws]))]
        (cpu_norm, cpu_m, cpu_upd), (dev_norm, dev_m, dev_upd) = steps
        moment_gap = worst_norm_gap(dev_m, cpu_m)
        update_gap = max((dev_upd[n] - cpu_upd[n]).norm().item()
                         / max(cpu_upd[n].norm().item(), 1e-12) for n in cpu_upd)
        print(f"[vocoders] {name} one GenerativeTrainer.train_step from the same weights and "
              f"draws: pre-clip global norm card {dev_norm:.6f} vs CPU {cpu_norm:.6f} (clip "
              f"1.0); Adam's first moment, worst relative difference of a tensor's norm "
              f"{moment_gap:.3e} (limit 1e-3); the step's update, worst relative L2 difference "
              f"of a tensor {update_gap:.3e} (limit {VOCODER_UPDATE_GAP:g})")
        check(abs(dev_norm - cpu_norm) <= 1e-3 * cpu_norm and moment_gap <= 1e-3
              and update_gap <= VOCODER_UPDATE_GAP,
              f"{name} train step differs between card and CPU")
        del cpu, dev

        model = seeded_vocoder(name, seed=1).cuda()
        sb = vocoder_inputs(name, s_batch, s_frames, seed=20, device="cuda")
        gen = torch.Generator(device="cuda").manual_seed(21)
        audio, sr = spec.sample(model, sb["con_spec"], sb["label"], gen, **s_kw)
        check(tuple(audio.shape) == (s_batch, spec.hop_length * s_frames) and sr == 4000
              and bool(torch.isfinite(audio).all()) and audio.abs().max().item() <= 1.0,
              f"{name} sampler output {tuple(audio.shape)} at {sr} Hz")
        runs = timed_windows(lambda: spec.sample(model, sb["con_spec"], sb["label"], gen,
                                                 **s_kw))
        seconds = s_batch * VOCODER_WINDOW_CALLS * spec.hop_length * s_frames / sr
        print(f"[vocoders] {name} sampling {json.dumps(s_kw)}, B={s_batch}, {s_frames} frames: "
              f"{seconds / np.median(runs):.1f} audio-s/s on {card} (median of 3 windows of "
              f"{VOCODER_WINDOW_CALLS} calls: {', '.join(f'{r * 1e3:.1f}' for r in runs)} ms; "
              f"host clock)")

        tb = vocoder_inputs(name, t_batch, t_frames, seed=22)
        with tempfile.TemporaryDirectory() as tmp:
            trainer = GenerativeTrainer(model, spec.loss, tmp, log=lambda line: None)
            torch.cuda.reset_peak_memory_stats()
            losses = [trainer.train_step(tb) for _ in range(2)]
            runs = timed_windows(lambda: losses.append(trainer.train_step(tb)))
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        check(all(np.isfinite(losses)), f"{name} training losses {losses}")
        seconds = t_batch * VOCODER_WINDOW_CALLS * spec.hop_length * t_frames / sr
        print(f"[vocoders] {name} GenerativeTrainer.train_step, B={t_batch}, {t_frames} frames "
              f"(clip 1.0, Adam): {np.median(runs) / VOCODER_WINDOW_CALLS * 1e3:.1f} ms a step, "
              f"{seconds / np.median(runs):.1f} audio-s/s on {card} (median of 3 windows of "
              f"{VOCODER_WINDOW_CALLS} steps: {', '.join(f'{r * 1e3:.1f}' for r in runs)} ms; "
              f"host clock, the host-to-device copy included); losses "
              f"{losses[0]:.5f} .. {losses[-1]:.5f}; peak device memory {peak:.2f} GiB")

        bf16 = spec.build_model(2, device="cuda", dtype=torch.bfloat16)
        bf16.load_state_dict(model.state_dict())
        with tempfile.TemporaryDirectory() as tmp:
            trainer = GenerativeTrainer(bf16, spec.loss, tmp, log=lambda line: None)
            losses = [trainer.train_step(tb) for _ in range(2)]
            runs = timed_windows(lambda: losses.append(trainer.train_step(tb)))
        check(all(np.isfinite(losses)) and not float32_gaps(bf16),
              f"{name} bf16 training: losses {losses}, parameters {float32_gaps(bf16)}")
        print(f"[vocoders] {name} GenerativeTrainer.train_step at the bf16 compute dtype (gen-train's "
              f"default; float32 parameters), B={t_batch}, {t_frames} frames: "
              f"{np.median(runs) / VOCODER_WINDOW_CALLS * 1e3:.1f} ms a step, "
              f"{seconds / np.median(runs):.1f} audio-s/s on {card} (median of 3 windows of "
              f"{VOCODER_WINDOW_CALLS} steps: {', '.join(f'{r * 1e3:.1f}' for r in runs)} ms; "
              f"host clock); losses {losses[0]:.5f} .. {losses[-1]:.5f}; phase wall "
              f"{time.perf_counter() - t0:.1f} s")
        del model, bf16, trainer


def float32_gaps(model) -> list[str]:
    """The parameters of ``model`` that are not float32."""
    return [n for n, p in model.named_parameters() if p.dtype != torch.float32]


def bf16_arm(name: str, spec, cpu, args: tuple, f32_out: torch.Tensor, draws) -> None:
    """The vocoder built at the bf16 compute dtype from the float32 CPU state dict, on the
    card: every parameter float32 after the build and after one ``train_step``, and its
    forward within ``VOCODER_BF16_FORWARD`` of the float32 card forward's largest value."""
    from wav2vec_heart_sounds_tpu_torch.train.generative import GenerativeTrainer

    model = spec.build_model(2, device="cuda", dtype=torch.bfloat16)
    model.load_state_dict(cpu.state_dict())
    built = float32_gaps(model)
    with torch.no_grad():
        out = model(*(a.cuda() for a in args)).cpu()
    scale = f32_out.abs().max().item()
    err = (out - f32_out).abs().max().item()
    batch = vocoder_inputs(name, args[0].shape[0], args[0].shape[1] // spec.hop_length, seed=18)
    with tempfile.TemporaryDirectory() as tmp:
        loss = GenerativeTrainer(model, spec.loss, tmp, log=lambda line: None).train_step(
            batch, [d.cuda() for d in draws])
    stepped = float32_gaps(model)
    print(f"[vocoders] {name} bf16 compute dtype: forward vs the float32 card forward "
          f"max_abs_err={err:.3e} of {scale:.3e} (limit {VOCODER_BF16_FORWARD:g} of it); "
          f"parameters not float32 after the build: {built}, after one train_step (loss "
          f"{loss:.5f}): {stepped}")
    check(out.dtype == torch.float32 and err <= VOCODER_BF16_FORWARD * scale,
          f"{name} bf16 forward: {err} of {scale}")
    check(not built and not stepped and np.isfinite(loss),
          f"{name} bf16 parameters {built} / {stepped}, loss {loss}")


def phase_generative_pipeline(tmp: Path) -> str:
    """Phase 19: the generative pipeline on phase 8's synthetic CinC directory (written into
    ``tmp / "cinc"``), once with DiffWave and once with WaveGrad (sampled with
    ``num_steps=6``): ``cinc_generative_dataset`` (train and valid, 4 kHz, 96 frames) ->
    ``GenerativeTrainer.train`` (one epoch of two B=2 batches, a validation pass, the sample
    WAV) -> ``restore`` of ``weights-best`` into a model from another seed, which must equal
    the trained state -> ``generate_dataset`` with ``per_item=2``. The manifest has items x 2
    rows in order (``<patient>_<idx>_<copy>.wav``), and every WAV is at 4 kHz, ``hop * 96``
    samples long, float32 with abs-max 1. Returns DiffWave's output directory."""
    import csv

    from scipy.io import wavfile

    from wav2vec_heart_sounds_tpu_torch.data.generative import cinc_generative_dataset
    from wav2vec_heart_sounds_tpu_torch.models.registry import get_spec
    from wav2vec_heart_sounds_tpu_torch.train.generate import generate_dataset
    from wav2vec_heart_sounds_tpu_torch.train.generative import GenBatcher, GenerativeTrainer

    real = tmp / "cinc"
    real.mkdir()
    csv_path = synthetic_cinc(real)
    outputs = {}
    for name, kwargs in (("diffwave", {"fast": True}), ("wavegrad", {"num_steps": 6})):
        t0 = time.perf_counter()
        spec = get_spec(name)
        data = {subset: cinc_generative_dataset(
            str(real), csv_path, subset, fs=spec.sample_rate, mel=spec.mel("pcg"),
            crop_frames=spec.crop_frames, hop_length=spec.hop_length)
            for subset in ("train", "valid")}
        model = spec.build_model(2, seed=0, device="cuda")
        lines = []
        trainer = GenerativeTrainer(model, spec.loss, str(tmp / f"{name}-model"),
                                    sampler=spec.sample, sample_every=1,
                                    log_dir=str(tmp / f"{name}-logs"), log=lines.append)
        trainer.train(GenBatcher(data["train"], 2, shuffle=True), 1,
                      GenBatcher(data["valid"], 2, shuffle=False), max_train_batches=2)
        trained = {k: v.clone() for k, v in model.state_dict().items()}
        fresh = spec.build_model(2, seed=9, device="cuda")
        restored = GenerativeTrainer(fresh, spec.loss, str(tmp / f"{name}-restored"),
                                     log=lambda line: None)
        check(restored.restore(str(tmp / f"{name}-model" / "weights-best.pt"))
              and restored.step == trainer.step == 2, f"{name}: weights-best did not restore")
        check(all(torch.equal(fresh.state_dict()[k], v) for k, v in trained.items()),
              f"{name}: the restored weights-best is not the trained state")
        check((tmp / f"{name}-logs" / "sample_e1.wav").exists(), f"{name}: no sample WAV")
        out = tmp / f"{name}-generated"
        manifest = generate_dataset(fresh, spec, data["train"], str(out), per_item=2,
                                    sampler_kwargs=kwargs)
        with open(manifest, newline="") as fh:
            rows = list(csv.reader(fh))
        items = len(data["train"])
        want = [["patient", "label", "file"]] + [
            [data["train"][i]["patient"], str(data["train"][i]["label"]),
             f"{data['train'][i]['patient']}_{i}_{c}.wav"] for i in range(items) for c in (0, 1)]
        check(items > 0 and rows == want, f"{name} manifest rows {rows}")
        for _, _, file in rows[1:]:
            sr, wave = wavfile.read(out / file)
            check(sr == 4000 and wave.shape == (spec.hop_length * 96,) and
                  wave.dtype == np.float32 and np.abs(wave).max() == 1.0,
                  f"{name} {file}: {sr} Hz, {wave.shape}, abs-max {np.abs(wave).max()}")
        print(f"[pipeline] {name}: {items} train items, {len(data['valid'])} valid; "
              f"{'; '.join(lines)}; weights-best restored equal (step {restored.step}); "
              f"generate_dataset {json.dumps(kwargs)} per_item=2: {len(rows) - 1} WAVs of "
              f"{spec.hop_length * 96} samples at 4 kHz, abs-max 1; "
              f"{time.perf_counter() - t0:.1f} s")
        outputs[name] = str(out)
        del model, fresh, trainer, restored
    return outputs["diffwave"]


SYNTHETIC_RECORD_KEYS = {"schedule", "fs", "random_init", "run_label", "skipped_stages",
                         "fragment", "patient"}     # the JAX runner's record


def phase_synthetic_runner(tmp: Path, generated: str) -> None:
    """Phase 20: ``experiments.synthetic.run`` on a schedule of phase 8's real directory and
    phase 19's DiffWave manifest (real, then generated with ``letskip``; the real valid and
    test splits), full-width wav2vec2-base, random init, bf16, 4 s at 4125 Hz (51 frames),
    B = 64 (one bootstrap batch a stage): finite losses, every kernel's exact launches (K1 2+2,
    K2, K3b and K4 12+12 a train step; K3b 12 a validation or test batch; no other kernel),
    and a record with the JAX runner's keys."""
    from wav2vec_heart_sounds_tpu_torch.experiments import synthetic as runner

    real = tmp / "cinc"
    real_set = {"path": str(real), "split": str(real / "split.csv"), "segment": "",
                "gen_data": False, "augment_num": 0}
    schedule = {"test_set": {"data": str(real), "split": str(real / "split.csv"), "segment": ""},
                "valid_set": {"data": str(real), "split": str(real / "split.csv"),
                              "segment": ""},
                "datasets": {"real": real_set,
                             "generated": {"path": generated, "split": "", "segment": "",
                                           "gen_data": True, "augment_num": 0}},
                "schedule": [{"key": "real", "epochs": 1},
                             {"key": "generated", "epochs": 1, "letskip": True}]}
    path = tmp / "schedule.json"
    path.write_text(json.dumps(schedule))
    results = tmp / "synthetic.json"
    with counted_runner(runner) as (losses, evals):
        reset_counts()
        t0 = time.perf_counter()
        record = runner.run(str(path), fs=FUSION_FS, window_s=WINDOW_S, random_init=True,
                            batch_size=FUSION_BATCH, results_json=str(results),
                            run_label="chip_smoke")
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    got = counts()
    values = [float(v) for v in losses]
    steps = len(values)
    stats = [v for level in ("fragment", "patient") for v in record[level].values()]
    print(f"[synthetic] experiments.synthetic.run (real, then generated with letskip; skipped "
          f"{record['skipped_stages']}): {seconds:.1f} s; {steps} train steps of B="
          f"{FUSION_BATCH}, {evals[0]} validation/test batches; losses "
          f"{', '.join(f'{v:.5f}' for v in values)}; fragment {json.dumps(record['fragment'])}; "
          f"patient {json.dumps(record['patient'])}; launches {json.dumps(got)}")
    check(steps >= 1 and all(np.isfinite(values)), f"synthetic runner losses {values}")
    check(set(record) == SYNTHETIC_RECORD_KEYS, f"synthetic record keys {sorted(record)}")
    check(all(np.isfinite(v) for v in stats), "synthetic runner statistics not finite")
    check(json.loads(results.read_text())[-1]["run_label"] == "chip_smoke",
          "the synthetic results record is missing")
    check_launches("synthetic", got, steps, evals[0], PER_STEP, EVAL_PER_BATCH)


@contextlib.contextmanager
def counted_runner(runner):
    """``runner``'s trainer and apply function recording each train step's loss and counting
    eval batches (validation and test); yields ``(losses, [evals])``."""
    losses, evals = [], [0]

    class RecordingTrainer(runner.SupervisedTrainer):
        def _train_step(self, *args):
            loss, preds = super()._train_step(*args)
            losses.append(loss)
            return loss, preds

        def _eval_step(self, *args):
            evals[0] += 1
            return super()._eval_step(*args)

    apply_fn = runner.make_apply_fn

    def counted_apply_fn(model):
        fn = apply_fn(model)

        def apply(x):
            evals[0] += 1
            return fn(x)

        return apply

    with mock.patch.object(runner, "SupervisedTrainer", RecordingTrainer), \
            mock.patch.object(runner, "make_apply_fn", counted_apply_fn):
        yield losses, evals


def check_launches(label: str, got: dict, steps: int, evals: int, per_step: dict,
                   per_eval: dict) -> None:
    """Every kernel launched exactly ``per_step`` (forward, backward) a train step and
    ``per_eval`` an eval batch."""
    for name in kernel_wrappers():
        f, b = per_step.get(name, (0, 0))
        want = (f + b) * steps + per_eval.get(name, 0) * evals
        check(got[name] == want, f"{label} {name}: {got[name]} launches, expected {want}")


CLI_COMMANDS = ("make-splits", "summarize", "gen-train", "gen-sample", "classify-cinc",
                "classify-vest", "classify-synthetic", "classify-lsdo")
# The JAX runners' records (``experiments/cinc.py::run``, ``multichannel.py::run`` without
# the SVM probe).
CINC_RECORD_KEYS = {"mode", "dataset", "fs", "epochs", "train_epochs", "augment", "augment_num",
                    "random_init", "reference_train_rnn", "topology", "fold", "run_label",
                    "wire", "fragment", "patient"}
VEST_RECORD_KEYS = {"channels", "fs", "epochs", "augment", "random_init", "lora",
                    "freeze_encoder", "loss", "fold", "run_label", "mlp"}
# The vest without LoRA (``--random-init`` turns it off): K1 at the feature projection and
# the encoder input only.
PER_STEP_VEST_NO_LORA = {**PER_STEP_VEST, "dropout": PER_STEP["dropout"]}


def run_cli(argv: list[str]) -> tuple[str, float]:
    """``cli.main(argv)`` in this process; its standard output and wall seconds."""
    import io

    from wav2vec_heart_sounds_tpu_torch import cli

    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        cli.main(argv)
    torch.cuda.synchronize()
    return out.getvalue(), time.perf_counter() - t0


def echoed_record(text: str) -> dict:
    """The record a ``classify-*`` command prints last (``json.dumps(indent=2)``)."""
    text = "\n" + text
    return json.loads(text[text.rindex("\n{\n") + 1:])


def check_record(label: str, text: str, results: Path, keys: set, levels) -> dict:
    """The echoed record: the JAX runner's keys, finite statistics, and the same record as
    the last one the command appended to its results JSON."""
    record = echoed_record(text)
    stats = [v for level in levels for v in level(record).values()]
    check(set(record) == keys, f"{label} record keys {sorted(record)}")
    check(len(stats) > 0 and all(np.isfinite(v) for v in stats),
          f"{label} statistics not finite: {stats}")
    check(json.loads(results.read_text())[-1] == record, f"{label}: the results record differs")
    return record


def phase_cli(tmp: Path) -> None:
    """Phase 21: the command line on the card. ``python -m wav2vec_heart_sounds_tpu_torch.cli
    --help`` in a subprocess lists the eight commands; then, in this process through
    ``cli.main`` (so launches count), on phase 8's synthetic CinC directory and a synthetic
    vest directory: ``make-splits`` (a ``REFERENCE.csv`` of the CinC records), ``classify-cinc``
    (raw wire), ``classify-vest`` (random init, so no LoRA), ``gen-train`` (DiffWave, at the
    default ``--bf16``), ``gen-sample``, ``classify-synthetic`` on the real directory and that
    manifest, and ``summarize`` over the three records. Each record has the JAX runner's keys
    and finite statistics, and every kernel launches exactly as phases 8, 12 and 20 count for
    those runners; the vocoder commands launch none. The host chain is the C++ library
    (``native.available()``, and the dataset builds called it): its seconds and its largest
    difference from the NumPy oracle on one record. Then ``preprocess_ecg``, the three
    normalisers and ``segment`` on the card against the CPU at 1e-4 max-abs."""
    from wav2vec_heart_sounds_tpu_torch import native
    from wav2vec_heart_sounds_tpu_torch.data import splits, wfdb_io
    from wav2vec_heart_sounds_tpu_torch.experiments import cinc, multichannel, synthetic
    from wav2vec_heart_sounds_tpu_torch.signal import preprocess

    help_text = subprocess.run([sys.executable, "-m", "wav2vec_heart_sounds_tpu_torch.cli",
                                "--help"], cwd=ROOT, capture_output=True, text=True, check=True)
    check(all(name in help_text.stdout for name in CLI_COMMANDS),
          f"cli --help: {help_text.stdout}")
    check(native.available(), "the C++ host library did not build")

    real, vest = tmp / "cinc", tmp / "cli-vest"
    vest.mkdir()
    vest_csv = synthetic_vest(vest)
    with open(real / "split.csv") as fh:
        rows = [line.strip().split(",") for line in fh if line[0] not in "#p"]
    (real / "REFERENCE.csv").write_text("".join(f"{r[0]},{r[1]}\n" for r in rows))
    results = tmp / "cli-results.json"
    chain = {"calls": 0, "seconds": 0.0}
    native_pcg = native.preprocess_pcg

    def timed_chain(*args, **kwargs):
        t0 = time.perf_counter()
        out = native_pcg(*args, **kwargs)
        chain["calls"] += 1
        chain["seconds"] += time.perf_counter() - t0
        return out

    walls = {}
    with mock.patch.object(native, "preprocess_pcg", timed_chain):
        text, walls["make-splits"] = run_cli(["make-splits", "--data-dir", str(real), "--out",
                                              str(tmp / "splits.csv"), "--folds", "2"])
        table = splits.make_splits_from_dirs([str(real)], folds=2)
        check(text.startswith(f"Wrote {len(rows)} records x 2 fold(s)") and
              (tmp / "splits.csv").read_text().splitlines()[0] == "patient,label,split,split2"
              and json.loads(text.split("\n", 1)[1]) == splits.split_counts(table),
              f"make-splits: {text}")

        for name, argv, runner, per_step, per_eval, keys, levels in (
                ("classify-cinc", ["--data-dir", str(real), "--csv", str(real / "split.csv"),
                                   "--wire", "raw"], cinc, PER_STEP, EVAL_PER_BATCH,
                 CINC_RECORD_KEYS, (lambda r: r["fragment"], lambda r: r["patient"])),
                ("classify-vest", ["--data-dir", str(vest), "--csv", vest_csv, "--no-svm"],
                 multichannel, PER_STEP_VEST_NO_LORA, EVAL_PER_BATCH_VEST, VEST_RECORD_KEYS,
                 (lambda r: r["mlp"]["fragment"], lambda r: r["mlp"]["patient"]))):
            with counted_runner(runner) as (losses, evals):
                reset_counts()
                text, walls[name] = run_cli([
                    name, *argv, "--random-init", "--no-augment", "--epochs", "1",
                    "--max-batches", "2" if name == "classify-cinc" else "1",
                    "--results-json", str(results)])
            got = counts()
            values = [float(v) for v in losses]
            record = check_record(name, text, results, keys, levels)
            print(f"[cli] {name}: {walls[name]:.1f} s; {len(values)} train steps, {evals[0]} "
                  f"validation/test batches; losses {', '.join(f'{v:.5f}' for v in values)}; "
                  f"{json.dumps(levels[0](record))}; launches {json.dumps(got)}")
            check(len(values) >= 1 and all(np.isfinite(values)), f"{name} losses {values}")
            check_launches(name, got, len(values), evals[0], per_step, per_eval)

        model_dir, generated = tmp / "cli-diffwave", tmp / "cli-generated"
        gen = ["--model", "diffwave", "--data-dir", str(real), "--csv", str(real / "split.csv")]
        reset_counts()
        text, walls["gen-train"] = run_cli(["gen-train", *gen, "--output-dir", str(model_dir),
                                            "--epochs", "1", "--max-train-batches", "2"])
        saved = torch.load(model_dir / "weights.pt", map_location="cpu", weights_only=True)
        check(text.endswith(f"Saved generator to {model_dir}/weights.pt\n") and
              all(v.dtype == torch.float32 for v in saved["model"].values()),
              f"gen-train: {text}")
        text, walls["gen-sample"] = run_cli(["gen-sample", *gen, "--weights",
                                             str(model_dir / "weights.pt"), "--output-dir",
                                             str(generated)])
        manifest = generated / "REFERENCE.csv"
        check(text == f"Wrote manifest {manifest}\n" and len(manifest.read_text().splitlines())
              == len(rows) + 1, f"gen-sample: {text}")
        check(not any(counts().values()), f"the vocoder commands launched {counts()}")
        print(f"[cli] gen-train (DiffWave, bf16 compute, float32 checkpoint, step "
              f"{saved['step']}): {walls['gen-train']:.1f} s; gen-sample: "
              f"{walls['gen-sample']:.1f} s, {len(rows)} WAVs")

        schedule = {"test_set": {"data": str(real), "split": str(real / "split.csv"),
                                 "segment": ""},
                    "valid_set": {"data": str(real), "split": str(real / "split.csv"),
                                  "segment": ""},
                    "datasets": {"real": {"path": str(real), "split": str(real / "split.csv"),
                                          "segment": "", "gen_data": False, "augment_num": 0},
                                 "generated": {"path": str(generated), "split": "",
                                               "segment": "", "gen_data": True,
                                               "augment_num": 0}},
                    "schedule": [{"key": "real", "epochs": 1},
                                 {"key": "generated", "epochs": 1}]}
        (tmp / "cli-schedule.json").write_text(json.dumps(schedule))
        with counted_runner(synthetic) as (losses, evals):
            reset_counts()
            text, walls["classify-synthetic"] = run_cli([
                "classify-synthetic", "--schedule", str(tmp / "cli-schedule.json"),
                "--random-init", "--max-batches", "2", "--results-json", str(results)])
        got = counts()
        values = [float(v) for v in losses]
        record = check_record("classify-synthetic", text, results, SYNTHETIC_RECORD_KEYS,
                              (lambda r: r["fragment"], lambda r: r["patient"]))
        print(f"[cli] classify-synthetic: {walls['classify-synthetic']:.1f} s; {len(values)} "
              f"train steps, {evals[0]} validation/test batches; skipped "
              f"{record['skipped_stages']}; launches {json.dumps(got)}")
        check(len(values) >= 1 and all(np.isfinite(values)), f"synthetic losses {values}")
        check_launches("classify-synthetic", got, len(values), evals[0], PER_STEP,
                       EVAL_PER_BATCH)

    text, walls["summarize"] = run_cli(["summarize", str(results)])
    check(text.startswith("| condition | n |") and len(text.splitlines()) == 3,
          f"summarize: {text}")
    check(chain["calls"] > 0, "the dataset builds did not take the C++ host chain")
    record = wfdb_io.read_record(str(real / "a0000"))
    signal, fs = record.p_signal, record.fs
    t0 = time.perf_counter()
    fast = native_pcg(signal[:, 0], fs, 4125)
    one = time.perf_counter() - t0
    gap = np.abs(fast - preprocess.preprocess_pcg(signal[:, 0], fs, 4125)).max()
    print(f"[cli] the host chain: the C++ library ({native.BUILD_DIR}), {chain['calls']} PCG "
          f"records in {chain['seconds']:.3f} s across the commands; one 12 s record at "
          f"{fs} Hz -> 4125 Hz {one * 1e3:.2f} ms, max |C++ - NumPy oracle| = {gap:.3e}")
    check(gap < 1e-9, f"the C++ chain differs from the oracle by {gap}")
    signal_ops_on_card()
    print(f"[cli] wall by command: {json.dumps({k: round(v, 1) for k, v in walls.items()})}")


def signal_ops_on_card() -> None:
    """``preprocess_ecg``, the three normalisers and ``segment`` on the card against the
    same functions on the CPU, at 1e-4 max-abs."""
    from wav2vec_heart_sounds_tpu_torch.config import WindowSpec
    from wav2vec_heart_sounds_tpu_torch.ops import normalize, segment
    from wav2vec_heart_sounds_tpu_torch.signal import torchproc

    gen = torch.Generator().manual_seed(21)
    t = torch.arange(4 * FS_WIRE) / FS_WIRE
    ecg = torch.sin(2 * np.pi * (1.0 + torch.rand(8, 1, generator=gen)) * t) ** 15 \
        + 0.05 * torch.randn(8, t.numel(), generator=gen)
    x = torch.randn(8, 16500, generator=gen) * 3.0 + 0.5
    for label, fn, arg in (
            ("preprocess_ecg", lambda v: torchproc.preprocess_ecg(v, FS_WIRE, 4125), ecg),
            ("minmax_normalise", normalize.minmax_normalise, x),
            ("z_normalise", normalize.z_normalise, x),
            ("kpeak_normalise", normalize.kpeak_normalise, x),
            ("segment", lambda v: segment.segment(v, 4125, WindowSpec(window_s=2.0)), x)):
        want = fn(arg)
        got = fn(arg.cuda()).cpu()
        err = (got - want).abs().max().item()
        print(f"[cli] {label} {tuple(arg.shape)} card vs CPU: max_abs_err={err:.3e} "
              f"(limit 1e-4)")
        check(got.shape == want.shape and err <= 1e-4, f"{label} card vs CPU: {err}")


def same_state(label: str, trainers: list) -> None:
    """The two trainers hold equal parameters bit for bit: every tensor of the models' state,
    the optimizers' float32 masters and moments, and the losses' parameters."""
    a, b = (t.model.state_dict() for t in trainers)
    check(a.keys() == b.keys(), f"{label}: the two models' state dicts differ in keys")
    for key in a:
        check(torch.equal(a[key], b[key]), f"{label}: {key} differs between the two")
    x, y = (t.optimizer for t in trainers)
    moments = (lambda o: o.state if o.name == "sgd" else [*o.state[0], *o.state[1]])
    for u, v in zip([*x.master, *moments(x)], [*y.master, *moments(y)], strict=True):
        check(torch.equal(u, v), f"{label}: the optimizer's master or moments differ")
    for name, p in getattr(trainers[0], "loss_params", {}).items():
        check(torch.equal(p, trainers[1].loss_params[name]), f"{label}: loss parameter {name}")


@contextlib.contextmanager
def deterministic_cudnn():
    """cuDNN's deterministic algorithms inside: two no-mesh fits of phase 7's model differ
    after their first step with cuDNN's default choices (on the H100: the conv layers' weight
    gradients), so the arms that phase 22 compares bit for bit both run these; the port's
    kernels use no atomics."""
    was = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = was


def mesh_cinc_fit(card: str, mesh) -> list:
    """Phase 22 (a): phase 7's K4 route (full-width bf16 wav2vec2-base, B = 96, SGD), one
    epoch of 4 steps and a validation epoch, without a mesh and through the world-1 mesh,
    from one seed, both on cuDNN's deterministic algorithms: the losses and every parameter
    equal bit for bit, the mesh's exact launches; then the step's wall time of both on
    cuDNN's default algorithms, as phase 7 runs (in turns). Returns the mesh trainer's
    trained parameters (the all-reduce's buffer, part (e))."""
    from wav2vec_heart_sounds_tpu_torch.data.fragments import FragmentDataset
    from wav2vec_heart_sounds_tpu_torch.data.loader import Batcher
    from wav2vec_heart_sounds_tpu_torch.experiments.cinc import _device_prep
    from wav2vec_heart_sounds_tpu_torch.experiments.common import make_loader
    from wav2vec_heart_sounds_tpu_torch.models.build import build_classifier
    from wav2vec_heart_sounds_tpu_torch.train.classifier import SupervisedTrainer

    win_len = int(WINDOW_S * FS)
    train_frags = synthetic_recordings(1, TRAIN_PATIENTS, TRAIN_WINDOWS)
    valid_frags = synthetic_recordings(2)
    trainers, losses, batchers = [], [], []
    for arm in (None, mesh):
        model = build_classifier(classifier_config(), seed=0, device="cuda",
                                 dtype=torch.bfloat16, train=True)
        trainer = SupervisedTrainer(model, optimizer_name="sgd", lr=1e-3, mesh=arm,
                                    device_preprocess=_device_prep(FS_WIRE, FS, win_len, "cuda"),
                                    log=lambda line: print(f"[mesh] fit: {line}"))
        train = make_loader(FragmentDataset(train_frags, fs=FS_WIRE), TRAIN_BATCH, train=True)
        valid = Batcher(FragmentDataset(valid_frags, fs=FS_WIRE), TRAIN_BATCH, train=False)
        recorded, step = [], trainer._train_step
        trainer._train_step = functools.partial(step_and_keep, step, recorded)
        torch.cuda.synchronize()
        reset_counts()
        with deterministic_cudnn():
            best = trainer.fit(train, valid, 1)
            torch.cuda.synchronize()
        got = counts()
        trainer._train_step = step
        values = [float(v) for v in recorded]
        steps, valid_batches = len(train), len(valid)
        check(len(values) == steps and all(np.isfinite(values)), f"mesh fit losses {values}")
        if arm is not None:
            check_launches("mesh fit", got, steps, valid_batches, PER_STEP, EVAL_PER_BATCH)
            print(f"[mesh] fit through the world-1 NCCL mesh ({mesh.device}): {steps} steps of "
                  f"B={TRAIN_BATCH} + {valid_batches} valid batches, losses "
                  f"{', '.join(f'{v:.7f}' for v in values)}, best valid MCC {best:.4f}; "
                  f"launches {json.dumps({k: v for k, v in got.items() if v})} (per step "
                  + per_step_text({k: v for k, v in PER_STEP.items() if any(v)})
                  + f"; per valid batch attention_qkv_fwd 12)")
        trainers.append(trainer)
        losses.append(values)
        batchers.append(train)
    check(losses[0] == losses[1], f"mesh fit losses {losses[1]} != no-mesh {losses[0]}")
    same_state("mesh fit", trainers)
    runs = {0: [], 1: []}
    for arm in (0, 1, 1, 0):                                             # in turns
        runs[arm].append(timed_epoch(trainers[arm], batchers[arm]))
    steps = len(batchers[0])
    ms = {arm: [1e3 * s / steps for s in runs[arm]] for arm in runs}
    print(f"[mesh] losses and all {len(trainers[0].model.state_dict())} state tensors, the "
          f"float32 master and momentum equal bit for bit with no mesh (cuDNN's deterministic "
          f"algorithms); step wall time on its default ones "
          f"through the mesh {np.median(ms[1]):.1f} ms ({', '.join(f'{v:.1f}' for v in ms[1])}) "
          f"against {np.median(ms[0]):.1f} ms without ({', '.join(f'{v:.1f}' for v in ms[0])}; "
          f"phase 7's K4 route, B={TRAIN_BATCH}, host clock, epochs of {steps} steps) on {card}")
    return trainers[1].optimizer.params


def step_and_keep(step, recorded: list, *args):
    loss, preds = step(*args)
    recorded.append(loss)
    return loss, preds


def mesh_vest_step(mesh) -> None:
    """Phase 22 (b): one vest step (bench.py's vest config: 6 microphones, LoRA under the
    freeze mask, bf16, AdamW at 1e-4, B = 16) with the contrastive-focal loss, without a mesh
    and through the mesh (cuDNN's deterministic algorithms): the loss, the parameters, the master, the moments and the class
    centres equal bit for bit; the mesh's step launches K6 and K7 (its exact counts)."""
    from wav2vec_heart_sounds_tpu_torch.data.fragments import FragmentDataset
    from wav2vec_heart_sounds_tpu_torch.data.loader import Batcher
    from wav2vec_heart_sounds_tpu_torch.models.build import build_classifier
    from wav2vec_heart_sounds_tpu_torch.train.classifier import SupervisedTrainer
    from wav2vec_heart_sounds_tpu_torch.train.losses import ContrastiveFocalConfig

    cfg = vest_config()
    batch = next(iter(Batcher(FragmentDataset(vest_fragments(VEST_BATCH, 3), fs=VEST_FS),
                              VEST_BATCH, train=False)))
    trainers, losses = [], []
    for arm in (None, mesh):
        model = build_classifier(cfg, seed=0, device="cuda", dtype=torch.bfloat16, train=True)
        trainer = SupervisedTrainer(model, optimizer_name="adamw", lr=1e-4,
                                    classifier_config=cfg, mesh=arm, log=lambda line: None,
                                    criterion=ContrastiveFocalConfig(num_classes=2,
                                                                     feature_dim=HIDDEN))
        recorded, step = [], trainer._train_step
        trainer._train_step = functools.partial(step_and_keep, step, recorded)
        torch.cuda.synchronize()
        reset_counts()
        with deterministic_cudnn():
            trainer.fit([batch], None, 1)
            torch.cuda.synchronize()
        got = counts()
        trainer._train_step = step
        trainers.append(trainer)
        losses.append([float(v) for v in recorded])
    check_launches("mesh vest step", got, 1, 0, PER_STEP_VEST, {})
    check(losses[0] == losses[1] and len(losses[1]) == 1 and np.isfinite(losses[1][0]),
          f"mesh vest loss {losses[1]} != no-mesh {losses[0]}")
    same_state("mesh vest step", trainers)
    print(f"[mesh] vest step through the mesh (B={VEST_BATCH}, contrastive-focal, LoRA): loss "
          f"{losses[1][0]:.7f}, parameters, master, moments and centres equal bit for bit with "
          f"no mesh; launches " + json.dumps({k: v for k, v in got.items() if v}))


def mesh_diffwave_step(mesh) -> None:
    """Phase 22 (c): one ``GenerativeTrainer.train_step`` of the full-width DiffWave (float32,
    B = 16, 80 frames, its own draws from the trainer's card generator) without a mesh and
    through the mesh (cuDNN's deterministic algorithms): the loss, the parameters and Adam's moments equal bit for bit, no port
    kernel launched."""
    from wav2vec_heart_sounds_tpu_torch.train.generative import GenerativeTrainer, diffwave_loss

    weights = seeded_vocoder("diffwave").state_dict()
    batch = vocoder_inputs("diffwave", 16, 80, seed=5)
    trainers, losses = [], []
    for arm in (None, mesh):
        model = seeded_vocoder("diffwave")
        model.load_state_dict(weights)
        model.to("cuda")
        with tempfile.TemporaryDirectory() as tmp:
            trainer = GenerativeTrainer(model, diffwave_loss, tmp, mesh=arm, seed=7,
                                        log=lambda line: None)
            reset_counts()
            with deterministic_cudnn():
                losses.append(trainer.train_step(batch))
                torch.cuda.synchronize()
        check(not any(counts().values()), "DiffWave launched a port kernel")
        trainers.append(trainer)
    check(losses[0] == losses[1] and np.isfinite(losses[1]),
          f"mesh DiffWave loss {losses[1]} != no-mesh {losses[0]}")
    same_state("mesh DiffWave step", trainers)
    print(f"[mesh] DiffWave train_step through the mesh (B=16, 80 frames, float32): loss "
          f"{losses[1]:.7f}, parameters and Adam's moments equal bit for bit with no mesh")


def mesh_runner(mesh, tmp: Path) -> None:
    """Phase 22 (d): ``experiments.cinc.run(mesh=...)`` on phase 8's synthetic CinC layout
    (raw wire, augmentation on the card, full width, bf16, two steps): one record, finite
    statistics, the exact launches."""
    from wav2vec_heart_sounds_tpu_torch.experiments import cinc as runner

    directory = tmp / "mesh_cinc"
    directory.mkdir()
    csv = synthetic_cinc(directory)
    results = directory / "results.json"
    with counted_runner(runner) as (losses, evals):
        reset_counts()
        record = runner.run(str(directory), csv, mode="pcg", fs=FS, window_s=WINDOW_S, epochs=1,
                            augment=True, random_init=True, batch_size=4, max_batches=2,
                            results_json=str(results), fs_wire=FS_WIRE, wire="raw", mesh=mesh)
        torch.cuda.synchronize()
        got = counts()
    values = [float(v) for v in losses]
    stats = [v for level in ("fragment", "patient") for v in record[level].values()]
    check(len(values) == 2 and all(np.isfinite(values)), f"mesh runner losses {values}")
    check(all(np.isfinite(v) for v in stats), "mesh runner statistics not finite")
    check(json.loads(results.read_text()) == [record], "the mesh runner's record is missing")
    check_launches("mesh runner", got, len(values), evals[0], PER_STEP, EVAL_PER_BATCH)
    print(f"[mesh] experiments.cinc.run(mesh=...), raw wire: losses "
          f"{', '.join(f'{v:.5f}' for v in values)}, {evals[0]} eval batches, one record: "
          f"fragment {json.dumps(record['fragment'])}; patient {json.dumps(record['patient'])}")


def mesh_all_reduce(card: str, mesh, params: list) -> None:
    """Phase 22 (e): the gradient all-reduce of the CinC step alone: NCCL's all-reduce of the
    flat float32 buffer (one float32 per trained parameter), and the optimizer's whole mean
    all-reduce (gather into the buffer, all-reduce, divide, scatter back), by device time."""
    import torch.distributed as dist

    from wav2vec_heart_sounds_tpu_torch.parallel.mesh import all_reduce_mean

    grads = [torch.randn(p.shape, device="cuda") for p in params]
    flat = torch.cat([g.reshape(-1) for g in grads])
    nbytes = flat.numel() * flat.element_size()
    alone = device_ms(lambda: dist.all_reduce(flat))
    whole = device_ms(lambda: all_reduce_mean(grads, mesh))
    bound = 2 * nbytes / HBM_BYTES_PER_S * 1e3
    print(f"[mesh] gradient all-reduce of the CinC step: {len(params)} tensors, "
          f"{flat.numel()} float32 = {nbytes} bytes; NCCL all_reduce alone {alone:.4f} ms "
          f"device time, the optimizer's mean all-reduce (concatenate, all-reduce, divide, copy "
          f"back) {whole:.4f} ms (one read and one write of the buffer at the HBM rate: "
          f"{bound:.4f} ms); world size {mesh.world_size}, so nothing crosses NVLink; on {card}")


def phase_mesh(card: str, tmp: Path) -> None:
    """Phase 22: data parallelism through a world-1 NCCL group (``file://`` store), the
    mesh from ``parallel.data_parallel_mesh()``: (a) the CinC ``fit``, (b) a vest step, (c) a
    DiffWave step, each bit for bit with the same run without a mesh, (d) the CinC runner
    under the mesh, (e) the gradient all-reduce's device time."""
    import torch.distributed as dist

    from wav2vec_heart_sounds_tpu_torch.parallel import data_parallel_mesh

    dist.init_process_group("nccl", init_method=f"file://{tmp}/mesh_store", rank=0,
                            world_size=1, device_id=torch.device("cuda", 0))
    try:
        mesh = data_parallel_mesh()
        check(mesh.world_size == 1 and mesh.device == torch.device("cuda", 0)
              and dist.get_backend() == "nccl", f"the mesh: {mesh}, {dist.get_backend()}")
        params = mesh_cinc_fit(card, mesh)
        mesh_vest_step(mesh)
        mesh_diffwave_step(mesh)
        mesh_runner(mesh, tmp)
        mesh_all_reduce(card, mesh, params)
    finally:
        dist.destroy_process_group()


# Phase 23: the pretrained-encoder path. facebook/wav2vec2-large-960h's architecture (its
# config.json: the base conv stack and positional conv, group-norm feature extractor,
# post-norm, no conv bias), and the remat arms that train it.
LARGE_960H = {"hidden_size": 1024, "num_hidden_layers": 24, "num_attention_heads": 16,
              "intermediate_size": 4096}
BASE_960H = {"architectures": ["Wav2Vec2ForCTC"], "model_type": "wav2vec2", "vocab_size": 32,
             "hidden_size": 768, "num_hidden_layers": 12, "num_attention_heads": 12,
             "intermediate_size": 3072, "feat_extract_norm": "group", "do_stable_layer_norm": False,
             "conv_bias": False, "feat_proj_dropout": 0.1, "hidden_act": "gelu"}
REMAT_ARMS = (("no remat", {}), ("remat", {"remat": True}),
              ("remat + remat_conv", {"remat": True, "remat_conv": True}))
REMAT_STEPS = 3
POS_CONV = "encoder.pos_conv_embed.conv."


def remat_per_step(layers: int, remat: bool) -> dict:
    """Launches (forward, backward) of one K4-route training step of ``layers`` layers; under
    ``remat`` the backward runs each layer's forward kernels (K2, K3b, K4) once more."""
    again = layers if remat else 0
    return {"dropout": (2, 2), "resid_fwd": (layers, again), "resid_bwd": (0, layers),
            "attention_qkv_fwd": (layers, again), "attention_qkv_bwd": (0, layers),
            "ffn_mega_fwd": (layers, again), "ffn_mega_bwd": (0, layers),
            "pos_conv_fwd": (1, 0), "pos_conv_bwd": (0, 1)}


def write_safetensors(path: Path, tensors: dict) -> None:
    """``tensors`` as a ``.safetensors`` file, without the safetensors package: the header's
    length as 8 little-endian bytes, the JSON header (``dtype``, ``shape``, ``data_offsets``
    into the data; padded with spaces to 8 bytes), then each tensor's bytes in order."""
    codes = {torch.float32: "F32", torch.float16: "F16", torch.bfloat16: "BF16"}
    header, offset = {"__metadata__": {"format": "pt"}}, 0
    for key, t in tensors.items():
        n = t.numel() * t.element_size()
        header[key] = {"dtype": codes[t.dtype], "shape": list(t.shape),
                       "data_offsets": [offset, offset + n]}
        offset += n
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * (-len(blob) % 8)
    with open(path, "wb") as fh:
        fh.write(len(blob).to_bytes(8, "little"))
        fh.write(blob)
        for t in tensors.values():
            fh.write(t.detach().cpu().contiguous().reshape(-1).view(torch.uint8).numpy().data)


def synthetic_hf_state(hf_config: dict, seed: int, legacy: bool) -> dict:
    """A seeded float32 ``Wav2Vec2Model`` state dict in HF's keys (the port's parameter names
    are HF's) for ``hf_config``: the port's init from ``seed``, and the positional conv as
    weight norm's g (uniform in [0.5, 1.5)) and v, under the legacy ``weight_g``/``weight_v``
    keys or the ``parametrizations`` ones."""
    from wav2vec_heart_sounds_tpu_torch.models.hf_port import config_from_hf
    from wav2vec_heart_sounds_tpu_torch.models.wav2vec2 import Wav2Vec2Model, init_parameters

    with torch.device("meta"):
        model = Wav2Vec2Model(config_from_hf(hf_config))
    model.to_empty(device="cpu")
    init_parameters(model, torch.Generator().manual_seed(seed))
    sd = {k: v.detach() for k, v in model.state_dict().items()}
    v = sd.pop(POS_CONV + "weight")
    g = 0.5 + torch.rand((1, 1, v.shape[2]), generator=torch.Generator().manual_seed(seed + 1))
    names = (("weight_g", "weight_v") if legacy
             else ("parametrizations.weight.original0", "parametrizations.weight.original1"))
    sd[POS_CONV + names[0]], sd[POS_CONV + names[1]] = g, v
    return sd


def encoder_holds(label: str, state: dict, hf_state: dict) -> None:
    """Every tensor of an encoder's ``state`` is the checkpoint's (rounded to the parameter's dtype), the
    positional conv ``g * v / ||v||`` in float64 (norm over dims 0 and 1)."""
    want = {k: v for k, v in hf_state.items() if not k.startswith(POS_CONV)}
    keys = [k for k in hf_state if k.startswith(POS_CONV)]
    g = next(hf_state[k] for k in keys if k.endswith(("weight_g", "original0"))).double()
    v = next(hf_state[k] for k in keys if k.endswith(("weight_v", "original1"))).double()
    norm = v.pow(2).sum(dim=(0, 1), keepdim=True).sqrt()
    want[POS_CONV + "weight"] = (g * v / norm.clamp_min(1e-12)).float()
    want[POS_CONV + "bias"] = hf_state[POS_CONV + "bias"]
    check(set(state) == set(want), f"{label}: encoder keys {set(state) ^ set(want)}")
    for key, value in want.items():
        check(torch.equal(state[key], value.to(state[key].device, state[key].dtype)),
              f"{label}: the encoder's {key} is not the checkpoint's")


def pretrained_runner(tmp: Path, card: str) -> None:
    """Phase 23 (a): the default mode (``random_init`` False) of ``experiments.cinc.run`` on
    phase 8's synthetic CinC directory (raw wire), its checkpoint a seeded wav2vec2-base
    ``Wav2Vec2ForCTC`` in the real ``-960h`` layout (``wav2vec2.`` prefix, legacy weight norm
    keys, an ``lm_head``; ``pytorch_model.bin`` and HF's base ``config.json``) found by name
    in a hub cache (``HF_HUB_CACHE``, ``refs/main``, ``snapshots/<rev>``)."""
    from wav2vec_heart_sounds_tpu_torch.experiments import cinc as runner

    hf_state = synthetic_hf_state(BASE_960H, seed=11, legacy=True)
    gen = torch.Generator().manual_seed(12)
    ctc = {"wav2vec2." + k: v for k, v in hf_state.items()}
    width, vocab = BASE_960H["hidden_size"], BASE_960H["vocab_size"]
    ctc["lm_head.weight"] = torch.randn(vocab, width, generator=gen) / width ** 0.5
    ctc["lm_head.bias"] = torch.zeros(vocab)
    repo = tmp / "hub" / "models--facebook--wav2vec2-base-960h"
    snapshot = repo / "snapshots" / "synthetic0"
    snapshot.mkdir(parents=True)
    (repo / "refs").mkdir()
    (repo / "refs" / "main").write_text("synthetic0")
    (snapshot / "config.json").write_text(json.dumps(BASE_960H))
    torch.save(ctc, snapshot / "pytorch_model.bin")
    built, build = [], runner.build_classifier

    def recording_build(cfg, *args, **kwargs):
        check(not cfg.random_init and cfg.pretrained_name == "facebook/wav2vec2-base-960h",
              f"the runner's branch config: {cfg}")
        model = build(cfg, *args, **kwargs)
        built.append({k: v.detach().clone() for k, v in model.encoder.state_dict().items()})
        return model

    results = tmp / "pretrained-results.json"
    with mock.patch.dict("os.environ", {"HF_HUB_CACHE": str(tmp / "hub")}), \
            mock.patch.object(runner, "build_classifier", recording_build), \
            counted_runner(runner) as (losses, evals):
        reset_counts()
        t0 = time.perf_counter()
        record = runner.run(str(tmp / "cinc"), str(tmp / "cinc" / "split.csv"), mode="pcg",
                            fs=FS, window_s=WINDOW_S, epochs=1, augment=True, batch_size=4,
                            max_batches=2, results_json=str(results), wire="raw",
                            fs_wire=FS_WIRE)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    got = counts()
    values = [float(v) for v in losses]
    check(len(built) == 1, f"the runner built {len(built)} classifiers")
    encoder_holds("pretrained runner", built[0], hf_state)
    stats = [v for level in ("fragment", "patient") for v in record[level].values()]
    print(f"[pretrained] experiments.cinc.run default mode (random_init False), raw wire: "
          f"{seconds:.1f} s; the encoder built from the hub-cache checkpoint holds its "
          f"{len(built[0])} tensors; {len(values)} train steps, {evals[0]} validation/test "
          f"batches; losses {', '.join(f'{v:.5f}' for v in values)}; fragment "
          f"{json.dumps(record['fragment'])}; launches "
          f"{json.dumps({k: v for k, v in got.items() if v})}; on {card}")
    check(record["random_init"] is False, f"the record: {record}")
    check(len(values) == 2 and all(np.isfinite(values)), f"pretrained runner losses {values}")
    check(all(np.isfinite(v) for v in stats), "pretrained runner statistics not finite")
    check_launches("pretrained runner", got, len(values), evals[0], PER_STEP, EVAL_PER_BATCH)


def large_checkpoint(tmp: Path) -> tuple[Path, dict]:
    """Phase 23 (b)'s checkpoint: a seeded ``Wav2Vec2Model`` of wav2vec2-large-960h's
    architecture as ``model.safetensors`` (``parametrizations`` weight norm keys) and its
    ``config.json`` in a directory."""
    directory = tmp / "wav2vec2-large"
    directory.mkdir()
    config = {**BASE_960H, **LARGE_960H}
    hf_state = synthetic_hf_state(config, seed=21, legacy=False)
    (directory / "config.json").write_text(json.dumps(config))
    write_safetensors(directory / "model.safetensors", hf_state)
    return directory, hf_state


def stepped_epoch(trainer, loader, steps: int, deterministic: bool) -> dict:
    """``steps`` ``SupervisedTrainer`` steps of ``loader`` (on cuDNN's deterministic algorithms
    or its defaults): each step's ms (host clock, synchronised around it) and loss, the
    launches, and the peak device memory, in all and above what was allocated before."""
    step, ms, losses = trainer._train_step, [], []

    def timed_step(*args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, preds = step(*args)
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
        losses.append(float(loss))
        return loss, preds

    trainer._train_step = timed_step
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    reset_counts()
    try:
        with deterministic_cudnn() if deterministic else contextlib.nullcontext():
            trainer._run_epoch(loader, True, steps)
            torch.cuda.synchronize()
    finally:
        trainer._train_step = step
    peak = torch.cuda.max_memory_allocated()
    return {"ms": ms, "losses": losses, "launches": counts(), "peak": peak / 2 ** 30,
            "above": (peak - before) / 2 ** 30}


def remat_arms(label: str, card: str, build) -> None:
    """Phase 23 (c): ``build(fields)`` once per arm of ``REMAT_ARMS`` (the same seed and
    state), ``REMAT_STEPS`` ``SupervisedTrainer`` steps each (phase 7's B = 96 raw 4 s windows,
    bf16, K4 route, SGD at 1e-3; cuDNN's deterministic algorithms) in turns, then again in
    the other order: losses, the last step's gradients and the trainers' states equal bit for
    bit, each arm's exact launches; the median step ms (host clock, synchronised around each
    step) and the peak device memory above what was allocated before its steps. Then the
    arm without remat once more on cuDNN's default algorithms, as phase 7 trains."""
    from wav2vec_heart_sounds_tpu_torch.data.fragments import FragmentDataset
    from wav2vec_heart_sounds_tpu_torch.experiments.cinc import _device_prep
    from wav2vec_heart_sounds_tpu_torch.experiments.common import make_loader
    from wav2vec_heart_sounds_tpu_torch.train.classifier import SupervisedTrainer

    frags = synthetic_recordings(1, TRAIN_PATIENTS, TRAIN_WINDOWS)
    prep = _device_prep(FS_WIRE, FS, int(WINDOW_S * FS), "cuda")
    arms = {}
    for name, fields in REMAT_ARMS:
        trainer = SupervisedTrainer(build(fields), optimizer_name="sgd", lr=1e-3,
                                    device_preprocess=prep, log=lambda line: None)
        arms[name] = {"trainer": trainer, "remat": bool(fields), "runs": [],
                      "loader": make_loader(FragmentDataset(frags, fs=FS_WIRE), TRAIN_BATCH,
                                            train=True)}
    order = [name for name, _ in REMAT_ARMS]
    layers = arms[order[0]]["trainer"].model.encoder.config.num_layers
    for rnd, names in enumerate((order, order[::-1])):
        for name in names:
            arm = arms[name]
            run = stepped_epoch(arm["trainer"], arm["loader"], REMAT_STEPS, True)
            arm["runs"].append(run)
            check(len(run["losses"]) == REMAT_STEPS and all(np.isfinite(run["losses"])),
                  f"{label} {name} losses {run['losses']}")
            check_launches(f"{label} {name}", run["launches"], REMAT_STEPS, 0,
                           remat_per_step(layers, arm["remat"]), {})
        first = arms[order[0]]
        for name in order[1:]:
            check(arms[name]["runs"][rnd]["losses"] == first["runs"][rnd]["losses"],
                  f"{label} {name} losses {arms[name]['runs'][rnd]['losses']} != "
                  f"{first['runs'][rnd]['losses']}")
            a, b = first["trainer"].model, arms[name]["trainer"].model
            for (key, p), q in zip(a.named_parameters(), b.parameters(), strict=True):
                check(p.grad is not None and torch.equal(p.grad, q.grad),
                      f"{label} {name}: the gradient of {key} differs")
            same_state(f"{label} {name}", [first["trainer"], arms[name]["trainer"]])
    for name in order:
        runs = arms[name]["runs"]
        ms = [v for run in runs for v in run["ms"]]
        peak, above = (", ".join(f"{run[key]:.2f}" for run in runs) for key in ("peak", "above"))
        print(f"[pretrained] {label} {name}: median step {np.median(ms):.1f} ms "
              f"({', '.join(f'{v:.1f}' for v in ms)}; B={TRAIN_BATCH}, bf16, K4 route, "
              f"SGD, deterministic cuDNN, host clock synchronised around each step); peak device "
              f"memory {peak} GiB, above the {len(arms)} trainers' state {above} GiB; losses {runs[0]['losses']}; launches in {REMAT_STEPS} steps "
              f"{json.dumps({k: v for k, v in runs[0]['launches'].items() if v})}; on {card}")
    print(f"[pretrained] {label}: losses, the last step's gradients, the parameters, the "
          f"float32 master and momentum equal bit for bit across the {len(arms)} arms after "
          f"each of 2 rounds of {REMAT_STEPS} steps")
    first = arms[order[0]]
    run = stepped_epoch(first["trainer"], first["loader"], REMAT_STEPS, False)
    check(all(np.isfinite(run["losses"])), f"{label} losses {run['losses']}")
    deterministic = [v for r in first["runs"] for v in r["ms"]]
    print(f"[pretrained] {label} {order[0]} on cuDNN's default algorithms: median step "
          f"{np.median(run['ms']):.1f} ms ({', '.join(f'{v:.1f}' for v in run['ms'])}) against "
          f"{np.median(deterministic):.1f} ms on its deterministic ones just before; peak "
          f"{run['peak']:.2f} GiB; on {card}")


def phase_pretrained(card: str, tmp: Path) -> None:
    """Phase 23: the pretrained-encoder path. (a) :func:`pretrained_runner`; (b) a seeded
    checkpoint of wav2vec2-large-960h's architecture (24 x 1024, 16 heads, FFN 4096) written
    as ``model.safetensors`` and built by ``build_classifier(random_init=False)`` from a
    caller's config holding the default wav2vec2-base encoder: 24 x 1024 with the checkpoint's
    tensors; (c) :func:`remat_arms` on that model and on phase 7's wav2vec2-base."""
    from dataclasses import replace

    from wav2vec_heart_sounds_tpu_torch.models.build import build_classifier
    from wav2vec_heart_sounds_tpu_torch.models.classifier import ClassifierConfig
    from wav2vec_heart_sounds_tpu_torch.models.hf_port import ARCHITECTURE, config_from_hf

    pretrained_runner(tmp, card)
    t0 = time.perf_counter()
    directory, hf_state = large_checkpoint(tmp)
    written = time.perf_counter() - t0
    caller = ClassifierConfig(num_classes=2, fs=FS, pretrained_name=str(directory))
    large = config_from_hf({**BASE_960H, **LARGE_960H})
    check(caller.encoder.hidden_size == HIDDEN and not caller.random_init
          and caller.encoder.hidden_size != large.hidden_size, f"{caller}")

    def build_large(fields):
        cfg = replace(caller, encoder=replace(caller.encoder, **fields))
        return build_classifier(cfg, seed=0, device="cuda", dtype=torch.bfloat16, train=True)

    t0 = time.perf_counter()
    model = build_large({})
    built = time.perf_counter() - t0
    enc = model.encoder.config
    params = sum(p.numel() for p in model.encoder.parameters())
    check(all(getattr(enc, f) == getattr(large, f) for f in ARCHITECTURE),
          f"the large encoder's config: {enc}")
    encoder_holds("large checkpoint", model.encoder.state_dict(), hf_state)
    size = (directory / "model.safetensors").stat().st_size
    print(f"[pretrained] wav2vec2-large-960h architecture: {params} encoder parameters, "
          f"model.safetensors {size} bytes written in {written:.1f} s; build_classifier "
          f"(random_init False, the caller's encoder wav2vec2-base) built "
          f"{enc.num_layers} x {enc.hidden_size} ({enc.num_heads} heads, FFN "
          f"{enc.intermediate_size}) holding the checkpoint's tensors in {built:.1f} s")
    del model
    remat_arms("wav2vec2-large", card, build_large)
    torch.cuda.empty_cache()
    remat_arms("wav2vec2-base", card,
               lambda fields: build_classifier(classifier_config(**fields), seed=0,
                                               device="cuda", dtype=torch.bfloat16, train=True))


# Phase 24: the port's bench (``wav2vec_heart_sounds_tpu_torch/bench.py``), every mode at
# bench.py's sizes with short timed windows: (label, mode function and its arguments, the
# JSON keys bench.py prints, launches a train step, launches an eval batch). The steps a run
# does are its warm-up and its timed ones: 3 + 3 for run_bench's modes, fusion's default warm
# 3 and the vest's 2 before their 3.
BENCH_STEPS = 3
BENCH_E2E_KEYS = {"metric", "value", "unit", "vs_baseline", "mode", "batch_size", "steps",
                  "backend", "final_fetch"}
BENCH_PORT_KEYS = {"card", "torch", "cuda", "cudnn", "world_size", "cudnn_deterministic",
                   "cudnn_benchmark"}
BENCH_MODES = (
    ("train", "run_bench", {"mode": "train"}, BENCH_E2E_KEYS, 6, PER_STEP, {}),
    ("infer", "run_bench", {"mode": "infer"}, BENCH_E2E_KEYS, 6, {}, EVAL_PER_BATCH),
    ("preproc", "run_bench", {"mode": "preproc"}, BENCH_E2E_KEYS, 6, {}, {}),
    ("real (raw wire)", "run_bench", {"mode": "real"}, BENCH_E2E_KEYS | {"wire"}, 6, PER_STEP,
     {}),
    ("real (16k wire)", "run_bench", {"mode": "real", "wire": "16k"},
     BENCH_E2E_KEYS | {"wire"}, 6, PER_STEP, {}),
    ("vest", "run_vest_bench", {}, BENCH_E2E_KEYS - {"mode"} | {"device_augment", "channels"},
     5, PER_STEP_VEST, {}),
    ("vest (augmentation on the card)", "run_vest_bench", {"device_augment": True},
     BENCH_E2E_KEYS - {"mode"} | {"device_augment", "channels"}, 5, PER_STEP_VEST, {}),
    ("fusion", "run_fusion_bench", {}, BENCH_E2E_KEYS - {"mode"}, 6, PER_STEP_FUSION, {}),
    ("gen", "run_gen_bench", {}, {"metric", "value", "unit", "vs_baseline", "batch_size",
                                  "backend"}, 0, {}, {}),
    ("gen-wavegrad", "run_wavegrad_sample_bench", {},
     {"metric", "value", "unit", "vs_baseline", "num_steps", "batch_size", "backend"}, 0, {},
     {}),
    ("gen-train-diffwave", "run_gen_train_bench", {"which": "diffwave"},
     {"metric", "value", "unit", "vs_baseline", "batch_size", "steps", "backend"}, 0, {}, {}),
    ("gen-train-wavegrad", "run_gen_train_bench", {"which": "wavegrad"},
     {"metric", "value", "unit", "vs_baseline", "batch_size", "steps", "backend"}, 0, {}, {}),
)
# torch's own float32 settings, read before main() turns TF32 off for the phases that compare
# float32 at 1e-5: the bench runs on a user's process settings.
TORCH_TF32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)


@contextlib.contextmanager
def torch_defaults():
    """torch's default TF32 settings inside; this script's restored after."""
    was = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = TORCH_TF32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = was


def bench_line(label: str, line: dict, keys: set, card: str, world: int = 1) -> None:
    """A bench line: bench.py's keys, the port's, a finite positive value, this card, the
    world size, and cuDNN's default algorithm choice."""
    check(keys | BENCH_PORT_KEYS <= set(line), f"bench {label}: keys {sorted(line)}")
    check(np.isfinite(line["value"]) and line["value"] > 0, f"bench {label}: {line}")
    check(line["vs_baseline"] is None and line["backend"] == "cuda" and line["card"] == card
          and line["world_size"] == world and line["cudnn_deterministic"] is False
          and line["cudnn_benchmark"] is False, f"bench {label}: {line}")


def run_bench_cli(tmp: Path, mesh: bool) -> tuple[dict, float]:
    """``python -m wav2vec_heart_sounds_tpu_torch.cli bench --mode train --steps 3`` in a
    subprocess, or under a world-1 torchrun environment (``RANK``, ``WORLD_SIZE``,
    ``LOCAL_RANK``; the NCCL group formed on phase 22's ``file://`` store before the
    command runs, which must then take the mesh): its line and wall seconds."""
    import os

    argv = ["bench", "--mode", "train", "--steps", str(BENCH_STEPS)]
    env = dict(os.environ)
    if mesh:
        store = tmp / "bench_store"
        code = ("import torch, torch.distributed as dist\n"
                f"dist.init_process_group('nccl', init_method='file://{store}', rank=0, "
                "world_size=1, device_id=torch.device('cuda', 0))\n"
                "from wav2vec_heart_sounds_tpu_torch import bench, cli\n"
                "made, form = [], bench.data_parallel_mesh\n"
                "bench.data_parallel_mesh = lambda device: made.append(form(device)) or made[-1]\n"
                f"cli.main({argv!r})\n"
                "assert [m.world_size for m in made] == [1], made\n"
                "dist.destroy_process_group()\n")
        command = [sys.executable, "-c", code]
        env.update(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0")
    else:
        command = [sys.executable, "-m", "wav2vec_heart_sounds_tpu_torch.cli", *argv]
    t0 = time.perf_counter()
    proc = subprocess.run(command, cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=300)
    seconds = time.perf_counter() - t0
    check(proc.returncode == 0, f"bench CLI ({'mesh' if mesh else 'one card'}): "
                                f"{proc.stderr[-3000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1]), seconds


def phase_bench(card: str, tmp: Path) -> None:
    """Phase 24: ``wav2vec_heart_sounds_tpu_torch.bench``, the port of bench.py, on the card:
    every mode at bench.py's sizes with windows of 3 timed steps (calls), on torch's default
    TF32 settings and cuDNN's default algorithms (deterministic and benchmark off, asserted
    before): bench.py's keys, the port's, a finite positive value, each kernel's exact
    launches (none in preproc and the vocoder modes); then the CLI's ``bench`` in a
    subprocess, and again under a world-1 torchrun environment (``world_size`` 1)."""
    import gc

    from wav2vec_heart_sounds_tpu_torch import bench

    check(not torch.backends.cudnn.deterministic and not torch.backends.cudnn.benchmark,
          "cuDNN's default algorithm choice is off before the bench")
    with torch_defaults():
        for label, name, kwargs, keys, steps, per_step, per_eval in BENCH_MODES:
            t0 = time.perf_counter()
            reset_counts()
            line = getattr(bench, name)(steps=BENCH_STEPS, **kwargs)
            torch.cuda.synchronize()
            got = counts()
            bench_line(label, line, keys, card)
            check_launches(f"bench {label}", got, steps if per_step else 0,
                           steps if per_eval else 0, per_step, per_eval)
            launched = {k: v for k, v in got.items() if v}
            print(f"[bench] {label}: {line['value']} {line['unit']} ({line['metric']}, "
                  f"B={line['batch_size']}, {BENCH_STEPS} timed steps after the mode's "
                  f"warm-up; launches {json.dumps(launched) if launched else 'none'}; final "
                  f"fetch {line['final_fetch']}; {time.perf_counter() - t0:.1f} s of phase)")
            gc.collect()
            torch.cuda.empty_cache()
        for mesh in (False, True):
            line, seconds = run_bench_cli(tmp, mesh)
            bench_line("CLI", line, BENCH_E2E_KEYS, card)
            check(line["mode"] == "train" and line["steps"] == BENCH_STEPS
                  and line["batch_size"] == TRAIN_BATCH, f"bench CLI: {line}")
            print(f"[bench] python -m wav2vec_heart_sounds_tpu_torch.cli bench --mode train "
                  f"--steps {BENCH_STEPS}{' under a world-1 torchrun environment' if mesh else ''}: "
                  f"{line['value']} {line['unit']}, world size {line['world_size']}; "
                  f"{seconds:.1f} s of command")
    check(not torch.backends.cudnn.allow_tf32, "this script's TF32 setting restored")


def timed(phase, *args):
    """``phase(*args)``, printing its wall seconds."""
    t0 = time.perf_counter()
    out = phase(*args)
    print(f"[wall] {phase.__name__}: {time.perf_counter() - t0:.1f} s", flush=True)
    return out


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; this needs a CUDA card")
    sys.path.insert(0, str(ROOT))
    import wav2vec_heart_sounds_tpu_torch  # noqa: F401  (fail before printing without the port)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    card = smi.splitlines()[0]
    print(card)
    print(f"[device] python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False      # f32 phases compare at 1e-5 .. 2e-4
    torch.backends.cudnn.allow_tf32 = False

    start = time.perf_counter()
    kernel_wrappers()
    timed(phase_build)
    timed(phase_kernel_vs_plain)
    timed(phase_tiny)
    timed(phase_full_width)
    timed(phase_serving, card)
    measured = {**timed(phase_training_kernels), **timed(phase_megakernel)}
    timed(phase_train_step)
    launches = timed(phase_training, card)
    timed(phase_runner)
    measured.update(timed(phase_vest_kernels))
    input_grad_launches = timed(phase_vest_step)
    vest_launches = {**timed(phase_vest_training, card),
                     "sinc_delay_grad_x": input_grad_launches["sinc_delay_grad_x"]}
    timed(phase_vest_runner)
    measured.update(timed(phase_unpacked_attention))
    measured.update(timed(phase_conv_kernel))
    measured.update(timed(phase_pos_conv))
    timed(phase_gated_step)
    timed(phase_fusion_training, card)
    timed(phase_fusion_runner)
    timed(phase_vocoders, card)
    with tempfile.TemporaryDirectory() as tmp:
        generated = timed(phase_generative_pipeline, Path(tmp))
        timed(phase_synthetic_runner, Path(tmp), generated)
        timed(phase_cli, Path(tmp))
        timed(phase_mesh, card, Path(tmp))
        timed(phase_pretrained, card, Path(tmp))
        timed(phase_bench, card, Path(tmp))
    print(f"[wall] all phases: {time.perf_counter() - start:.1f} s")
    print(card)
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": CSRC + source,
         "replaces": PALLAS + replaces if replaces else None,
         "launches": (vest_launches if name in VEST_KERNELS else launches)[name],
         **measured[name]}
        for name, (source, replaces) in KERNELS.items()]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
