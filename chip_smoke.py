#!/usr/bin/env python3
"""GPU smoke run of the PyTorch port (``wav2vec_heart_sounds_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which exits non-zero on failure:

1. build every CUDA kernel from ``csrc/`` (into ``build/torch_kernels/``), one ``nvcc``
   per source, all started together;
2. the serving attention kernel against its plain PyTorch version on the card, at the
   serving shapes, with CUDA-event timings (median of 20);
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
   bit, every output and gradient at a stated tolerance, CUDA-event timings (median of 20);
6. one full-width float32 training step (B=8, dropout and SpecAugment on) from one state
   and one seed, the kernels against all-plain versions: loss and per-parameter gradient
   norms agree, and each kernel ran its exact count of launches in the forward and in the
   backward;
7. the training path: ``SupervisedTrainer.fit`` of a full-width bfloat16 classifier at B=96
   on seeded synthetic raw 2 kHz windows (int16 wire, preprocessing on the card), one
   epoch of 4 steps and a validation epoch: finite losses, exact launches per step, and
   training windows/s (host clock, median of 3 epochs).

Prints the card's name and power limit, one JSON line describing the kernels (launches
from phase 7's run), and as its last line ``{"ok": true, "device": {...}}``. Imports
nothing of JAX.
"""

from __future__ import annotations

import contextlib
import functools
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
CSRC = "wav2vec_heart_sounds_tpu_torch/csrc/"
PALLAS = "wav2vec_heart_sounds_tpu/ops/pallas/"
SOURCES = ("attention_qkv_fwd", "attention_qkv_bwd", "dropout", "resid", "ffn_act")

# Serving configuration: 4 s windows at 16 kHz (the CinC window) from a 2 kHz raw wire.
FS_WIRE, FS, WINDOW_S, BATCH = 2000, 16000, 4.0, 32
PATIENTS, WINDOWS_PER_PATIENT = 12, 9
# Training configuration (bench.py's train mode): B=96, the same windows, SGD at lr 1e-3.
TRAIN_BATCH, TRAIN_PATIENTS, TRAIN_WINDOWS, RATE = 96, 48, 8, 0.1
H, T, D, HIDDEN, FFN = 12, 199, 64, 768, 3072
ROWS = TRAIN_BATCH * T


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


def load_golden_module():
    path = ROOT / "tests" / "golden" / "fullsize_sd.py"
    spec = importlib.util.spec_from_file_location("fullsize_sd", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def phase_build() -> None:
    from wav2vec_heart_sounds_tpu_torch.ops.kernels import build

    t0 = time.perf_counter()
    build.load_libraries(*SOURCES)
    seconds = time.perf_counter() - t0
    print(f"[build] {len(SOURCES)} sources, one nvcc each in parallel: {seconds:.2f} s")
    for name in SOURCES:
        log = build.build_logs.get(name)
        print(f"[build] {name}: {'compiled' if log is not None else 'already built'}")
        for line in (log or "").splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build]   {line.strip()}")


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
    from wav2vec_heart_sounds_tpu_torch.models.classifier import ClassifierConfig
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

    cfg = ClassifierConfig(num_classes=2, head_hidden=(512, 512, 512), fs=FS)
    model = build_classifier(cfg, seed=0, device="cuda", dtype=torch.bfloat16)
    score(model, batcher, FS_WIRE, FS, win_len, max_batches=1)           # warm-up
    torch.cuda.synchronize()

    attention.attention_qkv_fwd.launches = 0
    t0 = time.perf_counter()
    result = score(model, batcher, FS_WIRE, FS, win_len)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = attention.attention_qkv_fwd.launches
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
          f"({cfg.encoder.num_layers} layers x {n_batches} batches)")
    print(f"[serve] fragment stats {json.dumps(result['fragment'])}")
    print(f"[serve] patient stats {json.dumps(result['patient'])}")
    check(logits.shape == (n_batches * BATCH, 2), f"logits shape {logits.shape}")
    check(bool(np.isfinite(logits).all()), "non-finite logits")
    check(launches == cfg.encoder.num_layers * n_batches,
          f"{launches} attention launches, expected {cfg.encoder.num_layers * n_batches}")

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
    from wav2vec_heart_sounds_tpu_torch.ops.kernels import attention, dropout, ffn, resid

    return {"attention_qkv_fwd": attention.attention_qkv_fwd,
            "attention_qkv_bwd": attention.attention_qkv_bwd,
            "dropout": dropout.dropout_kernel,
            "resid_fwd": resid.resid_fwd_kernel, "resid_bwd": resid.resid_bwd_kernel,
            "ffn_act_fwd": ffn.ffn_act_fwd_kernel, "ffn_act_bwd": ffn.ffn_act_bwd_kernel}


# name -> (source, the TPU kernel it replaces)
KERNELS = {
    "attention_qkv_fwd": ("attention_qkv_fwd.cu", "attention.py:343"),
    "attention_qkv_bwd": ("attention_qkv_bwd.cu", "attention.py:376"),
    "dropout": ("dropout.cu", "dropout.py:43"),
    "resid_fwd": ("resid.cu", "resid.py:114"),
    "resid_bwd": ("resid.cu", "resid.py:142"),
    "ffn_act_fwd": ("ffn_act.cu", "ffn.py:119"),
    "ffn_act_bwd": ("ffn_act.cu", "ffn.py:143"),
}


def reset_counts() -> None:
    for fn in kernel_wrappers().values():
        fn.launches = 0


def counts() -> dict:
    return {name: fn.launches for name, fn in kernel_wrappers().items()}


@contextlib.contextmanager
def plain_route():
    """Every kernel wrapper replaced by its plain version (same signature and contract)."""
    from wav2vec_heart_sounds_tpu_torch.ops.kernels import attention, dropout, ffn, resid

    pairs = [(attention, "attention_qkv_fwd", attention.attention_qkv_reference),
             (attention, "attention_qkv_bwd", attention.attention_qkv_bwd_reference),
             (dropout, "dropout_kernel", dropout.dropout_reference),
             (resid, "resid_fwd_kernel", resid.resid_fwd_reference),
             (resid, "resid_bwd_kernel", resid.resid_bwd_reference),
             (ffn, "ffn_act_fwd_kernel", ffn.ffn_act_fwd_reference),
             (ffn, "ffn_act_bwd_kernel", ffn.ffn_act_bwd_reference)]
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


def attention_masks(seed: int, site: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The keep masks [B, H, T, T] the attention kernels applied, decoded exactly (float32).

    With q = k = 0 every probability is 1/T. Forward: v_k = 2^(k div 64) e_(k mod 64), so
    out[q, j] * T / scale = sum_b keep[q, j + 64 b] 2^b, an integer below 16. Backward:
    do_q = 2^(q div 64) e_(q mod 64) decodes keep[j + 64 b, k] from dv[k, j] the same way.
    """
    from wav2vec_heart_sounds_tpu_torch.ops import philox
    from wav2vec_heart_sounds_tpu_torch.ops.kernels import attention

    B = TRAIN_BATCH
    pos = torch.arange(T, device="cuda")
    code_of_pos = (2.0 ** (pos // D)).float()
    qkv = torch.zeros(B, 3 * H, T, D, device="cuda")
    qkv[:, 2 * H:, pos, pos % D] = code_of_pos
    out, lse = attention.attention_qkv_fwd(qkv, T, RATE, seed, site, with_lse=True)
    dout = torch.zeros(B, H, T, D, device="cuda")
    dout[:, :, pos, pos % D] = code_of_pos
    dv = attention.attention_qkv_bwd(qkv, out, dout, lse, T, RATE, seed, site)[:, 2 * H:]
    scale = philox.keep_scale(RATE)

    def decode(a):                     # [B, H, rows, D] codes -> [B, H, rows, T] bits
        code = torch.round(a * T / scale).to(torch.int64)
        return torch.cat([((code >> b) & 1).bool()[..., :min(D, T - D * b)]
                          for b in range(-(-T // D))], dim=-1)

    return decode(out), decode(dv).transpose(2, 3)


def phase_training_kernels() -> dict:
    """Phase 5: every training kernel against its plain version at the training shapes.

    Returns the bfloat16 measurements by kernel name (ms, plain_ms, max_abs_err)."""
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
    fwd_mask, bwd_mask = attention_masks(seed, site)
    want = philox.keep_mask(seed, site, fwd_mask.shape, RATE, "cuda")
    identical("attention_qkv_fwd mask (decoded) vs plain", fwd_mask, want)
    identical("attention_qkv_bwd mask (decoded from dv) vs plain", bwd_mask, want)
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

        def timed(name, kernel, plain, err):
            ms, plain_ms = cuda_ms(kernel), cuda_ms(plain)
            print(f"[train-kernel] {name} {dt}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms "
                  f"(CUDA events, median of 20)")
            rec[name] = {"ms": ms, "plain_ms": plain_ms, "max_abs_err": err}

        # K1 dropout, [96*199, 768]
        x = randn(ROWS, HIDDEN)
        ones = torch.ones_like(x)
        identical(f"dropout mask {dt}", dropout.dropout_kernel(ones, seed, site, RATE),
                  dropout.dropout_reference(ones, seed, site, RATE))
        err = agree(f"dropout {dt} [{ROWS}, {HIDDEN}]", dropout.dropout_kernel(x, seed, site, RATE),
                    dropout.dropout_reference(x, seed, site, RATE), 0.0, 0.0)
        timed("dropout", lambda: dropout.dropout_kernel(x, seed, site, RATE),
              lambda: dropout.dropout_reference(x, seed, site, RATE), err)

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
        timed("resid_fwd", lambda: resid.resid_fwd_kernel(h, x, w, b, *args),
              lambda: resid.resid_fwd_reference(h, x, w, b, *args), err)
        got = resid.resid_bwd_kernel(g, s_p, w, *args)
        ref = resid.resid_bwd_reference(g, s_p, w, *args)
        err = max(agree(f"resid_bwd {name} {dt}", a, r, *tol) for name, a, r, tol in
                  zip(("dh", "dx", "dweight", "dbias"), got, ref, (grad, grad, colsum, colsum)))
        timed("resid_bwd", lambda: resid.resid_bwd_kernel(g, s_p, w, *args),
              lambda: resid.resid_bwd_reference(g, s_p, w, *args), err)
        del h, g, out_k, s_k, out_p, s_p, got, ref

        # K5 FFN activation, [96*199, 3072]
        pre, g = randn(ROWS, FFN), randn(ROWS, FFN)
        ten = torch.full_like(pre, 10.0)                     # gelu(10) = 10 in both forms
        args = (seed, site, RATE)
        identical(f"ffn_act mask {dt} (y of pre=10)", ffn.ffn_act_fwd_kernel(ten, *args),
                  ffn.ffn_act_fwd_reference(ten, *args))
        err = agree(f"ffn_act_fwd {dt} [{ROWS}, {FFN}]", ffn.ffn_act_fwd_kernel(pre, *args),
                    ffn.ffn_act_fwd_reference(pre, *args), *elem)
        timed("ffn_act_fwd", lambda: ffn.ffn_act_fwd_kernel(pre, *args),
              lambda: ffn.ffn_act_fwd_reference(pre, *args), err)
        got, ref = ffn.ffn_act_bwd_kernel(g, pre, *args), ffn.ffn_act_bwd_reference(g, pre, *args)
        err = max(agree(f"ffn_act_bwd dpre {dt}", got[0], ref[0], *grad),
                  agree(f"ffn_act_bwd dbias {dt}", got[1], ref[1], *colsum))
        timed("ffn_act_bwd", lambda: ffn.ffn_act_bwd_kernel(g, pre, *args),
              lambda: ffn.ffn_act_bwd_reference(g, pre, *args), err)
        del pre, g, ten, got, ref, x, ones

        # K3b attention with dropout, [96, 36, 199, 64], then at t = 150 keys
        qkv, dout = randn(TRAIN_BATCH, 3 * H, T, D), randn(TRAIN_BATCH, H, T, D)
        for t in (T, 150):
            args = (t, RATE, seed, site)
            out_k, lse_k = attention.attention_qkv_fwd(qkv, *args, with_lse=True)
            out_p, lse_p = attention.attention_qkv_reference(qkv, *args, with_lse=True)
            err_f = agree(f"attention_qkv_fwd out {dt} t={t}", out_k, out_p, *elem)
            agree(f"attention_qkv_fwd lse {dt} t={t}", lse_k, lse_p, 1e-5, 1e-5)
            err_b = agree(f"attention_qkv_bwd dqkv {dt} t={t}",
                          attention.attention_qkv_bwd(qkv, out_p, dout, lse_p, *args),
                          attention.attention_qkv_bwd_reference(qkv, out_p, dout, lse_p, *args),
                          *((2e-2, 2e-2) if bf16 else grad))
            if t == T:
                errs = (err_f, err_b)
        args = (T, RATE, seed, site)
        timed("attention_qkv_fwd",
              lambda: attention.attention_qkv_fwd(qkv, *args, with_lse=True),
              lambda: attention.attention_qkv_reference(qkv, *args, with_lse=True), errs[0])
        timed("attention_qkv_bwd",
              lambda: attention.attention_qkv_bwd(qkv, out_p, dout, lse_p, *args),
              lambda: attention.attention_qkv_bwd_reference(qkv, out_p, dout, lse_p, *args),
              errs[1])
        del qkv, dout, out_k, out_p, lse_k, lse_p
        torch.cuda.empty_cache()
        if bf16:
            records = rec
    return records


# Kernel launches of one training step of wav2vec2-base (12 layers): (forward, backward).
PER_STEP = {"dropout": (2, 2), "resid_fwd": (24, 0), "resid_bwd": (0, 24),
            "attention_qkv_fwd": (12, 0), "attention_qkv_bwd": (0, 12),
            "ffn_act_fwd": (12, 0), "ffn_act_bwd": (0, 12)}


def phase_train_step() -> None:
    """Phase 6: one full-width float32 training step, kernels against all-plain versions."""
    from wav2vec_heart_sounds_tpu_torch.models.build import build_classifier
    from wav2vec_heart_sounds_tpu_torch.models.classifier import ClassifierConfig
    from wav2vec_heart_sounds_tpu_torch.train.losses import cross_entropy

    B = 8
    cfg = ClassifierConfig(num_classes=2, head_hidden=(512, 512, 512), fs=FS)
    model = build_classifier(cfg, seed=0, device="cuda", dtype=torch.float32, train=True)
    gen = torch.Generator(device="cuda").manual_seed(3)
    x = 0.3 * torch.randn(B, int(WINDOW_S * FS), device="cuda", generator=gen)
    y = torch.arange(B, device="cuda") % 2

    def step(launch_check: bool):
        model.zero_grad(set_to_none=True)
        reset_counts()
        loss = cross_entropy(model(x, train=True, generator=torch.Generator().manual_seed(5)), y)
        fwd = counts()
        loss.backward()
        torch.cuda.synchronize()
        bwd = {k: v - fwd[k] for k, v in counts().items()}
        if launch_check:
            for name, (f, b) in PER_STEP.items():
                check(fwd[name] == f and bwd[name] == b,
                      f"{name}: {fwd[name]} + {bwd[name]} launches, expected {f} + {b}")
        else:
            check(not any(fwd.values()) and not any(bwd.values()), "plain route launched a kernel")
        return loss.detach().item(), {n: p.grad.norm().item() for n, p in model.named_parameters()}

    loss_k, norms_k = step(True)
    with plain_route():
        loss_p, norms_p = step(False)
    top = max(norms_p.values())
    worst = max(abs(norms_k[n] - norms_p[n]) / (norms_p[n] + 1e-6 * top) for n in norms_p)
    print(f"[train-step] wav2vec2-base f32 B={B}, dropout {RATE} and SpecAugment on: loss "
          f"kernels {loss_k:.7f} vs plain {loss_p:.7f}; {len(norms_p)} gradient norms, worst "
          f"relative difference {worst:.3e} (limit 1e-3); launches fwd+bwd "
          + ", ".join(f"{k} {f}+{b}" for k, (f, b) in PER_STEP.items()))
    check(abs(loss_k - loss_p) <= 1e-4 * max(1.0, abs(loss_p)), "training-step losses differ")
    check(worst <= 1e-3, f"gradient norms differ between kernel and plain routes: {worst}")
    check(all(np.isfinite(v) and v > 0 for v in norms_k.values()), "a gradient is 0 or not finite")


def phase_training(card: str) -> dict:
    """Phase 7: ``SupervisedTrainer.fit`` at B=96 bf16; returns the run's launches."""
    from wav2vec_heart_sounds_tpu_torch.data.fragments import FragmentDataset
    from wav2vec_heart_sounds_tpu_torch.data.loader import Batcher
    from wav2vec_heart_sounds_tpu_torch.experiments.cinc import _device_prep
    from wav2vec_heart_sounds_tpu_torch.experiments.common import make_loader
    from wav2vec_heart_sounds_tpu_torch.models.build import build_classifier
    from wav2vec_heart_sounds_tpu_torch.models.classifier import ClassifierConfig
    from wav2vec_heart_sounds_tpu_torch.train.classifier import SupervisedTrainer

    win_len = int(WINDOW_S * FS)
    train = make_loader(FragmentDataset(synthetic_recordings(1, TRAIN_PATIENTS, TRAIN_WINDOWS),
                                        fs=FS_WIRE), TRAIN_BATCH, train=True)
    valid = Batcher(FragmentDataset(synthetic_recordings(2), fs=FS_WIRE), TRAIN_BATCH,
                    train=False)
    steps, valid_batches = len(train), len(valid)
    cfg = ClassifierConfig(num_classes=2, head_hidden=(512, 512, 512), fs=FS)
    model = build_classifier(cfg, seed=0, device="cuda", dtype=torch.bfloat16, train=True)
    trainer = SupervisedTrainer(model, optimizer_name="sgd", lr=1e-3,
                                device_preprocess=_device_prep(FS_WIRE, FS, win_len, "cuda"),
                                log=lambda line: print(f"[train] {line}"))
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
    launches = counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    values = [float(v) for v in losses]
    print(f"[train] fit: {steps} steps of B={TRAIN_BATCH} ({steps * TRAIN_BATCH} windows) + "
          f"{valid_batches} valid batches; losses {', '.join(f'{v:.5f}' for v in values)}; "
          f"best valid MCC {best:.4f}; peak device memory {peak:.2f} GiB")
    check(len(values) == steps and all(np.isfinite(values)), f"training losses {values}")
    for name, (f, b) in PER_STEP.items():
        want = (f + b) * steps + (12 * valid_batches if name == "attention_qkv_fwd" else 0)
        check(launches[name] == want, f"{name}: {launches[name]} launches in fit, expected {want}")
    print(f"[train] launches in fit: {json.dumps(launches)} (per train step fwd+bwd: "
          + ", ".join(f"{k} {f}+{b}" for k, (f, b) in PER_STEP.items())
          + f"; attention_qkv_fwd also 12 per valid batch)")

    runs = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer._run_epoch(train, True, None)
        torch.cuda.synchronize()
        runs.append(time.perf_counter() - t0)
    print(f"[train] {steps * TRAIN_BATCH} windows per epoch ({steps} steps of {TRAIN_BATCH}, "
          f"bf16 wav2vec2-base + 512x3 head, SGD): "
          f"{steps * TRAIN_BATCH / np.median(runs):.1f} training windows/s on {card} (median "
          f"of 3 epochs: {', '.join(f'{s * 1e3:.1f}' for s in runs)} ms; host clock, "
          f"batching, transfer and preprocessing included)")
    return launches


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

    kernel_wrappers()
    phase_build()
    phase_kernel_vs_plain()
    phase_full_width()
    phase_serving(card)
    measured = phase_training_kernels()
    phase_train_step()
    launches = phase_training(card)
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": CSRC + source, "replaces": PALLAS + replaces,
         "launches": launches[name], **measured[name]}
        for name, (source, replaces) in KERNELS.items()]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
