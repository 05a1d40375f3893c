#!/usr/bin/env python3
"""GPU smoke run of the PyTorch port (``wav2vec_heart_sounds_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which exits non-zero on failure:

1. build every CUDA kernel of the scoring path from ``csrc/`` (into ``build/torch_kernels/``);
2. each kernel against its plain PyTorch version on the card, at the serving shapes, with
   CUDA-event timings (median of 20);
3. full width: a wav2vec2-base encoder (float32, 12 layers x 768) loaded from the synthetic
   HF-layout state dict ``tests/golden/fullsize_sd.py`` must reproduce the recorded HF
   torch outputs ``tests/golden/wav2vec2_fullsize_parity.npz``;
4. the serving path: seeded synthetic raw 2 kHz recordings -> ``FragmentDataset`` -> eval
   ``Batcher`` -> ``experiments.cinc.score`` with a full-width bfloat16 classifier ->
   fragment and patient statistics; the attention kernel must have run 12 times per batch
   and the logits must agree with the same classifier on the plain attention.

Prints the card's name and power limit, one JSON line describing the kernels, and as its
last line ``{"ok": true, "device": {...}}``. Imports nothing of JAX.
"""

from __future__ import annotations

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
ATTN_SOURCE = "wav2vec_heart_sounds_tpu_torch/csrc/attention_qkv_fwd.cu"
ATTN_REPLACES = "wav2vec_heart_sounds_tpu/ops/pallas/attention.py:343"

# Serving configuration: 4 s windows at 16 kHz (the CinC window) from a 2 kHz raw wire.
FS_WIRE, FS, WINDOW_S, BATCH = 2000, 16000, 4.0, 32
PATIENTS, WINDOWS_PER_PATIENT = 12, 9


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
    build.load_library("attention_qkv_fwd")
    seconds = time.perf_counter() - t0
    log = build.build_logs.get("attention_qkv_fwd")
    print(f"[build] attention_qkv_fwd: {seconds:.2f} s "
          f"({'compiled' if log is not None else 'already built'})")
    for line in (log or "").splitlines():
        if "registers" in line or "spill" in line:
            print(f"[build]   {line.strip()}")


def phase_kernel_vs_plain() -> dict:
    """Kernel against plain attention; returns the JSON fields of the serving shape."""
    from wav2vec_heart_sounds_tpu_torch.ops.kernels.attention import (
        attention_qkv_fwd, attention_qkv_reference)

    gen = torch.Generator(device="cuda").manual_seed(0)
    H, T, d = 12, 199, 64
    # bf16 output rounding: 1 ulp = 2^-7 ~ 7.8e-3 at unit scale, so the two versions,
    # which round at the same point from differently ordered f32 sums, may differ by one.
    cases = [(torch.bfloat16, 96, 1e-2, 1e-2), (torch.bfloat16, BATCH, 1e-2, 1e-2),
             (torch.float32, 96, 1e-5, 0.0)]
    record = {}
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
        if dtype == torch.bfloat16 and B == BATCH:
            qkv_main = qkv
            record = {"ms": ms, "plain_ms": plain_ms}
    out = attention_qkv_fwd(qkv_main, T)
    record["max_abs_err"] = (out.float() - attention_qkv_reference(qkv_main, T).float()
                             ).abs().max().item()
    return record


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


def synthetic_recordings(seed: int = 0):
    """Raw 2 kHz windows: 12 patients (half with a murmur-like band), a few spikes."""
    from wav2vec_heart_sounds_tpu_torch.data.fragments import Fragment

    rng = np.random.default_rng(seed)
    n = int(WINDOW_S * FS_WIRE)
    t = np.arange(n) / FS_WIRE
    frags = []
    for p in range(PATIENTS):
        label = p % 2
        rate = rng.uniform(0.9, 1.6)                         # beats per second
        for w in range(WINDOWS_PER_PATIENT):
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

    phase_build()
    kernel = phase_kernel_vs_plain()
    phase_full_width()
    launches = phase_serving(card)
    print(json.dumps({"kernels": [{
        "name": "attention_qkv_fwd", "route": "cuda", "source": ATTN_SOURCE,
        "replaces": ATTN_REPLACES, "launches": launches,
        "max_abs_err": kernel["max_abs_err"], "ms": kernel["ms"],
        "plain_ms": kernel["plain_ms"]}]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
