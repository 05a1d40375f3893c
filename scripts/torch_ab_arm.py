#!/usr/bin/env python3
"""One arm of a parent/change A/B on one CUDA card, run on a tree of the repository.

    python3 scripts/torch_ab_arm.py <tree> [phase ...]

``<tree>`` is a checkout of either commit (for the parent, a ``git archive`` unpacked into
a directory that ``.gitignore`` lists); run the arms in the order parent, change, change,
parent, one process each, in one card call. The phases, all of them without names:

* ``sinc``: K7 on the three draws of this script's ``chip_smoke.k7_draws`` (phase 9's
  inputs and two other seed-21 streams), the tree's kernel and plain version each against the
  tree's plain version evaluated in float64, inside and beyond the taps, and the largest
  condition factor beyond them, with the checks at their bars reported, not fatal (the code
  is this script's, so both trees are measured alike);
* ``vest-kernels``: the tree's phase 9 (K6, K7 and the vest's K3b and K4 against their
  plain versions, with their times);
* ``vest-arms``: the vest's two training arms on one model (bench.py's vest config), lazy host
  augmentation and the augmentation on the card (the host head of
  ``vest_dataset(device_augment=True)``, ``augment_multi_pcg_batch`` as the trainer's batch
  transform), timed in turns, median of 3 epochs each (this script's code on both trees);
* ``megakernel``: the tree's phase 5 K4 part (K4 against its plain version, its times beside
  the decomposed route);
* ``train-kernels``: the tree's phase 5 training-kernel part (K1, K2, K5 and K3b against their
  plain versions at the training shapes, with their times);
* ``k1k2``: K1, K2 (forward and backward) and ``F.dropout`` at ``[19104, 768]`` bf16, rate 0.1,
  and K4's stages at the training shape (its backward's (C) is K2's row pass), by device time
  (this script's ``chip_smoke.device_ms`` and ``print_k4_stages``, torch.profiler) and by
  CUDA events around each call, on the tree's wrappers (the same signatures on both trees);
* ``k5``: K5 (forward and backward) at ``[19104, 3072]``, bf16 and f32, rate 0.1, and in
  bf16 the decomposed FFN route (cuBLAS products + K5 + K2) beside K4, by device time and by
  CUDA events around each call, on the tree's wrappers (this script's timing code);
* ``k7``: K7's three entries at ``[96, 8250]`` on this script's iid draw (phase 9's own) and
  its smooth draw (``k7_smooth_inputs``), by device time and by CUDA events, on the tree's
  wrappers;
* ``sass``: the memory instructions of the tree's built K1, K2, K5 and K7 kernels by kind
  and width (this script's ``torch_kernel_check.access_counts``: global and shared accesses by
  width, bulk copies);
* ``conv``: the tree's phase 14 (K8 against its plain version at conv_1's shapes, its times
  beside cuDNN ``conv1d`` + ``gelu``);
* ``serving``: the tree's phase 4 (serving windows/s);
* ``training``: the tree's phase 7 (CinC training windows/s on the three routes);
* ``fusion``: the tree's phase 16a (fusion training windows/s).

Prints the card's name and power limit first.
"""
import importlib.util
import subprocess
import sys
from functools import partial
from pathlib import Path

import numpy as np

PHASES = ("sinc", "vest-kernels", "vest-arms", "megakernel", "train-kernels", "k1k2", "k5", "k7",
          "sass", "conv", "serving", "training", "fusion")
tree = Path(sys.argv[1]).resolve()
phases = sys.argv[2:] or list(PHASES)
if not set(phases) <= set(PHASES):
    raise SystemExit(f"unknown phases {sorted(set(phases) - set(PHASES))}; known: {PHASES}")
sys.path.insert(0, str(tree))
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

print(f"== A/B arm {tree.name}: {' '.join(phases)}", flush=True)
card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                      capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
print(card, flush=True)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
cs.kernel_wrappers()
cs.phase_build()


def own_chip_smoke():
    """This script's own ``chip_smoke`` (its timing and checks), beside the tree's."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_of_this_script", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    own = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(own)
    return own


def k1k2_times():
    """The tree's K1, K2 and K4 stages timed by this script's code (device time and events)."""
    import torch.nn.functional as F

    from wav2vec_heart_sounds_tpu_torch.ops.kernels import dropout, resid
    from wav2vec_heart_sounds_tpu_torch.ops.kernels import megakernel as mk

    own = own_chip_smoke()
    gen = torch.Generator(device="cuda").manual_seed(1)
    seed, site, rate, eps = 2718281828, 7, 0.1, 1e-5
    x, h, g = (torch.randn(cs.ROWS, cs.HIDDEN, device="cuda", generator=gen).to(torch.bfloat16)
               for _ in range(3))
    w = 1.0 + 0.1 * torch.randn(cs.HIDDEN, device="cuda", generator=gen)
    b = 0.1 * torch.randn(cs.HIDDEN, device="cuda", generator=gen)
    s = resid.resid_fwd_reference(h, x, w, b, seed, site, rate, eps)[1]
    for name, fn in (("K1 dropout", lambda: dropout.dropout_kernel(x, seed, site, rate)),
                     ("F.dropout", lambda: F.dropout(x, rate, training=True)),
                     ("K2 forward", lambda: resid.resid_fwd_kernel(h, x, w, b, seed, site, rate, eps)),
                     ("K2 backward", lambda: resid.resid_bwd_kernel(g, s, w, seed, site, rate, eps))):
        print(f"[ab-k1k2] {tree.name} {name} bf16 [{cs.ROWS}, {cs.HIDDEN}]: "
              f"{own.device_ms(fn):.4f} ms device time (device_ms), "
              f"{own.cuda_ms(fn):.4f} ms CUDA events around each call (median of 20)", flush=True)
    w1 = (torch.randn(cs.FFN, cs.HIDDEN, device="cuda", generator=gen) * cs.HIDDEN ** -0.5)
    w2 = (torch.randn(cs.HIDDEN, cs.FFN, device="cuda", generator=gen) * cs.FFN ** -0.5)
    b1, b2 = (0.1 * torch.randn(n, device="cuda", generator=gen) for n in (cs.FFN, cs.HIDDEN))
    w1, w2, b1, b2 = (t.to(torch.bfloat16) for t in (w1, w2, b1, b2))
    fwd_in = (x, w1, b1, w2, b2, w, b, seed, 4, 5, rate, rate, eps)
    _, s4, pre = mk.ffn_mega_fwd_kernel(*fwd_in)
    bwd_in = (g, s4, pre, w2, w, seed, 4, 5, rate, rate, eps)
    print(f"[ab-k1k2] {tree.name} K4 stages:", flush=True)
    own.print_k4_stages(lambda: mk.ffn_mega_fwd_kernel(*fwd_in),
                        lambda: mk.ffn_mega_bwd_kernel(*bwd_in), cs.ROWS, runs=20)


def timings(tag: str, label: str, fn, own) -> None:
    print(f"[ab-{tag}] {tree.name} {label}: {own.device_ms(fn):.4f} ms device time (device_ms), "
          f"{own.cuda_ms(fn):.4f} ms CUDA events around each call (median of 20)", flush=True)


def k5_times():
    """The tree's K5, and its decomposed FFN route beside K4, timed by this script's code."""
    from wav2vec_heart_sounds_tpu_torch.ops.kernels import ffn
    from wav2vec_heart_sounds_tpu_torch.ops.kernels import megakernel as mk

    own = own_chip_smoke()
    gen = torch.Generator(device="cuda").manual_seed(1)
    seed, site, rate, eps = 2718281828, 7, 0.1, 1e-5
    for dtype in (torch.bfloat16, torch.float32):
        dt = "bf16" if dtype == torch.bfloat16 else "f32"
        pre, g = (torch.randn(cs.ROWS, cs.FFN, device="cuda", generator=gen).to(dtype)
                  for _ in range(2))
        timings("k5", f"K5 forward {dt} [{cs.ROWS}, {cs.FFN}]",
                lambda: ffn.ffn_act_fwd_kernel(pre, seed, site, rate), own)
        timings("k5", f"K5 backward {dt} [{cs.ROWS}, {cs.FFN}]",
                lambda: ffn.ffn_act_bwd_kernel(g, pre, seed, site, rate), own)
        del pre, g
    x, g = (torch.randn(cs.ROWS, cs.HIDDEN, device="cuda", generator=gen).to(torch.bfloat16)
            for _ in range(2))
    w = 1.0 + 0.1 * torch.randn(cs.HIDDEN, device="cuda", generator=gen)
    b = 0.1 * torch.randn(cs.HIDDEN, device="cuda", generator=gen)
    w1 = torch.randn(cs.FFN, cs.HIDDEN, device="cuda", generator=gen) * cs.HIDDEN ** -0.5
    w2 = torch.randn(cs.HIDDEN, cs.FFN, device="cuda", generator=gen) * cs.FFN ** -0.5
    b1, b2 = (0.1 * torch.randn(n, device="cuda", generator=gen) for n in (cs.FFN, cs.HIDDEN))
    w1, w2, b1, b2 = (t.to(torch.bfloat16) for t in (w1, w2, b1, b2))
    fwd_in = (x, w1, b1, w2, b2, w, b, seed, 4, 5, rate, rate, eps)
    _, s4, pre = mk.ffn_mega_fwd_kernel(*fwd_in)
    bwd_in = (g, s4, pre, w2, w, seed, 4, 5, rate, rate, eps)
    for label, fn in (("decomposed FFN forward", lambda: own.decomposed_ffn_fwd(*fwd_in)),
                      ("decomposed FFN backward", lambda: own.decomposed_ffn_bwd(*bwd_in)),
                      ("K4 forward", lambda: mk.ffn_mega_fwd_kernel(*fwd_in)),
                      ("K4 backward", lambda: mk.ffn_mega_bwd_kernel(*bwd_in))):
        timings("k5", f"{label} bf16 [{cs.ROWS}, {cs.HIDDEN}] -> {cs.FFN}", fn, own)


def k7_times():
    """The tree's K7 entries on this script's iid and smooth draws, timed by this script."""
    from wav2vec_heart_sounds_tpu_torch.ops.kernels import sinc_delay as sk

    own = own_chip_smoke()
    window = own.K7_WINDOW
    for draw, (x, g, d) in (("iid", own.k7_draws()[0][1]), ("smooth", own.k7_smooth_inputs())):
        s_p = sk.sinc_fwd_reference(x, d, window)[1]
        for label, fn in (("forward", lambda: sk.sinc_fwd_kernel(x, d, window)),
                          ("grad_d", lambda: sk.sinc_grad_d_kernel(x, d, g, window)),
                          ("grad_x", lambda: sk.sinc_grad_x_kernel(d, g, s_p, window))):
            timings("k7", f"K7 {label} [96, 8250], {draw} delays", fn, own)


def sinc_float64():
    """K7's float64 errors on the tree's kernel and plain version, with this script's own
    ``chip_smoke`` (its draws and ``k7_checks``), its failed checks reported."""
    own = own_chip_smoke()
    own.check = lambda ok, msg: print(f"[ab-sinc] {tree.name}: "
                                      f"{'within the bar' if ok else 'MISSES: ' + msg}")
    from wav2vec_heart_sounds_tpu_torch.ops.kernels import sinc_delay as sk

    for label, inputs in own.k7_draws():
        own.k7_checks(sk, f"{tree.name} {label}", *inputs, own.K7_WINDOW)


def vest_arms():
    from wav2vec_heart_sounds_tpu_torch.augment.pipelines import AugmentConfig
    from wav2vec_heart_sounds_tpu_torch.augment.torchaug import augment_multi_pcg_batch
    from wav2vec_heart_sounds_tpu_torch.data.fragments import FragmentDataset
    from wav2vec_heart_sounds_tpu_torch.data.vest import multi_augment, multi_augment_host_residual
    from wav2vec_heart_sounds_tpu_torch.experiments.common import make_loader
    from wav2vec_heart_sounds_tpu_torch.models.build import build_classifier
    from wav2vec_heart_sounds_tpu_torch.train.classifier import SupervisedTrainer

    steps, B = 4, cs.VEST_BATCH
    frags = cs.vest_fragments(-(-B * steps // 16), 0)
    host = make_loader(FragmentDataset(frags, fs=cs.VEST_FS, augment_num=15,
                                       augment_fn=partial(multi_augment, cfg=AugmentConfig())),
                       B, True, 0, cs.VEST_T)
    dev = make_loader(FragmentDataset(frags, fs=cs.VEST_FS, augment_num=15,
                                      augment_fn=partial(multi_augment_host_residual,
                                                         cfg=AugmentConfig(),
                                                         recorded_on_device=False)),
                      B, True, 0, cs.VEST_T)
    cfg = cs.vest_config()
    model = build_classifier(cfg, seed=0, device="cuda", dtype=torch.bfloat16, train=True)
    trainer = SupervisedTrainer(model, optimizer_name="adamw", lr=1e-4, classifier_config=cfg,
                                log=lambda line: None)
    transform = partial(augment_multi_pcg_batch, fs=cs.VEST_FS, noise_bank=None)
    runs = {"host": [], "device": []}
    for arm, loader, bt in (("host", host, None), ("device", dev, transform)):
        trainer.batch_transform = bt
        trainer._run_epoch(loader, True, 1)
    for _ in range(3):
        for arm, loader, bt in (("host", host, None), ("device", dev, transform)):
            trainer.batch_transform = bt
            runs[arm].append(cs.timed_epoch(trainer, loader))
    for arm, r in runs.items():
        print(f"[ab-vest] {tree.name} {arm} augmentation: {steps * B / np.median(r):.1f} vest "
              f"training windows/s on {card} (median of 3 epochs, in turns: "
              f"{', '.join(f'{s * 1e3:.1f}' for s in r)} ms)", flush=True)


def sass_counts():
    """The tree's K1, K2, K5 and K7 kernels by kind of memory instruction, with this script's own
    ``torch_kernel_check.access_counts`` (on the tree's built libraries)."""
    spec = importlib.util.spec_from_file_location(
        "kernel_check_of_this_script", Path(__file__).resolve().parent / "torch_kernel_check.py")
    own = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(own)
    own.chip_smoke = own_chip_smoke()      # its SASS reader, on the tree's built libraries
    for name in ("dropout", "resid", "ffn_act", "sinc_delay"):
        for kernel, kinds in own.access_counts(name):
            print(f"[ab-sass] {tree.name} {name}: {kernel}: "
                  + ", ".join(f"{k} {v}" for k, v in sorted(kinds.items())), flush=True)


RUN = {"sinc": sinc_float64, "sass": sass_counts, "k1k2": k1k2_times, "k5": k5_times,
       "k7": k7_times,
       "train-kernels": cs.phase_training_kernels, "vest-kernels": cs.phase_vest_kernels, "vest-arms": vest_arms,
       "megakernel": cs.phase_megakernel, "conv": cs.phase_conv_kernel,
       "serving": lambda: cs.phase_serving(card),
       "training": lambda: cs.phase_training(card),
       "fusion": lambda: cs.phase_fusion_training(card)}
for phase in phases:
    RUN[phase]()
