#!/usr/bin/env python3
"""A short first check of the attention (K3a/K3b), conv + GELU (K8), FFN (K4) and
long-sequence attention (K6) kernels on one CUDA card: build them, run each once against its
plain version, and time them.

    python3 scripts/torch_kernel_check.py [--attention | --conv | --ffn | --flash-kv | --resid |
                                           --k5 | --k7]

A minute of card time where ``chip_smoke.py`` takes several: for the first call after a
kernel changes. Prints the ptxas register and spill lines of the sources and the count of
tensor-core and TMA instructions (``HMMA`` for ``mma.sync``, ``HGMMA`` for ``wgmma``,
``UTMALDG`` for a TMA tile load, from ``cuobjdump -sass``) in each attention, conv and FFN
kernel;
the attention masks decoded bit for bit against ``philox.keep_mask`` in bf16 and f32; K3a,
K3b on the contiguous packed tensor and K3b on the head view of a ``[B, T, 3H, d]``
projection equal bit for bit, and the backward equal to itself run twice, at
``[96, 12, 199, 64]``, ``[64, 12, 51, 64]`` and ``[16, 12, 25, 64]`` (bf16 and f32, rate
0.1 and 0, t = T and one t < T), each against the plain version; their times at the
training shape beside ``scaled_dot_product_attention`` (CUDA events, median of 20). Without
``--attention`` also K8 against the plain version at small shapes (T odd and even,
Cin != Cout, ragged frame tiles; the bf16 frame view and padded dpre bit for bit) and K4.
``--conv`` builds and checks K8 alone: those small shapes, then ``chip_smoke.py``'s phase 14
(conv_1's ``[96, 512, 12799]`` and ``[96, 512, 12800]`` in bf16, ``[8, 512, 12799]`` in
f32, the times beside cuDNN ``conv1d`` + ``gelu`` and each bf16 stage's); each of K8's
``*_wgmma_kernel``s must show HGMMA and UTMALDG. ``--ffn`` builds and checks K4 alone:
forward and backward
against the plain version at 19104, 3264, 400 and 127 rows in bf16 and f32 (rate 0.1, the
masks through the zero patterns of ``h`` and ``dhid``), the bf16 times at 19104 rows beside
the decomposed route, and the device time of each stage kernel (``torch.profiler``) with
each product's TFLOP/s. ``--flash-kv`` builds and checks K6 alone: forward and backward
against the plain version at the vest's ``[16, 8250, 4, 8]`` and at T = 300 and 77 (float32
bars o/lse 2e-5 / 1e-4, gradients 1e-4 / 1e-3), the backward equal bit for bit to a second
run, the times beside ``scaled_dot_product_attention`` in float32 and the bound, and the
device time of each backward kernel (``torch.profiler``); each K6 product kernel must show
HMMA. ``--resid`` builds and checks K1 (``csrc/dropout.cu``), K2 (``csrc/resid.cu``) and K4
(whose backward runs K2's row pass): the SASS of each K1 and K2 kernel by kind of memory
access (16-byte ``LDG``/``STG``/``LDS``, 16-bit ``LDG``/``STG``, bulk copies ``UBLKCP``) and
the integer instructions of one Philox call (``chip_smoke.philox_instructions``); K1 and K2
against their plain versions at the training shape and at ``chip_smoke``'s extra shapes
(``k1_k2_shapes``), and K4 as ``--ffn`` does; the bf16 times at ``[19104, 768]`` beside
``F.dropout``; the ablation of K2's configurations (``csrc/resid.cu`` built again with other
values of ``csrc/resid.cuh``'s ``W2V_RESID_*`` macros, ``RESID_BUILDS``: the ring in both
passes or in neither, 2 / 3 slots, 16-row tiles, bulk stores, three blocks an SM), each
checked against the plain version and timed (device time, ``chip_smoke.device_ms``) at rate
0.1 and at rate 0 (no Philox), in turns, twice. ``--k5`` builds K5 (``csrc/ffn_act.cu``,
``FFN_ACT_BUILDS``), prints its memory instructions by width and instructions an element
(``chip_smoke.k5_instructions``), checks it at phase 5's bars and masks, and times the bf16
kernels at rate 0.1 and 0, twice. ``--k7`` builds K7 (``csrc/sinc_delay.cu``) once for each of
``SINC_BUILDS`` (its ``W2V_SINC_UNROLL`` macro: 1, 4 or 8 taps a trip), prints each form's
float64, conversion and special-function instructions per tap (``chip_smoke.k7_form_counts``),
checks each build with ``chip_smoke.k7_checks`` on the three draws and the smooth one, and
times each entry on the iid and the smooth draw and on draws of one form each
(``k7_one_form``), in turns, twice. The last line is ``ALL_OK``
or ``SOME_FAILED``.
"""

from __future__ import annotations

import contextlib
import ctypes
import subprocess
import sys
import time
from pathlib import Path

import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402
from wav2vec_heart_sounds_tpu_torch.ops import philox  # noqa: E402
from wav2vec_heart_sounds_tpu_torch.ops.kernels import attention as A  # noqa: E402
from wav2vec_heart_sounds_tpu_torch.ops.kernels import build  # noqa: E402
from wav2vec_heart_sounds_tpu_torch.ops.kernels import conv as C  # noqa: E402
from wav2vec_heart_sounds_tpu_torch.ops.kernels import flash_kv as FK  # noqa: E402
from wav2vec_heart_sounds_tpu_torch.ops.kernels import megakernel as mk  # noqa: E402

SOURCES = ("attention_qkv_fwd", "attention_qkv_bwd", "conv_gelu", "ffn_mega")
FFN_SOURCES = ("ffn_mega", "ffn_act", "resid")      # K4 and the decomposed route's K5 + K2
RESID_SOURCES = ("dropout", "resid", "ffn_mega", "ffn_act")
# Builds of csrc/resid.cu for the ablation: its W2V_RESID_* macros (csrc/resid.cuh) against
# the defaults (R = 8 rows a tile, a 4-slot ring in the backward only, 16-byte stores, two
# blocks an SM).
_RING = "-DW2V_RESID_FWD_RING=1"
RESID_BUILDS = {
    "default": (),
    "ring in both passes": (_RING,),
    "no ring (16-byte loads alone)": ("-DW2V_RESID_BWD_RING=0",),
    "ring in both, 2 slots": (_RING, "-DW2V_RESID_STAGES=2"),
    "ring in both, 3 slots": (_RING, "-DW2V_RESID_STAGES=3"),
    "ring in both, R=16, 2 slots": (_RING, "-DW2V_RESID_ROWS=16", "-DW2V_RESID_STAGES=2"),
    "ring in both, bulk stores": (_RING, "-DW2V_RESID_BULK_STORE=1"),
    "ring in both, 2 slots, 3 blocks an SM": (_RING, "-DW2V_RESID_STAGES=2",
                                              "-DW2V_RESID_MIN_BLOCKS=3"),
}
# K6's kernels that hold its products (the delta pre-pass and the dq reduce have none).
FLASH_KV_PRODUCTS = ("flash_kv_fwd_kernel", "flash_kv_bwd_kernel")
failures = []


def report(name, got, ref, atol, rtol):
    got, ref = got.float(), ref.float()
    err = (got - ref).abs().max().item()
    good = got.shape == ref.shape and torch.allclose(got, ref, atol=atol, rtol=rtol)
    if not good:
        failures.append(name)
    print(f"{name}: max_abs_err={err:.3e} (max |plain| {ref.abs().max().item():.3e}) "
          f"{'ok' if good else 'FAILED'}")


def cuda_ms(fn, runs: int = 20) -> float:
    """Median milliseconds of ``fn()`` over ``runs`` launches, CUDA events, after warm-up."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(runs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[runs // 2]


def check_attention(gen):
    H, D = 12, 64
    for dtype in (torch.bfloat16, torch.float32):
        masks = chip_smoke.attention_masks(5, 6, dtype=dtype)
        want = philox.keep_mask(5, 6, masks[0].shape, 0.1, "cuda")
        same = torch.equal(masks[0], want) and torch.equal(masks[1], want)
        if not same:
            failures.append(f"K3b masks {dtype}")
        print(f"K3b masks decoded bit for bit, {dtype}: {same}")
        del masks, want
    for B, T in ((96, 199), (64, 51), (16, 25)):
        for dtype in (torch.bfloat16, torch.float32):
            bf16 = dtype == torch.bfloat16
            proj = [torch.randn(B, T, H, D, device="cuda", generator=gen).to(dtype)
                    for _ in range(3)]
            views = [p.transpose(1, 2) for p in proj]
            packed = torch.cat(views, dim=1).contiguous()
            strided = torch.cat(proj, dim=2).transpose(1, 2)       # head view of [B, T, 3H, d]
            dout = torch.randn(B, H, T, D, device="cuda", generator=gen).to(dtype)
            for t in sorted({T, 150 if T == 199 else T - 4}):
                for rate in (0.1, 0.0):
                    args = (t, rate, 7, 3)
                    tag = f"{dtype} [{B}, {H}, {T}] t={t} rate={rate}"
                    out_a, lse_a = A.attention_fwd(*views, *args, with_lse=True)
                    out_b, lse_b = A.attention_qkv_fwd(packed, *args, with_lse=True)
                    out_s, lse_s = A.attention_qkv_fwd(strided, *args, with_lse=True)
                    grads = A.attention_bwd(*views, out_b, dout, lse_b, *args)
                    again = A.attention_bwd(*views, out_b, dout, lse_b, *args)
                    d_b = A.attention_qkv_bwd(packed, out_b, dout, lse_b, *args)
                    d_s = A.attention_qkv_bwd(strided, out_b, dout, lse_b, *args)
                    same = (torch.equal(out_a, out_b) and torch.equal(lse_a, lse_b)
                            and torch.equal(out_s, out_b) and torch.equal(lse_s, lse_b)
                            and torch.equal(torch.cat(grads, 1), d_b) and torch.equal(d_s, d_b)
                            and all(torch.equal(x, y) for x, y in zip(grads, again)))
                    if not same:
                        failures.append(f"K3a vs K3b vs strided vs repeat {tag}")
                    print(f"K3a == K3b == strided K3b, backward repeats, bit for bit, {tag}: "
                          f"{same}")
                    out_p, lse_p = A.attention_reference(*views, *args, with_lse=True)
                    report(f"  out vs plain {tag}", out_a, out_p,
                           *((1e-2, 1e-2) if bf16 else (1e-5, 1e-5)))
                    report(f"  lse vs plain {tag}", lse_a, lse_p, 1e-5, 1e-5)
                    ref = A.attention_bwd_reference(*views, out_b, dout, lse_b, *args)
                    for n, got, want in zip("qkv", grads, ref):
                        report(f"  d{n} vs plain {tag}", got, want,
                               *((2e-2, 2e-2) if bf16 else (1e-4, 1e-4)))
            if T == 199:
                args = (T, 0.1, 7, 3)
                keys = torch.ones(B, 1, 1, T, dtype=torch.bool, device="cuda")
                leaves = [x.detach().requires_grad_() for x in views]
                lib = F.scaled_dot_product_attention(*leaves, attn_mask=keys, dropout_p=0.1)
                out_b, lse_b = A.attention_qkv_fwd(packed, *args, with_lse=True)
                fwd, bwd = A.attention_qkv_fwd, A.attention_qkv_bwd
                for name, fn in (
                        ("K3b fwd strided", lambda: fwd(strided, *args, with_lse=True)),
                        ("K3b fwd packed", lambda: fwd(packed, *args, with_lse=True)),
                        ("K3a fwd", lambda: A.attention_fwd(*views, *args, with_lse=True)),
                        ("SDPA fwd", lambda: F.scaled_dot_product_attention(
                            *views, attn_mask=keys, dropout_p=0.1)),
                        ("K3b fwd eval", lambda: fwd(strided, T)),
                        ("K3b bwd strided", lambda: bwd(strided, out_b, dout, lse_b, *args)),
                        ("K3b bwd packed", lambda: bwd(packed, out_b, dout, lse_b, *args)),
                        ("K3a bwd", lambda: A.attention_bwd(*views, out_b, dout, lse_b, *args)),
                        ("SDPA autograd bwd", lambda: torch.autograd.grad(lib, leaves, dout,
                                                                          retain_graph=True))):
                    print(f"  {name} {dtype} [{B}, {H}, {T}, {D}]: {cuda_ms(fn):.4f} ms "
                          f"(CUDA events, median of 20)")
            del proj, views, packed, strided, dout
            torch.cuda.empty_cache()


def tensor_core_counts(name: str) -> list[tuple[str, int, int, int]]:
    """(kernel, HMMA, HGMMA, UTMALDG instructions) in the built library of
    ``csrc/<name>.cu``: ``mma.sync`` compiles to HMMA, ``wgmma`` to HGMMA, a TMA tile load
    to UTMALDG."""
    cuobjdump = Path(build.find_nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(build._target(name))],
                          capture_output=True, text=True, check=True).stdout
    rows, kernel = [], None
    for line in sass.splitlines():
        if "Function :" in line:
            kernel = line.split("Function :", 1)[1].strip()
            rows.append([kernel, 0, 0, 0])
        elif kernel is not None:
            op = line.split("*/", 1)[-1].split()
            if op and op[0].startswith("HGMMA"):
                rows[-1][2] += 1
            elif op and op[0].startswith("HMMA"):
                rows[-1][1] += 1
            elif op and op[0].startswith("UTMALDG"):
                rows[-1][3] += 1
    return [tuple(r) for r in rows]


def check_conv(gen):
    """K8 at small shapes: T odd and even, Cin != Cout, frame counts off the 128-frame tiles
    (the forward's last tile, dx's pairs, dW's 64-frame steps), B = 1; bf16 and f32 at
    phase 14's bars, the bf16 frame view and padded dpre bit for bit."""
    cases = ((torch.float32, (2, 128, 256, 301)), (torch.bfloat16, (2, 128, 256, 301)),
             (torch.float32, (3, 256, 128, 520)), (torch.bfloat16, (3, 256, 128, 520)),
             (torch.bfloat16, (2, 128, 256, 259)), (torch.bfloat16, (2, 256, 128, 260)),
             (torch.bfloat16, (1, 128, 128, 3)), (torch.bfloat16, (5, 384, 128, 1001)))
    for dtype, (B, cin, cout, T) in cases:
        bf16 = dtype == torch.bfloat16
        tag = f"{dtype} [{B}, {cin}, {T}] -> {cout}"
        x = torch.randn(B, cin, T, device="cuda", generator=gen).to(dtype)
        w = (torch.randn(cout, cin, 3, device="cuda", generator=gen) / (3 * cin) ** 0.5).to(dtype)
        out, pre, saved = C.conv_gelu_fwd_kernel(x, w, keep_frames=True)
        torch.cuda.synchronize()
        ref_out, ref_pre = C.conv_gelu_fwd_reference(x, w)
        tol = (1e-2, 1e-2) if bf16 else (2e-5, 1e-5)
        report(f"K8 out {tag}", out, ref_out, *tol)
        report(f"K8 pre {tag}", pre, ref_pre, *tol)
        g = torch.randn(ref_out.shape, device="cuda", generator=gen).to(dtype)
        if bf16:
            for name, got, want in (
                    ("frame view", saved.xf, C.pack_frames_reference(x)),
                    ("padded dpre", C._dpre_frames(ref_pre, g),
                     C.dpre_frames_reference(ref_pre, g))):
                same = torch.equal(got, want)
                if not same:
                    failures.append(f"K8 {name} {tag}")
                print(f"K8 {name} bit for bit, {tag}: {same} "
                      f"({int((got != want).sum())} of {got.numel()} differ)")
        ref_dx, ref_dw = C.conv_gelu_bwd_reference(x, w, ref_pre, g)
        top = ref_dw.float().abs().max().item()
        for src in ((saved, x) if bf16 else (x,)):
            dx, dw = C.conv_gelu_bwd_kernel(src, w, ref_pre, g)
            torch.cuda.synchronize()
            how = "frame view" if src is saved else "x"
            report(f"K8 dx {tag} from {how}", dx, ref_dx,
                   *((1e-2, 1e-2) if bf16 else (1e-4, 1e-4)))
            report(f"K8 dw {tag} from {how}", dw, ref_dw,
                   *((1e-2 * top, 1e-2) if bf16 else (1e-4 * top, 1e-4)))
        del x, w, out, pre, saved, ref_out, ref_pre, g, dx, dw, ref_dx, ref_dw
        torch.cuda.empty_cache()


def check_ffn(gen):
    """K4 at chip_smoke's phase-5 bars, every row count the paths give it."""
    seed, s_act, s_hid, rate, eps = 5, 4, 5, 0.1, 1e-5
    for dtype in (torch.bfloat16, torch.float32):
        bf16 = dtype == torch.bfloat16
        elem = (3e-2, 2e-2) if bf16 else (1e-5, 1e-5)
        grad = (3e-2, 2e-2) if bf16 else (1e-4, 1e-4)
        colsum = (1e-1, 2e-2) if bf16 else (1e-2, 1e-4)

        def randn(*shape, std=1.0):
            return (std * torch.randn(*shape, device="cuda", generator=gen)).to(dtype)

        weights = (randn(3072, 768, std=768 ** -0.5), randn(3072, std=0.1),
                   randn(768, 3072, std=3072 ** -0.5), randn(768, std=0.1))
        lw = 1.0 + 0.1 * torch.randn(768, device="cuda", generator=gen)
        lb = 0.1 * torch.randn(768, device="cuda", generator=gen)
        for rows in chip_smoke.K4_ROWS:
            tag = f"{dtype} [{rows}, 768]"
            x, g = randn(rows, 768), randn(rows, 768)
            fwd_in = (x, *weights, lw, lb, seed, s_act, s_hid, rate, rate, eps)
            got = mk.ffn_mega_fwd_kernel(*fwd_in)
            torch.cuda.synchronize()
            ref = mk.ffn_mega_fwd_reference(*fwd_in)
            for name, a, r in zip(("y", "s", "pre"), got, ref):
                report(f"K4 fwd {name} {tag}", a, r, *elem)
            bwd_in = (g, ref[1], ref[2], weights[2], lw, seed, s_act, s_hid, rate, rate, eps)
            got = mk.ffn_mega_bwd_kernel(*bwd_in)
            torch.cuda.synchronize()
            want = mk.ffn_mega_bwd_reference(*bwd_in)
            names = ("ds", "dhid", "dpre", "h", "db1", "db2", "dweight", "dbias")
            for i, (name, a, r) in enumerate(zip(names, got, want)):
                report(f"K4 bwd {name} {tag}", a, r, *(colsum if i >= 4 else grad))
            for name, a, r in (("h", got[3], want[3]), ("dhid", got[1], want[1])):
                same = torch.equal(a == 0, r == 0)
                if not same:
                    failures.append(f"K4 zero pattern of {name} {tag}")
                print(f"K4 zero pattern of {name} (its mask) bit for bit, {tag}: {same}")
            if bf16 and rows == chip_smoke.ROWS:
                fwd = lambda: mk.ffn_mega_fwd_kernel(*fwd_in)        # noqa: E731
                bwd = lambda: mk.ffn_mega_bwd_kernel(*bwd_in)        # noqa: E731
                for name, fn in (("K4 fwd", fwd), ("K4 bwd", bwd),
                                 ("decomposed fwd", lambda: chip_smoke.decomposed_ffn_fwd(
                                     *fwd_in)),
                                 ("decomposed bwd", lambda: chip_smoke.decomposed_ffn_bwd(
                                     *bwd_in))):
                    print(f"  {name} {tag}: {cuda_ms(fn):.4f} ms (CUDA events, median of 20)")
                chip_smoke.print_k4_stages(fwd, bwd, rows)
            del x, g, got, ref, want
            torch.cuda.empty_cache()


def access_counts(name: str, library: str | None = None) -> list[tuple[str, dict]]:
    """(kernel, {kind: count}) of the memory instructions in the built library of
    ``csrc/<name>.cu`` (or the build at ``library``): global and shared loads and stores by
    width (``LDG.128``, ``.64``, ``.32``, ``.16``, ``.8``), and bulk copies (``UBLKCP``)."""
    listing = chip_smoke.sass_listing(library or str(build._target(name)))
    rows = []
    for kernel, insts in listing.items():
        kinds = {}
        for _, text, _ in insts:
            code = text.split()[0]
            base = code.split(".")[0]
            if base == "UBLKCP":
                kind = base
            elif base in ("LDG", "STG", "LDS", "STS"):
                width = next((w for w in ("128", "64") if f".{w}" in code), None)
                width = width or ("16" if ".U16" in code or ".S16" in code else
                                  "8" if ".U8" in code or ".S8" in code else "32")
                kind = f"{base}.{width}"
            else:
                continue
            kinds[kind] = kinds.get(kind, 0) + 1
        rows.append((kernel, kinds))
    return rows


def check_resid(gen):
    """K1 and K2 against their plain versions, K4 (K2's row pass in its backward) as
    ``check_ffn``, their times, and the ablation of K2's configurations."""
    from wav2vec_heart_sounds_tpu_torch.ops.kernels import dropout as K1
    from wav2vec_heart_sounds_tpu_torch.ops.kernels import resid as K2

    for name in ("dropout", "resid"):
        for kernel, kinds in access_counts(name):
            print(f"  {name}: {kernel}: " + ", ".join(f"{k} {v}" for k, v in sorted(kinds.items())))
            if "resid_" in kernel and not kinds.get("STG.128"):
                failures.append(f"{kernel} has no 16-byte store")
            if "resid_bwd_kernel" in kernel and not kinds.get("UBLKCP"):
                failures.append(f"{kernel} has no bulk copy")
    ops = [line.split()[0] for name, lines in chip_smoke.library_sass("dropout").items()
           if "philox_fill_kernel" in name for line in lines]
    mix = {op: ops.count(op) for op in sorted(set(ops))}
    print(f"philox_fill_kernel SASS: {len(ops)} instructions: "
          + ", ".join(f"{op} {n}" for op, n in mix.items()))
    print(f"one Philox call: {chip_smoke.philox_instructions()} integer instructions "
          f"({', '.join(chip_smoke.PHILOX_OPCODES)}) in philox_fill_kernel's SASS; INT32 rate "
          f"{chip_smoke.INT_PER_CLOCK_SM * chip_smoke.SMS * chip_smoke.sm_clock_hz() / 1e12:.3f} T/s")
    libs = chip_smoke.variant_libraries({label: ("resid", defines)
                                         for label, defines in RESID_BUILDS.items()})
    seed, site, rate, eps = 2718281828, 7, 0.1, 1e-5
    rows, cols = chip_smoke.ROWS, chip_smoke.HIDDEN
    for dtype in (torch.bfloat16, torch.float32):
        bf16 = dtype == torch.bfloat16
        elem = (1e-2, 1e-2) if bf16 else (1e-5, 1e-5)
        grad = (1e-2, 1e-2) if bf16 else (1e-4, 1e-4)
        colsum = (1e-2, 1e-4)
        x, h, g = (torch.randn(rows, cols, device="cuda", generator=gen).to(dtype)
                   for _ in range(3))
        w = 1.0 + 0.1 * torch.randn(cols, device="cuda", generator=gen)
        b = 0.1 * torch.randn(cols, device="cuda", generator=gen)
        args = (seed, site, rate, eps)
        tag = f"{dtype} [{rows}, {cols}]"
        same = torch.equal(K1.dropout_kernel(x, seed, site, rate),
                           K1.dropout_reference(x, seed, site, rate))
        print(f"K1 {tag} bit for bit: {same}")
        if not same:
            failures.append(f"K1 {tag}")
        s_p = K2.resid_fwd_reference(h, x, w, b, *args)[1]
        out_p = K2.resid_fwd_reference(h, x, w, b, *args)[0]
        ref = K2.resid_bwd_reference(g, s_p, w, *args)
        for label, lib in libs.items() if bf16 else ():
            with swapped_library("resid", lib, K2.grid_blocks):
                out_k, s_k = K2.resid_fwd_kernel(h, x, w, b, *args)
                got = K2.resid_bwd_kernel(g, s_p, w, *args)
                again = K2.resid_bwd_kernel(g, s_p, w, *args)
            torch.cuda.synchronize()
            if not torch.equal(s_k, s_p):
                failures.append(f"K2 s {tag} build '{label}'")
            report(f"K2 fwd out {tag} build '{label}', s bit for bit {torch.equal(s_k, s_p)}",
                   out_k, out_p, *elem)
            for name, a, r, tol in zip(("dh", "dx", "dweight", "dbias"), got, ref,
                                       (grad, grad, colsum, colsum)):
                report(f"K2 bwd {name} {tag} build '{label}'", a, r, *tol)
            if not all(torch.equal(a, c) for a, c in zip(got, again)):
                failures.append(f"K2 bwd {tag} build '{label}': two runs differ")
        chip_smoke.k1_k2_shapes(dtype, gen, seed, site, eps, elem, grad, colsum)
        if bf16:
            k1 = [chip_smoke.device_ms(lambda: K1.dropout_kernel(x, seed, site, r))
                  for r in (rate, 0.0)]
            print(f"  K1 {tag}: {k1[0]:.4f} ms, at rate 0 (no Philox) {k1[1]:.4f} ms "
                  f"(device time, chip_smoke.device_ms)")
            vest = torch.randn(chip_smoke.VEST_BATCH * chip_smoke.VEST_FRAMES, cols,
                               device="cuda", generator=gen).to(dtype)
            print(f"  K1 {dtype} {list(vest.shape)} (the vest's LoRA inputs): "
                  f"{chip_smoke.device_ms(lambda: K1.dropout_kernel(vest, seed, site, rate)):.4f}"
                  f" ms, bound {chip_smoke.bound(4 * vest.numel(), 0, dtype)['bound_ms']:.4f} ms "
                  f"(device time, chip_smoke.device_ms)")
            lib_ms = chip_smoke.device_ms(lambda: F.dropout(x, rate, training=True))
            events = (cuda_ms(lambda: K1.dropout_kernel(x, seed, site, rate)),
                      cuda_ms(lambda: F.dropout(x, rate, training=True)))
            print(f"  F.dropout {tag}: {lib_ms:.4f} ms (device time); CUDA events around each "
                  f"call: K1 {events[0]:.4f} ms, F.dropout {events[1]:.4f} ms (median of 20)")
            zero = (seed, site, 0.0, eps)
            labels = list(libs)
            for turn in range(2):
                for label in labels if turn == 0 else labels[::-1]:
                    dev = chip_smoke.device_ms
                    with swapped_library("resid", libs[label], K2.grid_blocks):
                        fwd = dev(lambda: K2.resid_fwd_kernel(h, x, w, b, *args))
                        bwd = dev(lambda: K2.resid_bwd_kernel(g, s_p, w, *args))
                        fwd0 = dev(lambda: K2.resid_fwd_kernel(h, x, w, b, *zero))
                        bwd0 = dev(lambda: K2.resid_bwd_kernel(g, s_p, w, *zero))
                        blocks = (K2.grid_blocks(rows, cols, dtype, x.device, False),
                                  K2.grid_blocks(rows, cols, dtype, x.device, True))
                    print(f"  K2 {tag} build '{label}', turn {turn}: fwd {fwd:.4f} ms, bwd "
                          f"{bwd:.4f} ms; at rate 0 (no Philox) fwd {fwd0:.4f} ms, bwd "
                          f"{bwd0:.4f} ms; grid {blocks[0]} / {blocks[1]} blocks (device time, "
                          f"chip_smoke.device_ms; the backward's with the partials' sum)")
        del x, h, g, s_p
        torch.cuda.empty_cache()
    check_ffn(gen)


# The build of csrc/ffn_act.cu (K5) that --k5 checks and times (the shipped one).
FFN_ACT_BUILDS = {"default": ()}
# Builds of csrc/sinc_delay.cu (K7) for its ablation: its W2V_SINC_UNROLL macro against the
# default (eight taps a trip).
SINC_BUILDS = {
    "default": (),
    "a tap a trip": ("-DW2V_SINC_UNROLL=1",),
    "4 taps a trip": ("-DW2V_SINC_UNROLL=4",),
}


def k7_one_form(far: bool, seed: int = 24) -> tuple:
    """K7's ``[96, 8250]`` inputs with every delay in one form: uniform in [0, 20.4] (inside
    the taps) or in [20.6, 41.25] (beyond them); x and g unit normals."""
    src = torch.Generator(device="cuda").manual_seed(seed)
    R, T = chip_smoke.VEST_BATCH * chip_smoke.VEST_MICS, chip_smoke.VEST_T
    x, g, u = (torch.rand(R, T, device="cuda", generator=src) if i == 2 else
               torch.randn(R, T, device="cuda", generator=src) for i in range(3))
    return x, g, (20.6 + 20.65 * u) if far else 20.4 * u


@contextlib.contextmanager
def swapped_library(name: str, path, *caches):
    """The wrappers of ``csrc/<name>.cu`` on another build of it (``path``); ``caches`` are
    the module's cached grids, cleared on the way in and out."""
    saved = build.load_library(name)

    def swap(lib):
        build._libs[name] = lib
        build.entry.cache_clear()
        for cache in caches:
            cache.cache_clear()

    swap(ctypes.CDLL(str(path)))
    try:
        yield
    finally:
        swap(saved)


def check_k5(gen):
    """K5 (``csrc/ffn_act.cu``) on every build of ``FFN_ACT_BUILDS``: memory instructions by
    width and instructions an element (SASS), phase 5's checks at ``[19104, 3072]`` and
    ``chip_smoke.k5_shapes``, the backward run twice, and the bf16 device times at rate 0.1
    and 0, in turns, twice."""
    from wav2vec_heart_sounds_tpu_torch.ops.kernels import ffn as K5

    paths = chip_smoke.variant_libraries({label: ("ffn_act", d)
                                          for label, d in FFN_ACT_BUILDS.items()})
    for label, path in paths.items():
        for kernel, kinds in access_counts("ffn_act", str(path)):
            print(f"  K5 build '{label}': {kernel}: "
                  + ", ".join(f"{k} {v}" for k, v in sorted(kinds.items())))
        print(f"  K5 build '{label}': instructions an element, fwd / bwd: "
              + "; ".join(f"{dt} {chip_smoke.k5_instructions(dtype, False, str(path)):.2f} / "
                          f"{chip_smoke.k5_instructions(dtype, True, str(path)):.2f}"
                          for dt, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32))))
    seed, site, rate = 2718281828, 7, 0.1
    rows, cols = chip_smoke.ROWS, chip_smoke.FFN
    for dtype in (torch.bfloat16, torch.float32):
        bf16 = dtype == torch.bfloat16
        elem = (1e-2, 1e-2) if bf16 else (1e-5, 1e-5)
        grad = (1e-2, 1e-2) if bf16 else (1e-4, 1e-4)
        colsum = (1e-2, 1e-4)
        tag = f"{dtype} [{rows}, {cols}]"
        pre, g = (torch.randn(rows, cols, device="cuda", generator=gen).to(dtype)
                  for _ in range(2))
        ten, ones = torch.full_like(pre, 10.0), torch.ones_like(g)
        args = (seed, site, rate)
        y_p = K5.ffn_act_fwd_reference(pre, *args)
        dpre_p, db_p = K5.ffn_act_bwd_reference(g, pre, *args)
        mask_p = K5.ffn_act_fwd_reference(ten, *args), K5.ffn_act_bwd_reference(ones, ten, *args)[0]
        for label, path in paths.items():
            with swapped_library("ffn_act", path, K5.grid_blocks):
                y = K5.ffn_act_fwd_kernel(pre, *args)
                dpre, db = K5.ffn_act_bwd_kernel(g, pre, *args)
                again = K5.ffn_act_bwd_kernel(g, pre, *args)
                masks = K5.ffn_act_fwd_kernel(ten, *args), K5.ffn_act_bwd_kernel(ones, ten, *args)[0]
            torch.cuda.synchronize()
            report(f"K5 fwd y {tag} build '{label}'", y, y_p, *elem)
            report(f"K5 bwd dpre {tag} build '{label}'", dpre, dpre_p, *grad)
            report(f"K5 bwd dbias {tag} build '{label}'", db, db_p, *colsum)
            same = (torch.equal(masks[0], mask_p[0]), torch.equal(masks[1] == 0, mask_p[1] == 0),
                    torch.equal(again[0], dpre) and torch.equal(again[1], db))
            print(f"  K5 {tag} build '{label}': forward mask (y of pre=10) bit for bit {same[0]}, "
                  f"backward mask (zero pattern) {same[1]}, backward twice bit for bit {same[2]}")
            if not all(same):
                failures.append(f"K5 {tag} build '{label}': masks or repeat {same}")
            if label == "default":
                chip_smoke.k5_shapes(dtype, gen, seed, site, elem, grad, colsum)
        if bf16:
            labels = list(paths)
            for turn in range(2):
                for label in labels if turn == 0 else labels[::-1]:
                    dev = chip_smoke.device_ms
                    with swapped_library("ffn_act", paths[label], K5.grid_blocks):
                        times = [dev(lambda: K5.ffn_act_fwd_kernel(pre, seed, site, r))
                                 for r in (rate, 0.0)]
                        times += [dev(lambda: K5.ffn_act_bwd_kernel(g, pre, seed, site, r))
                                  for r in (rate, 0.0)]
                        blocks = K5.grid_blocks(pre.numel(), dtype, pre.device)
                    print(f"  K5 {tag} build '{label}', turn {turn}: fwd {times[0]:.4f} ms, bwd "
                          f"{times[2]:.4f} ms; at rate 0 (no Philox) fwd {times[1]:.4f} ms, bwd "
                          f"{times[3]:.4f} ms; forward grid {blocks} blocks (device time, "
                          f"chip_smoke.device_ms; the backward's with the partials' sum)")
        del pre, g, ten, ones, y_p, dpre_p, mask_p
        torch.cuda.empty_cache()


def check_k7(gen):
    """K7 (``csrc/sinc_delay.cu``) on every build of ``SINC_BUILDS``: ``chip_smoke.k7_checks``
    (beyond the taps y and s bit for bit; the bars) on the three ``k7_draws`` and the smooth
    draw, then device times of each entry on the iid and the smooth draw, in turns, twice;
    with each form's float64, conversion and special-function instructions per tap and the
    memory instructions by width (SASS)."""
    from wav2vec_heart_sounds_tpu_torch.ops.kernels import sinc_delay as sk

    counts = chip_smoke.k7_form_counts()
    for form, entries in counts.items():
        for entry, kinds in entries.items():
            print(f"  K7 {entry}, every sample {form}: per tap "
                  + ", ".join(f"{v} {k}" for k, v in kinds.items()))
    for kernel, kinds in access_counts("sinc_delay"):
        print(f"  K7 default: {kernel}: " + ", ".join(f"{k} {v}" for k, v in sorted(kinds.items())))
    paths = chip_smoke.variant_libraries({label: ("sinc_delay", d)
                                          for label, d in SINC_BUILDS.items()})
    window = chip_smoke.K7_WINDOW
    draws = [*chip_smoke.k7_draws(), ("smooth delays", chip_smoke.k7_smooth_inputs())]
    for label, path in paths.items():
        with swapped_library("sinc_delay", path):
            for draw, inputs in draws:
                try:
                    chip_smoke.k7_checks(sk, f"build '{label}', {draw}", *inputs, window)
                except SystemExit as miss:
                    failures.append(str(miss))
    timed = (("iid", draws[0][1]), ("smooth", draws[-1][1]), ("near-only", k7_one_form(False)),
             ("far-only", k7_one_form(True)))
    labels = list(paths)
    for turn in range(2):
        for label in labels if turn == 0 else labels[::-1]:
            with swapped_library("sinc_delay", paths[label]):
                for draw, (x, g, d) in timed:
                    s_p = sk.sinc_fwd_reference(x, d, window)[1]
                    dev = chip_smoke.device_ms
                    times = (dev(lambda: sk.sinc_fwd_kernel(x, d, window)),
                             dev(lambda: sk.sinc_grad_d_kernel(x, d, g, window)),
                             dev(lambda: sk.sinc_grad_x_kernel(d, g, s_p, window)))
                    print(f"  K7 [96, 8250] {draw} delays, build '{label}', turn {turn}: fwd "
                          f"{times[0]:.4f} ms, grad_d {times[1]:.4f} ms, grad_x {times[2]:.4f} ms "
                          f"(device time, chip_smoke.device_ms)")


def check_flash_kv(gen):
    """K6 at chip_smoke's phase-9 bars, the vest shape and two ragged lengths."""
    for B, T in ((16, 8250), (2, 300), (2, 77)):
        tag = f"[{B}, {T}, 4, 8]"
        q, k, v, g = (torch.randn(B, T, 4, 8, device="cuda", generator=gen) for _ in range(4))
        o, lse = FK.flash_kv_fwd_kernel(q, k, v)
        torch.cuda.synchronize()
        o_p, lse_p = FK.attention_kv_fwd_reference(q, k, v)
        report(f"K6 fwd o {tag}", o, o_p, 2e-5, 1e-4)
        report(f"K6 fwd lse {tag}", lse, lse_p, 2e-5, 1e-4)
        got = FK.flash_kv_bwd_kernel(q, k, v, o_p, lse_p, g)
        torch.cuda.synchronize()
        for n, a, r in zip(("dq", "dk", "dv"), got,
                           FK.attention_kv_bwd_reference(q, k, v, o_p, lse_p, g)):
            report(f"K6 bwd {n} {tag}", a, r, 1e-4, 1e-3)
        again = FK.flash_kv_bwd_kernel(q, k, v, o_p, lse_p, g)
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        if not same:
            failures.append(f"K6 backward repeat {tag}")
        print(f"K6 backward equal to a second run bit for bit, {tag}: {same}")
        if T != chip_smoke.VEST_T:
            continue
        pairs = B * 4 * T * T
        io = 4 * B * T * 4 * 8
        bounds = (chip_smoke.bound(4 * io + 4 * B * 4 * T, 32 * pairs, "tf32", pairs),
                  chip_smoke.bound(8 * io + 4 * B * 4 * T, 80 * pairs, "tf32", pairs))
        leaves = [x.detach().requires_grad_() for x in (q, k, v)]
        heads = [x.transpose(1, 2) for x in leaves]
        lib = F.scaled_dot_product_attention(*heads)
        g_heads = g.transpose(1, 2)
        fwd = lambda: FK.flash_kv_fwd_kernel(q, k, v)                       # noqa: E731
        bwd = lambda: FK.flash_kv_bwd_kernel(q, k, v, o_p, lse_p, g)        # noqa: E731
        for name, fn, b in (
                ("K6 fwd", fwd, bounds[0]), ("K6 bwd", bwd, bounds[1]),
                ("SDPA f32 fwd", lambda: F.scaled_dot_product_attention(
                    *(x.transpose(1, 2) for x in (q, k, v))), None),
                ("SDPA f32 autograd bwd", lambda: torch.autograd.grad(
                    lib, leaves, g_heads, retain_graph=True), None)):
            ms = cuda_ms(fn, 10)
            extra = (f", bound {b['bound_ms']:.4f} ms by {b['bound_by']} "
                     f"({b['bound_ms'] / ms:.1%} of it)" if b else "")
            print(f"  {name} {tag}: {ms:.4f} ms{extra} (CUDA events, median of 10)")
        cuda = torch.autograd.DeviceType.CUDA
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                fwd(), bwd()
            torch.cuda.synchronize()
        for e in prof.key_averages():
            if e.device_type == cuda and "flash_kv" in e.key:
                print(f"  {e.key}: {e.self_device_time_total / 1e3 / e.count:.4f} ms a call "
                      f"(torch.profiler, mean of {e.count})")
        del q, k, v, g, o, lse, o_p, lse_p, got, again, leaves, heads, lib
        torch.cuda.empty_cache()


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    sources = (SOURCES[:2] if "--attention" in sys.argv
               else FFN_SOURCES if "--ffn" in sys.argv
               else RESID_SOURCES if "--resid" in sys.argv
               else ("conv_gelu",) if "--conv" in sys.argv
               else tuple(name for flag, name in (("--k5", "ffn_act"), ("--k7", "sinc_delay"))
                          if flag in sys.argv) if {"--k5", "--k7"} & set(sys.argv)
               else ("flash_kv",) if "--flash-kv" in sys.argv else SOURCES)
    t0 = time.perf_counter()
    build.load_libraries(*sources)
    print(f"build of {len(sources)} sources: {time.perf_counter() - t0:.1f} s")
    for name in sources:
        for line in build.build_logs.get(name, "").splitlines():
            if "Function properties" in line or "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")
    for name in sources:
        if name in ("attention_qkv_fwd", "attention_qkv_bwd", "ffn_mega", "flash_kv", "conv_gelu"):
            for kernel, hmma, hgmma, tma in tensor_core_counts(name):
                print(f"  {name}: {kernel}: {hmma} HMMA, {hgmma} HGMMA, {tma} UTMALDG")
                if name == "flash_kv" and any(p in kernel for p in FLASH_KV_PRODUCTS) and \
                        not hmma + hgmma:
                    failures.append(f"{kernel} has no tensor-core instruction")
                if name == "conv_gelu" and "wgmma_kernel" in kernel and not (hgmma and tma):
                    failures.append(f"{kernel} has no HGMMA or no UTMALDG")
    gen = torch.Generator(device="cuda").manual_seed(0)
    if "--ffn" in sys.argv:
        check_ffn(gen)
    elif "--resid" in sys.argv:
        check_resid(gen)
    elif "--flash-kv" in sys.argv:
        check_flash_kv(gen)
    elif "--k5" in sys.argv or "--k7" in sys.argv:
        if "--k5" in sys.argv:
            check_k5(gen)
        if "--k7" in sys.argv:
            check_k7(gen)
    elif "--conv" in sys.argv:
        check_conv(gen)
        if not failures:
            chip_smoke.phase_conv_kernel()
    else:
        check_attention(gen)
    if not {"--attention", "--ffn", "--flash-kv", "--conv", "--resid", "--k5", "--k7"} & set(sys.argv):
        check_conv(gen)
        check_ffn(gen)
    print("SOME_FAILED: " + ", ".join(failures) if failures else "ALL_OK")
    if failures:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
