#!/usr/bin/env python3
"""What K6's forward and backward spend their time on, on one CUDA card.

    python3 scripts/torch_k6_ablation.py

Builds copies of ``csrc/flash_kv.cu`` that each change one thing: the TF32 split by
``cvt.rna.tf32.f32`` (round to nearest) in place of the kernel's truncation (one AND); no
exponential (``ex2`` replaced by a multiply); one TF32 product in place of three (3xTF32's
two ``lo`` products left out, but in dq); one m16 query tile a forward warp over 64-key
tiles; 8 backward warps over 256 keys; 32-query backward tiles; the backward's loop over
16-query groups not unrolled (fewer registers); the backward's dk and dv
accumulated on the tensor cores across the whole pass in place of one float32 add a query
tile. Each copy is compiled with the
port's nvcc flags into ``build/k6_ablation/<name>/`` and loaded with ctypes, and the
forward and the whole backward run at the vest shape (``[16, 8250, 4, 8]``, float32), timed
with CUDA events (median of 10), the copies in turns, twice (forward order, then
reversed). Each copy's largest difference from the full kernel is printed beside its time:
the copies serve for timing only, ``scripts/torch_kernel_check.py --flash-kv`` checks the
real kernel. Also prints the instruction mix of the full kernel's forward and fused
backward (``cuobjdump -sass``, the most frequent opcodes). Prints the card's name and power
limit first.
"""

from __future__ import annotations

import collections
import ctypes
import math
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from wav2vec_heart_sounds_tpu_torch.ops.kernels import build  # noqa: E402

OUT = ROOT / "build" / "k6_ablation"
B, T, H, D = 16, 8250, 4, 8

TRUNC = "hi = __uint_as_float(__float_as_uint(x) & 0xffffe000u);"
EX2 = 'asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));'
LO_PRODUCTS = "  mma_tf32(c, alo, b.x, b.y);\n  mma_tf32(c, ahi, b.z, b.w);\n"
HALF_LOOP = "#pragma unroll\n      for (int half = 0; half < kQueryTile / 16; ++half) {"
BWD_FRESH = "      float dkt[2][4] = {}, dvt[2][4] = {};"
BWD_ADD = "          dka[mt][c] += dkt[mt][c];\n          dva[mt][c] += dvt[mt][c];\n"


def copies(src: str) -> dict[str, str]:
    def edit(old, new):
        if old not in src:
            raise SystemExit(f"flash_kv.cu no longer holds the line this ablation edits: {old!r}")
        return src.replace(old, new)

    return {
        "full": src,
        "split_cvt_rna": edit(TRUNC, 'uint32_t r;\n  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) '
                                     ': "f"(x));\n  hi = __uint_as_float(r);'),
        "no_ex2": edit(EX2, "y = x * 0.5f;"),
        "one_product": edit(LO_PRODUCTS, ""),
        # other shapes: one m16 query tile a forward warp over 64-key tiles; 8 backward
        # warps over 256 keys (2 blocks an SM); 32-query backward tiles
        "fwd_1_mt": edit("kFwdMt = 2;", "kFwdMt = 1;").replace("kKeyTile = 32;",
                                                              "kKeyTile = 64;"),
        "bwd_8_warps": edit("kBwdWarps = 16;", "kBwdWarps = 8;").replace(
            "kBwdBlocks = 1;", "kBwdBlocks = 2;"),
        "bwd_32_queries": edit("kQueryTile = 64;", "kQueryTile = 32;"),
        "bwd_rolled": edit(HALF_LOOP, HALF_LOOP.replace("unroll", "unroll 1")),
        # the backward's dk, dv accumulated on the tensor cores across the whole pass
        "bwd_direct": edit(BWD_FRESH, "      float (&dkt)[2][4] = dka, (&dvt)[2][4] = dva;").replace(
            BWD_ADD, ""),
    }


def build_copies() -> dict[str, ctypes.CDLL]:
    src = (build.CSRC_DIR / "flash_kv.cu").read_text()
    procs = {}
    for name, text in copies(src).items():
        d = OUT / name
        d.mkdir(parents=True, exist_ok=True)
        (d / "flash_kv.cu").write_text(text)
        cmd = [build.find_nvcc(), *build.NVCC_FLAGS, "-o", str(d / "lib.so"), str(d / "flash_kv.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True)
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"nvcc failed on the {name} copy:\n{log[-4000:]}")
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")
        libs[name] = ctypes.CDLL(str(OUT / name / "lib.so"))
    return libs


def opcode_mix(lib_path: Path, top: int = 18) -> None:
    cuobjdump = Path(build.find_nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib_path)], capture_output=True,
                          text=True, check=True).stdout
    mix, kernel = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            kernel = line.split("Function :", 1)[1].strip()
            mix[kernel] = collections.Counter()
        elif kernel is not None and "*/" in line:
            op = line.split("*/", 1)[-1].split()
            if op and op[0].startswith("@"):
                op = op[1:]
            if op and op[0][0].isalpha():
                mix[kernel][op[0].split(".")[0]] += 1
    for kernel, counts in mix.items():
        if "fwd_kernel" in kernel or "bwd_kernel" in kernel:
            short = "forward" if "fwd_kernel" in kernel else "fused backward"
            print(f"[k6-sass] {short}: {sum(counts.values())} instructions; "
                  + ", ".join(f"{op} {n}" for op, n in counts.most_common(top)))


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    libs = build_copies()
    opcode_mix(OUT / "full" / "lib.so")
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    for lib in libs.values():
        lib.flash_kv_fwd.argtypes = [P] * 5 + [I] * 4 + [F, P]
        lib.flash_kv_bwd.argtypes = [P] * 11 + [I] * 4 + [F, P]
        lib.parts = torch.empty(-(-T // lib.flash_kv_key_block()), B, H, T, D, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v, g = (torch.randn(B, T, H, D, device="cuda", generator=gen) for _ in range(4))
    o, lse = torch.empty_like(q), torch.empty(B, H, T, device="cuda")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(q), torch.empty_like(q)
    delta = torch.empty_like(lse)
    scale, stream = 1.0 / math.sqrt(D), torch.cuda.current_stream().cuda_stream
    ptr = lambda *ts: [t.data_ptr() for t in ts]  # noqa: E731

    def fwd(lib):
        return lambda: lib.flash_kv_fwd(*ptr(q, k, v, o, lse), B, T, H, D, scale, stream)

    def bwd(lib):
        return lambda: lib.flash_kv_bwd(*ptr(q, k, v, o, lse, g, dq, dk, dv, delta, lib.parts),
                                        B, T, H, D, scale, stream)

    def ms(fn, runs=10):
        for _ in range(2):
            fn()
        times = []
        for _ in range(runs):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            torch.cuda.synchronize()
            times.append(a.elapsed_time(b))
        return sorted(times)[runs // 2]

    fwd(libs["full"])()
    bwd(libs["full"])()
    torch.cuda.synchronize()
    ref = [t.clone() for t in (o, lse, dq, dk, dv)]
    times = collections.defaultdict(list)
    order = list(libs)
    for names in (order, order[::-1]):
        for name in names:
            times[name].append((ms(fwd(libs[name])), ms(bwd(libs[name]))))
    for name in order:
        fwd(libs[name])()
        bwd(libs[name])()
        torch.cuda.synchronize()
        diff = max((a - r).abs().max().item() for a, r in zip((o, lse, dq, dk, dv), ref))
        f = ", ".join(f"{a:.4f}" for a, _ in times[name])
        b = ", ".join(f"{b:.4f}" for _, b in times[name])
        print(f"[k6-ablation] {name}: forward {f} ms, backward {b} ms (CUDA events, median of "
              f"10, two turns); largest difference from full {diff:.3e}")


if __name__ == "__main__":
    main()
