#!/usr/bin/env python3
"""What K8's bfloat16 stages spend their time on, on one CUDA card.

    python3 scripts/torch_k8_ablation.py

Builds copies of ``csrc/conv_gelu.cu`` that each change one piece of work: the forward GEMM
without the GELU (``out`` stores the sums), with CUDA's ``erff`` in place of the rational erf,
with the rational erf's IEEE divisions (``gelu_erf`` in place of ``gelu_erf<true>``), without
the ``out`` store, without the GELU and that store, or without any store (the tile is still
staged); dx without its stores; the pack pass with 128 frames a block in place of 64. A store
is left out behind a branch that is never taken, so the staging before it stays. Each copy
is compiled with the port's nvcc flags into ``build/k8_ablation/<name>/`` and loaded with
ctypes. At conv_1's shape (``[96, 512, 12799]`` -> 512 channels, bf16) each copy's pack,
forward GEMM and dx run on the same input, frame view and padded dpre, and
``torch.profiler`` reads the device time of each kernel (over the launches it recorded); the
copies run in turns, twice (forward order, then reversed). Then, on the full source: dx
alone and dW alone (with the dpre pass and the reduce), and dW with 8, 16 and 32 float32
partials beside the wrapper's choice. The copies compute wrong values and serve only for
timing; ``chip_smoke.py`` and ``scripts/torch_kernel_check.py --conv`` check the real
kernel. Prints the card's name and power limit first.
"""

from __future__ import annotations

import ctypes
import re
import shutil
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from wav2vec_heart_sounds_tpu_torch.ops.kernels import build  # noqa: E402
from wav2vec_heart_sounds_tpu_torch.ops.kernels import conv  # noqa: E402

OUT = ROOT / "build" / "k8_ablation"
B, C, T = 96, 512, 12799

# The epilogue lines the copies edit (csrc/conv_gelu.cu).
GELU = "stage(tile, acc, [](float y) { return w2v::gelu_erf<true>(y); });"
PRE_STORE = "    write_rows<kGemmBM, kGemmBN, kLd>(tile, pre + first, out_len, cols);"
OUT_STORE = "    write_rows<kGemmBM, kGemmBN, kLd>(tile, out + first, out_len, cols);"
DX_STORE = "    write_rows<64, 2 * kGemmBN, kDxLd>(tile, dx + first, tin, tin - s0);"
PACK = "constexpr int kPackFrames = 64;"


def never(line: str, cond: str) -> str:
    """The store behind a branch the compiler cannot drop and the run never takes."""
    return line.replace("    write_rows<", f"    if ({cond}) write_rows<", 1)


def copies(src: str) -> dict[str, str]:
    def edit(text, old, new):
        if old not in text:
            raise SystemExit(f"conv_gelu.cu no longer holds the line this ablation edits: {old!r}")
        return text.replace(old, new, 1)

    no_gelu = edit(src, GELU, GELU.replace("w2v::gelu_erf<true>(y)", "y"))
    return {
        "full": src,
        "fwd_erff_gelu": edit(src, GELU, GELU.replace(
            "w2v::gelu_erf<true>(y)", "0.5f * y * (1.f + erff(y * 0.70710678f))")),
        "fwd_ieee_gelu": edit(src, GELU, GELU.replace("w2v::gelu_erf<true>(y)",
                                                      "w2v::gelu_erf(y)")),
        "pack_128_frames": edit(src, PACK, PACK.replace("= 64", "= 128")),
        "fwd_no_gelu": no_gelu,
        "fwd_no_out_store": edit(src, OUT_STORE, never(OUT_STORE, "cols < 0")),
        "fwd_no_gelu_no_out_store": edit(no_gelu, OUT_STORE, never(OUT_STORE, "cols < 0")),
        "fwd_no_stores": edit(edit(src, OUT_STORE, never(OUT_STORE, "cols < 0")), PRE_STORE,
                              never(PRE_STORE, "cols < 0")),
        "dx_no_stores": edit(src, DX_STORE, never(DX_STORE, "tin < 0")),
    }


def build_copies() -> dict[str, ctypes.CDLL]:
    src = (build.CSRC_DIR / "conv_gelu.cu").read_text()
    jobs = {}
    for name, text in copies(src).items():
        d = OUT / name
        if d.exists():
            shutil.rmtree(d)
        d.mkdir(parents=True)
        for header in build.CSRC_DIR.glob("*.cuh"):
            shutil.copy(header, d / header.name)
        (d / "conv_gelu.cu").write_text(text)
        cmd = [build.find_nvcc(), *build.NVCC_FLAGS, "-o", str(d / "lib.so"),
               str(d / "conv_gelu.cu")]
        jobs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True)
    libs = {}
    for name, proc in jobs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"nvcc failed on the {name} copy:\n{log[-4000:]}")
        libs[name] = ctypes.CDLL(str(OUT / name / "lib.so"))
    return libs


def device_ms(fn, runs: int = 10) -> dict[str, float]:
    """Mean device milliseconds of each kernel ``fn()`` launches (torch.profiler, over the
    launches the profile recorded: a long window can drop some)."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    return {e.key: e.self_device_time_total / 1e3 / e.count for e in prof.key_averages()
            if e.device_type == cuda}


def pick(times: dict[str, float], kernel: str) -> float:
    return sum(v for k, v in times.items() if kernel in k)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    libs = build_copies()
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(B, C, T, device="cuda", generator=gen).to(torch.bfloat16)
    w = (torch.randn(C, C, 3, device="cuda", generator=gen) / (3 * C) ** 0.5).to(torch.bfloat16)
    out_len = conv.out_length(T)
    out, pre, frames = conv.conv_gelu_fwd_kernel(x, w, keep_frames=True)
    g = torch.randn(out.shape, device="cuda", generator=gen).to(torch.bfloat16)
    wr, wx = conv.relay_weight(w), conv.relay_weight_dx(w)
    pad = conv.frames_padded(out_len)
    dpre_t = torch.empty((B, pad, C), dtype=torch.bfloat16, device="cuda")
    dx, dw = torch.empty_like(x), torch.empty_like(w)
    parts = torch.empty((32, C, 3 * C), dtype=torch.float32, device="cuda")
    default_parts = conv.dw_parts(B, out_len, C, C, x.device)
    st = build.stream(x)
    P, I = ctypes.c_void_p, ctypes.c_int
    for lib in libs.values():
        lib.conv_gelu_fwd_bf16.argtypes = [P, P, P, P, I, I, I, I, I, P]
        lib.conv_gelu_bwd_bf16.argtypes = [P] * 8 + [I] * 9 + [P]
        lib.conv_gelu_pack_bf16.argtypes = [P, P, I, I, I, I, P]

    def fwd(lib):
        build.check(lib.conv_gelu_fwd_bf16(frames.xf.data_ptr(), wr.data_ptr(), out.data_ptr(),
                                           pre.data_ptr(), B, C, T, C, out_len, st), "fwd copy")

    def pack(lib):
        build.check(lib.conv_gelu_pack_bf16(x.data_ptr(), frames.xf.data_ptr(), B, C, T, out_len,
                                            st), "pack copy")

    def bwd(lib, need_dx, need_dw, n_parts=default_parts):
        build.check(lib.conv_gelu_bwd_bf16(
            frames.xf.data_ptr(), wx.data_ptr(), pre.data_ptr(), g.data_ptr(), dpre_t.data_ptr(),
            dx.data_ptr(), parts.data_ptr(), dw.data_ptr(), B, C, T, C, out_len, pad, n_parts,
            int(need_dx), int(need_dw), st), "bwd copy")

    names = list(libs)
    for turn, order in enumerate((names, names[::-1])):
        for name in order:
            f = pick(device_ms(lambda: fwd(libs[name])), "conv_fwd_wgmma_kernel")
            d = pick(device_ms(lambda: bwd(libs[name], True, False)), "conv_dx_wgmma_kernel")
            k = pick(device_ms(lambda: pack(libs[name])), "conv_pack_kernel")
            print(f"turn {turn} {name:26s} forward GEMM {f:.4f} ms, dx {d:.4f} ms, pack "
                  f"{k:.4f} ms (torch.profiler, mean of 10)", flush=True)
    full = libs["full"]
    for label, need in (("dx alone", (True, False)), ("dW alone", (False, True))):
        times = device_ms(lambda: bwd(full, *need))
        print(f"{label} (the backward with only it): " + ", ".join(
            f"{re.search(r'(\w+_kernel)', k).group(1)} {v:.4f} ms" for k, v in times.items()))
    for n in sorted({8, 16, 32, default_parts}):
        times = device_ms(lambda: bwd(full, False, True, n))
        print(f"dW with {n} partials{' (the wrapper default)' if n == default_parts else ''}: "
              f"GEMM {pick(times, 'conv_dw_wgmma_kernel'):.4f} ms, reduce "
              f"{pick(times, 'conv_gelu_dw_reduce_kernel'):.4f} ms")


if __name__ == "__main__":
    main()
