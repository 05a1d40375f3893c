#!/usr/bin/env python3
"""What K4's first product (A) spends its time on, on one CUDA card.

    python3 scripts/torch_k4_ablation.py

Builds copies of ``csrc/ffn_mega.cu`` whose (A) epilogue leaves out one piece of work each:
the dropout mask's Philox draw, the GELU, the two 16-byte stores, or the whole per-element
pass (the product and the staging of its tile only). Each copy is compiled with the
port's nvcc flags into ``build/k4_ablation/<name>/`` and loaded with ctypes. The forward
then runs at the CinC training shape (``[19104, 768] x [3072, 768]``, bf16, rate 0.1), and
``torch.profiler`` reads the device time of the (A) kernel (over the launches it recorded).
The copies run in turns, twice (forward order, then reversed). The copies compute wrong values and serve only for
timing; ``chip_smoke.py`` and ``scripts/torch_kernel_check.py`` check the real kernel.
Prints the card's name and power limit first.
"""

from __future__ import annotations

import ctypes
import shutil
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from wav2vec_heart_sounds_tpu_torch.ops import philox  # noqa: E402
from wav2vec_heart_sounds_tpu_torch.ops.kernels import build  # noqa: E402

OUT = ROOT / "build" / "k4_ablation"
ROWS, D, F = 19104, 768, 3072

# The (A) epilogue's lines that each copy replaces (csrc/ffn_mega.cu, ffn_up_wgmma_kernel).
GUARD = "      if (row >= rows) break;\n      const size_t idx = static_cast<size_t>(row) * f"
KEEP = "      const uint32_t keep = keep8(seed, site, idx, thr);\n      uint32_t out[4];"
GELU_X = "(keep >> (2 * i)) & 1 ? act<true>(p.x) * scale : 0.f,"
GELU_Y = "(keep >> (2 * i + 1)) & 1 ? act<true>(p.y) * scale : 0.f);"
STORES = ("      *reinterpret_cast<uint4*>(pre + idx) = v;\n"
          "      *reinterpret_cast<uint4*>(h + idx) = make_uint4(out[0], out[1], out[2], out[3]);")


def copies(src: str) -> dict[str, str]:
    """name -> source. Each edit applies to the first occurrence: (A) comes first."""
    def edit(old, new):
        if old not in src:
            raise SystemExit(f"ffn_mega.cu no longer holds the line this ablation edits: {old!r}")
        return src.replace(old, new, 1)

    return {
        "full": src,
        "no_mask": edit(KEEP, KEEP.replace("keep8(seed, site, idx, thr)", "0xffu ^ (thr & 1u)")),
        "no_gelu": edit(GELU_X, GELU_X.replace("act<true>(p.x)", "p.x")).replace(
            GELU_Y, GELU_Y.replace("act<true>(p.y)", "p.y"), 1),
        "no_stores": edit(STORES, "      if (out[0] == 0x12345678u && out[1] == 0x9abcdef0u)\n"
                                  "        *reinterpret_cast<uint4*>(h + idx) = v;"),
        "no_epilogue": edit(GUARD, GUARD.replace("row >= rows", "row >= 0")),
    }


def build_copies() -> dict[str, ctypes.CDLL]:
    src = (build.CSRC_DIR / "ffn_mega.cu").read_text()
    jobs = {}
    for name, text in copies(src).items():
        d = OUT / name
        if d.exists():
            shutil.rmtree(d)
        d.mkdir(parents=True)
        for header in build.CSRC_DIR.glob("*.cuh"):
            shutil.copy(header, d / header.name)
        (d / "ffn_mega.cu").write_text(text)
        cmd = [build.find_nvcc(), *build.NVCC_FLAGS, "-o", str(d / "lib.so"),
               str(d / "ffn_mega.cu")]
        jobs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True)
    libs = {}
    for name, proc in jobs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"nvcc failed on the {name} copy:\n{log[-4000:]}")
        libs[name] = ctypes.CDLL(str(OUT / name / "lib.so"))
    return libs


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    libs = build_copies()
    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape, std=1.0):
        return (std * torch.randn(*shape, device="cuda", generator=gen)).to(torch.bfloat16)

    x, w1, b1 = randn(ROWS, D), randn(F, D, std=D ** -0.5), randn(F, std=0.1)
    w2, b2 = randn(D, F, std=F ** -0.5), randn(D, std=0.1)
    lw, lb = torch.ones(D, device="cuda"), torch.zeros(D, device="cuda")
    pre, h = (torch.empty(ROWS, F, device="cuda", dtype=torch.bfloat16) for _ in range(2))
    s, y = torch.empty_like(x), torch.empty_like(x)
    c = ctypes
    types = [c.c_void_p] * 11 + [c.c_int] * 3 + [c.c_uint32] * 5 + [c.c_float] * 3 + [
        c.c_int, c.c_void_p]

    def forward(fn):
        build.check(fn(x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
                       lw.data_ptr(), lb.data_ptr(), pre.data_ptr(), h.data_ptr(), s.data_ptr(),
                       y.data_ptr(), ROWS, D, F, 5, 4, 5, philox.threshold(0.1),
                       philox.threshold(0.1), philox.keep_scale(0.1), philox.keep_scale(0.1),
                       1e-5, 1, build.stream(x)), "ffn_mega_fwd copy")

    def up_ms(fn, runs: int = 20) -> float:
        for _ in range(3):
            forward(fn)
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(runs):
                forward(fn)
            torch.cuda.synchronize()
        return sum(e.self_device_time_total / e.count for e in prof.key_averages()
                   if "ffn_up_wgmma_kernel" in e.key) / 1e3

    fns = {}
    for name, lib in libs.items():
        fns[name] = lib.ffn_mega_fwd
        fns[name].argtypes, fns[name].restype = types, c.c_int
    names = list(fns)
    for turn, order in enumerate((names, names[::-1])):
        for name in order:
            print(f"turn {turn} {name:12s} (A) ffn_up_wgmma_kernel bf16 [{ROWS}, {D}] -> {F}: "
                  f"{up_ms(fns[name]):.4f} ms (torch.profiler, mean of 20)", flush=True)


if __name__ == "__main__":
    main()
