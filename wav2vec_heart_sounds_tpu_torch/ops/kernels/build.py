"""Build the hand-written CUDA kernels from ``csrc/`` at first use and load them.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by ``nvcc`` into
``build/torch_kernels/lib<name>_<hash>.so`` at the repository root, then loaded with
``ctypes``. The hash covers the source and the compiler flags, so an edited source
rebuilds and an unchanged one is reused. There is no fallback: without ``nvcc`` or with a
failing build, the first CUDA call raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

build_logs: dict[str, str] = {}     # name -> nvcc/ptxas output of the build in this process
_libs: dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    """``nvcc`` on PATH, else ``$CUDA_HOME/bin/nvcc`` (default ``/usr/local/cuda``)."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = Path(os.environ.get("CUDA_HOME") or "/usr/local/cuda")
    candidate = home / "bin" / "nvcc"
    if candidate.is_file():
        return str(candidate)
    raise RuntimeError(
        "nvcc not found (not on PATH, not at $CUDA_HOME/bin/nvcc or /usr/local/cuda/bin/nvcc). "
        "The CUDA kernels of wav2vec_heart_sounds_tpu_torch are compiled from csrc/ at first "
        "use on a CUDA tensor and need the CUDA toolkit; CPU tensors use the plain versions.")


def load_library(name: str) -> ctypes.CDLL:
    """Compile ``csrc/<name>.cu`` if its current build is missing, then load it (cached)."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    src = CSRC_DIR / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()
    out = BUILD_DIR / f"lib{name}_{digest[:16]}.so"
    if not out.exists():
        nvcc = find_nvcc()
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(out.name + f".tmp{os.getpid()}")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed to build {name} ({' '.join(cmd)}):\n"
                               f"{proc.stdout}{proc.stderr}")
        build_logs[name] = proc.stdout + proc.stderr
        os.replace(tmp, out)                 # atomic: a concurrent build never sees a partial .so
    lib = _libs[name] = ctypes.CDLL(str(out))
    return lib
