"""Build the hand-written CUDA kernels from ``csrc/`` at first use and load them.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by ``nvcc`` into
``build/torch_kernels/lib<name>_<hash>.so`` at the repository root, then loaded with
``ctypes``. The hash covers the source, the shared headers (``csrc/*.cuh``) and the
compiler flags, so an edited source or header rebuilds and an unchanged one is reused.
:func:`load_libraries` starts one ``nvcc`` per missing library, all at once. There is no
fallback: without ``nvcc`` or with a failing build, the first CUDA call raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

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


def _target(name: str) -> Path:
    digest = hashlib.sha256((CSRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{digest.hexdigest()[:16]}.so"


def load_libraries(*names: str) -> list[ctypes.CDLL]:
    """Compile every ``csrc/<name>.cu`` whose current build is missing, one ``nvcc``
    process each, all started together; then load them all (cached)."""
    jobs = []
    for name in names:
        out = _target(name)
        if name in _libs or out.exists():
            continue
        nvcc = find_nvcc()
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(out.name + f".tmp{os.getpid()}")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                text=True)
        jobs.append((name, cmd, proc, tmp, out))
    failures = []
    for name, cmd, proc, tmp, out in jobs:
        log = proc.communicate()[0]
        if proc.returncode != 0:
            failures.append(f"nvcc failed to build {name} ({' '.join(cmd)}):\n{log}")
            continue
        build_logs[name] = log
        os.replace(tmp, out)                 # atomic: a concurrent build never sees a partial .so
    if failures:
        raise RuntimeError("\n".join(failures))
    for name in names:
        if name not in _libs:
            _libs[name] = ctypes.CDLL(str(_target(name)))
    return [_libs[name] for name in names]


def load_library(name: str) -> ctypes.CDLL:
    """Compile ``csrc/<name>.cu`` if its current build is missing, then load it (cached)."""
    return load_libraries(name)[0]


@functools.cache
def entry(name: str, symbol: str, argtypes: tuple) -> ctypes._CFuncPtr:
    """The C function ``symbol`` of ``csrc/<name>.cu`` (built at first use), typed; every
    entry returns the ``cudaError_t`` of its launches."""
    fn = getattr(load_library(name), symbol)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


def stream(t: torch.Tensor) -> int:
    """The raw handle of the current CUDA stream on ``t``'s device."""
    with torch.cuda.device(t.device):
        return torch.cuda.current_stream().cuda_stream


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed: cudaError {err}")
