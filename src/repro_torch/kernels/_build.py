"""Build and load the port's CUDA kernels (nvcc + ctypes).

Each kernel source `kernels/<pkg>/<pkg>.cu` is compiled at first use
into a shared library with a plain C interface,

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false
         -shared -Xcompiler -fPIC -o build/repro_torch_kernels/<lib>.so <src>

under the checkout's git-ignored `build/repro_torch_kernels/`, named by
a hash of the source and the flags, and guarded by a file lock so that
concurrent processes build once.  `-fmad=false` (and no fast-math)
keeps every float operation single-rounded, which is what lets the
kernels' float32 bits equal their plain PyTorch versions.

`build(name)` compiles one source if its library is missing;
`load(name)` returns the built library as a `ctypes.CDLL`.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

KERNELS_DIR = Path(__file__).resolve().parent
BUILD_DIR = KERNELS_DIR.parents[2] / "build" / "repro_torch_kernels"
SOURCES = {
    "sched_score": KERNELS_DIR / "sched_score" / "sched_score.cu",
}
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
]


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: the port's CUDA kernels are built "
                       "on a machine with the CUDA toolkit")


def library_path(name: str) -> Path:
    src = SOURCES[name]
    h = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(name: str) -> Path:
    """Compile `name`'s library unless it is already built, and return
    its path.  Raises with nvcc's output on a failed build."""
    path = library_path(name)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if not path.is_file():
                tmp = path.with_suffix(f".{os.getpid()}.tmp")
                proc = subprocess.run(
                    [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                     str(SOURCES[name])],
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True)
                if proc.returncode != 0:
                    raise RuntimeError(
                        f"nvcc failed for {SOURCES[name].name} "
                        f"(exit {proc.returncode}):\n{proc.stdout}")
                os.replace(tmp, path)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return path


def load(name: str) -> ctypes.CDLL:
    """The library for `name`, built first if needed.  Callers keep the
    handle (each wrapper module binds its C signatures once)."""
    return ctypes.CDLL(str(build(name)))
