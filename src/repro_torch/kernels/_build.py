"""Build and load the port's CUDA kernels (nvcc + ctypes).

Each kernel source `kernels/<pkg>/<pkg>.cu` is compiled at first use
into a shared library with a plain C interface,

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false
         -shared -Xcompiler -fPIC -o build/repro_torch_kernels/<lib>.so <src>

under the checkout's git-ignored `build/repro_torch_kernels/`, named by
a hash of the source and the flags, and guarded by a file lock of its
own so that concurrent processes build it once.  `-fmad=false` (and no
fast-math) keeps every float operation single-rounded, which is what
lets the scheduler kernels' float32 bits equal their plain PyTorch
versions.  One flag set serves every source: the attention and SSD
kernels are held to a tolerance, not to bits, and write their inner
products with explicit `fmaf`, so the flag costs them only the
contractions they do not spell out (`tools/attention_fmad_cost.py`
times both builds of the attention kernels).

`build(name)` compiles one source if its library is missing;
`build_all()` starts one nvcc for each source at once and waits for
all; `load(name, signatures)` returns the built library as a
`ctypes.CDLL` with its entry points' signatures bound, and
`check_rc` turns a launch's error code into an exception.

The kernels are forward-only: the reference trains through XLA, not
its Pallas kernels, so no kernel has a backward pass.  `refuse_autograd`
makes each wrapper raise, on any device, when grad mode is on and an
input needs a gradient, instead of returning a result cut off from the
graph (training runs the plain versions, `impl="plain"`).

The wrappers may be called from several threads at once (the serving
path's worker pool): each loads its library under `LOCK`, and
`count_launch` adds to a launch counter under it too.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

KERNELS_DIR = Path(__file__).resolve().parent
BUILD_DIR = KERNELS_DIR.parents[2] / "build" / "repro_torch_kernels"
SOURCES = {
    "sched_score": KERNELS_DIR / "sched_score" / "sched_score.cu",
    "flash_attention": KERNELS_DIR / "flash_attention" / "flash_attention.cu",
    "decode_attention": KERNELS_DIR / "decode_attention" / "decode_attention.cu",
    "ssd_scan": KERNELS_DIR / "ssd_scan" / "ssd_scan.cu",
}
# guards the wrappers' library handles and launch counters across threads
LOCK = threading.Lock()
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
    with open(BUILD_DIR / f".{name}.lock", "w") as lock:
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


def build_all() -> dict[str, Path]:
    """Every source's library, the missing ones compiled in parallel (one
    nvcc process each, all started together).  Raises on the first
    failed build."""
    with ThreadPoolExecutor(len(SOURCES)) as pool:
        paths = dict(zip(SOURCES, pool.map(build, SOURCES)))
    return paths


def load(name: str, signatures: dict[str, list]) -> ctypes.CDLL:
    """The library for `name`, built first if needed, with the C
    signatures of its entry points bound: `signatures` maps each
    function to its argument types (every entry point returns int, the
    CUDA error code), and every library's `repro_cuda_error_string` is
    bound too.  Callers keep the handle."""
    lib = ctypes.CDLL(str(build(name)))
    for fn, args in signatures.items():
        getattr(lib, fn).argtypes = args
        getattr(lib, fn).restype = ctypes.c_int
    lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return lib


def check_rc(lib: ctypes.CDLL, rc: int, name: str) -> None:
    """Raise with CUDA's message unless the launch returned 0."""
    if rc != 0:
        msg = lib.repro_cuda_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc}: {msg}")


def refuse_autograd(name: str, *tensors) -> None:
    """Raise `RuntimeError` when grad mode is on and one of `tensors`
    requires a gradient: `name`'s kernel has no backward pass."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: the kernel is forward-only and an input requires a "
            f"gradient; train through the plain version (impl='plain') or "
            f"call it under torch.no_grad()")


def count_launch(launches: dict, name: str) -> None:
    """Add one to `launches[name]`, atomically across threads."""
    with LOCK:
        launches[name] += 1
