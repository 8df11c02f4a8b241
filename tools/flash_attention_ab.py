#!/usr/bin/env python3
"""Before and after of `flash_attention.cu` on one CUDA card.

    mkdir -p build/flash_ab && git show \\
        <rev>:src/repro_torch/kernels/flash_attention/flash_attention.cu \\
        > build/flash_ab/old.cu
    python3 tools/flash_attention_ab.py [--old build/flash_ab/old.cu] [--ptxas]

Run from the root of a checkout on a machine with a CUDA card and the
CUDA toolkit.  It builds the checkout's `flash_attention.cu` as the port
does (`src/repro_torch/kernels/_build.py`) and each `--old` source (the
flag repeats; a build is named by its file's stem) with the same flags
into the checkout's git-ignored `build/flash_ab/`.  All export the same
C interface, so one wrapper calls each in turn.  At every case of
`chip_smoke.py`'s `FLASH_CASES` every build is held against the plain
version within `chip_smoke.py`'s `ATTN_TOL` and, in bf16, against the
bf16 body's rounding (`flash_attention_mma_ref`) within its `MMA_TOL`;
every case runs, and the script fails at the end if any build differed.
A copy of the source with a deliberate fault, passed as `--old`, shows
which of the two checks catch it.  In bf16 the builds are
timed in turns, new, the others, the others reversed, new (new, old,
old, new with one other), by CUDA events, median of 60 calls each, as
`chip_smoke.py` times them; a build's time is the mean of its two
medians.  `--ptxas` first prints what `ptxas -v` reports for every
build (registers, spills).  It prints the card's name and power limit,
then one JSON line per case.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT_DIR = ROOT / "build" / "flash_ab"
ENTRY = "flash_attention_fwd"


def nvcc(_build, src, out, flags=None, extra=()):
    """Build `src` into `out` with the port's flags (or `flags`), plus
    `extra`; returns nvcc's output."""
    flags = _build.NVCC_FLAGS if flags is None else flags
    proc = subprocess.run([_build._nvcc(), *flags, *extra,
                           "-o", str(out), str(src)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    if proc.returncode != 0:
        raise SystemExit(f"nvcc failed for {src}:\n{proc.stdout}")
    return proc.stdout


def bind_like(path, default, entries=(ENTRY,)):
    """`path` loaded with the entry points bound as in `default`."""
    lib = ctypes.CDLL(str(path))
    for fn in (*entries, "repro_cuda_error_string"):
        getattr(lib, fn).argtypes = getattr(default, fn).argtypes
        getattr(lib, fn).restype = getattr(default, fn).restype
    return lib


def card(torch, cs):
    """Check for a card, print its name and power limit, return it."""
    cs.check(torch.cuda.is_available(), "CUDA is not available")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    return torch.device("cuda")


def unravel(i, shape):
    out = []
    for n in reversed(shape):
        out.append(i % n)
        i //= n
    return out[::-1]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--old", type=Path, action="append", default=[],
                    help="another flash_attention.cu to time against "
                         "(repeatable; each named by its file's stem)")
    ap.add_argument("--ptxas", action="store_true",
                    help="print ptxas -v for every build")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.flash_attention import ref as fa_ref

    dev = card(torch, cs)
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    verbose = ("-Xptxas", "-v") if args.ptxas else ()

    def report(name, text):
        for ln in text.splitlines():
            if "Used" in ln or "spill" in ln or "Compiling" in ln:
                print(f"{name}: {ln.strip()}", flush=True)
    if args.ptxas:
        report("new", nvcc(_build, _build.SOURCES["flash_attention"],
                           OUT_DIR / "libptxas.so", extra=verbose))
    libs = {"new": fa._lib()}
    for src in args.old:
        so = OUT_DIR / f"libflash_attention-{src.stem}.so"
        report(src.stem, nvcc(_build, src, so, extra=verbose))
        libs[src.stem] = bind_like(so, libs["new"])
    names = list(libs)
    order = names + names[:0:-1] + names[:1] if len(names) > 1 else names

    gen = torch.Generator(device=dev).manual_seed(4321)
    dts = {"bfloat16": torch.bfloat16, "float32": torch.float32}
    failed = {}
    for g, B, Sq, Skv, window, dtype in cs.FLASH_CASES:
        H, KV, hd = cs.ATTN_GEOMETRY[g]

        def rand(shape):
            return torch.randn(shape, generator=gen, device=dev).to(
                dts[dtype])
        q = rand((B, Sq, H, hd))
        k, v = rand((B, Skv, KV, hd)), rand((B, Skv, KV, hd))
        want = fa_ref.flash_attention_ref(q, k, v, window=window)
        mma = (fa_ref.flash_attention_mma_ref(q, k, v, window=window)
               if dtype == "bfloat16" else None)

        def call():
            return fa.flash_attention(q, k, v, window=window)

        def fault(build, check, e, got, ref):
            at = (got.float() - ref.float()).abs().argmax().item()
            case = (g, B, Sq, Skv, window, dtype)
            failed[case, build, check] = (
                f"{case} ({build}, {check}): max abs err {e} at (b, s, h, d)"
                f" {tuple(int(x) for x in unravel(at, got.shape))}")
        ms, err, mma_err, mma_share = {}, {}, {}, {}
        for build in order:
            fa._LIB = libs[build]
            got = call()
            e, ok = cs.attn_close(torch, got, want, dtype)
            if not ok:
                fault(build, "ATTN_TOL", e, got, want)
            err[build] = e
            if mma is not None:
                e, share, ok = cs.mma_close(torch, got, mma)
                if not ok:
                    fault(build, "MMA_TOL", e, got, mma)
                mma_err[build], mma_share[build] = e, share
                ms.setdefault(build, []).append(cs.device_ms(torch, call))
        fa._LIB = libs["new"]
        row = dict(geometry=g, B=B, Sq=Sq, Skv=Skv, H=H, KV=KV, hd=hd,
                   window=window, dtype=dtype, max_abs_err=err)
        if mma is not None:
            row.update(mma_max_abs_err=mma_err,
                       mma_tolerance_share=mma_share)
        if ms:
            t = {b: sum(x) / len(x) for b, x in ms.items()}
            row.update(ms={b: t[b] for b in t}, ms_each=ms,
                       bound_ms=cs.bound(*cs.flash_work(
                           B, Sq, Skv, H, KV, hd, window),
                           cs.PEAK_BF16_OPS_PER_S)[0])
            row["over_new"] = {b: t[b] / t["new"] for b in t if b != "new"}
        print(json.dumps(row), flush=True)
    cs.check(not failed, "differs from a reference: "
             + "; ".join(failed.values()))


if __name__ == "__main__":
    main()
