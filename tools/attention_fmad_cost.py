#!/usr/bin/env python3
"""Cost of `-fmad=false` on the two attention kernels, on one CUDA card.

    python3 tools/attention_fmad_cost.py

Run from the root of a checkout on a machine with a CUDA card and the
CUDA toolkit.  The port builds every kernel source with one flag set
(`src/repro_torch/kernels/_build.py`), and that set holds `-fmad=false`
because the scheduler kernels' float32 bits must equal their plain
versions'.  This script builds `flash_attention.cu` and
`decode_attention.cu` once more without that flag, into the checkout's
git-ignored `build/fmad_cost/`, and times both builds of each kernel
through the same wrapper on the same inputs, in the order default,
variant, variant, default (CUDA events, median of 60 calls each, as
`chip_smoke.py` times them; each build's time is the mean of its two
medians).  Both builds are held against the plain version within
`chip_smoke.py`'s tolerance.  Flash runs at `chip_smoke.py`'s bf16
`FLASH_CASES`.  It prints the card's name and power limit, then one JSON
line per shape.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT_DIR = ROOT / "build" / "fmad_cost"
# the wrappers' entry points, whose bound signatures the variant copies
ENTRIES = {"flash_attention": ("flash_attention_fwd",),
           "decode_attention": ("decode_attention_fwd",
                                "decode_attention_block",
                                )}
# (geometry, B, S, valid) of decode
DECODE_CASES = (("stablelm", 1, 2048, 1024), ("stablelm", 4, 2048, 300),
                ("stablelm", 1, 2048, 2048), ("starcoder2", 1, 4096, 4096))


def main() -> None:
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels.decode_attention import ops as da
    from repro_torch.kernels.decode_attention import ref as da_ref
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.flash_attention import ref as fa_ref
    from tools.flash_attention_ab import bind_like, card, nvcc

    dev = card(torch, cs)
    flags = [f for f in _build.NVCC_FLAGS if f != "-fmad=false"]
    cs.check(len(flags) == len(_build.NVCC_FLAGS) - 1,
             "-fmad=false is not among the build flags")
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    _build.build_all()
    mods = {"flash_attention": fa, "decode_attention": da}
    libs = {}
    for name, mod in mods.items():
        default = mod._lib()
        out = OUT_DIR / f"lib{name}-fmad.so"
        nvcc(_build, _build.SOURCES[name], out, flags)
        variant = bind_like(out, default, ENTRIES[name])
        libs[name] = {"fmad_false": default, "fmad_true": variant}

    gen = torch.Generator(device=dev).manual_seed(99)

    def rand(shape):
        return torch.randn(shape, generator=gen,
                           device=dev).to(torch.bfloat16)

    def measure(name, case, call, want):
        mod, ms, err = mods[name], {}, {}
        for build in ("fmad_false", "fmad_true", "fmad_true", "fmad_false"):
            mod._LIB = libs[name][build]
            e, ok = cs.attn_close(torch, call(), want, "bfloat16")
            cs.check(ok, f"{name} {case} ({build}): differs from the "
                         f"plain version by {e}")
            err[build] = e
            ms.setdefault(build, []).append(cs.device_ms(torch, call))
        mod._LIB = libs[name]["fmad_false"]
        t = {b: sum(v) / len(v) for b, v in ms.items()}
        print(json.dumps(dict(
            kernel=name, **case, dtype="bfloat16",
            ms_fmad_false=t["fmad_false"], ms_fmad_true=t["fmad_true"],
            ms_each=ms, cost_ratio=t["fmad_false"] / t["fmad_true"],
            max_abs_err=err)), flush=True)

    for g, B, Sq, Skv, window, dtype in cs.FLASH_CASES:
        if dtype != "bfloat16":
            continue
        H, KV, hd = cs.ATTN_GEOMETRY[g]
        q = rand((B, Sq, H, hd))
        k, v = rand((B, Skv, KV, hd)), rand((B, Skv, KV, hd))
        measure("flash_attention",
                dict(geometry=g, B=B, Sq=Sq, Skv=Skv, window=window),
                lambda: fa.flash_attention(q, k, v, window=window),
                fa_ref.flash_attention_ref(q, k, v, window=window))
    for g, B, S, n in DECODE_CASES:
        H, KV, hd = cs.ATTN_GEOMETRY[g]
        q = rand((B, H, hd))
        k, v = rand((B, S, KV, hd)), rand((B, S, KV, hd))
        valid = torch.arange(S, device=dev) < n
        measure("decode_attention",
                dict(geometry=g, B=B, S=S, n_valid=n),
                lambda: da.decode_attention(q, k, v, valid),
                da_ref.decode_attention_ref(q, k, v, valid))


if __name__ == "__main__":
    main()
