#!/usr/bin/env python3
"""Before and after of `decode_attention.cu` on one CUDA card.

    mkdir -p build/decode_ab && git show \\
        <rev>:src/repro_torch/kernels/decode_attention/decode_attention.cu \\
        > build/decode_ab/old.cu
    python3 tools/decode_attention_ab.py [--old build/decode_ab/old.cu] \\
        [--ptxas]

Run from the root of a checkout on a machine with a CUDA card and the
CUDA toolkit.  It builds the checkout's `decode_attention.cu` as the port
does (`src/repro_torch/kernels/_build.py`) and each `--old` source (the
flag repeats; a build is named by its file's stem) with the same flags
into the checkout's git-ignored `build/decode_ab/`.  All export the same
C interface and split scratch layout, (B, H, n_split, hd + 2); each build
is planned by its own `decode_attention_block()`: 128-key blocks are the
earlier body's, one CTA per (split, query head, batch), planned as it
was (`parent_plan`), and anything else takes the checkout's
`ops.split_plan`.  At every row of `chip_smoke.py`'s `DECODE_CASES`
every build is held against the plain version within `chip_smoke.py`'s
`ATTN_TOL` and, in bf16, within its `DECODE_TOL` (one bf16 ulp); every
case runs, and the script fails at the end if any build differed.  A
copy of the source with a deliberate fault, passed as `--old`, shows
which cases and which of the two checks catch it; `--mutants` writes
three such copies of the checkout's source under `build/decode_mut/`
and adds them (`MUTANTS`: a wrong GQA head map, a tile's last key
dropped from the any-valid test, a ring stage refilled one tile
early).  In bf16 the builds and `scaled_dot_product_attention`
(the yardstick, as `chip_smoke.py` calls it) are timed in turns, new,
the others, the others reversed, new, by CUDA events, median of 60 calls
each, as `chip_smoke.py` times them; a build's time is the mean of its
two medians.  `--ptxas` first prints what `ptxas -v` reports for every
build (registers, spills, shared memory).  `--target` plans the 32-key
builds with another `TARGET_CTAS`.  `--profile` adds, for every bf16
case and build, each kernel's device µs a call from `torch.profiler`
over 20 calls (which splits a call into its partial and combine
launches).  It prints the card's name and power limit, then one JSON
line per case.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT_DIR = ROOT / "build" / "decode_ab"
MUT_DIR = ROOT / "build" / "decode_mut"
ENTRIES = ("decode_attention_fwd", "decode_attention_block")
# copies of the checkout's source with one deliberate fault each, as
# (text, replacement) edits
MUTANTS = {
    # query head h reads KV head h % KV: the CTA of KV head kvh serves
    # the query heads g * KV + kvh, not kvh * G + g
    "gqa_map": [
        ("*reinterpret_cast<const uint4*>(qb + i * EPC)",
         "*reinterpret_cast<const uint4*>(q + (static_cast<long>(b) * H"
         " + (g0 + i * EPC / HD) * KV + kvh) * HD + i * EPC % HD)"),
        ("g * hs", "((g0 + g) * KV + kvh - h0) * hs")],
    # a tile's last key is dropped from the any-valid test
    "skip_valid": [
        ("      any |= or4(*reinterpret_cast<const uint4*>(valid + j));\n",
         "      uint4 w = *reinterpret_cast<const uint4*>(valid + j);\n"
         "      if (c == TK / 16 - 1) w.w &= 0x00FFFFFFu;\n"
         "      any |= or4(w);\n")],
    # at tile i the ring refills the stage of tile i (with tile
    # i + STAGES), not that of tile i - 1: tile i's stage is overwritten
    # while it is read, and tile i - 1 + STAGES is never fetched (its
    # stage still holds tile i - 1)
    "early_refill": [
        ("if (i - 1 + STAGES < n_live) issue(i - 1 + STAGES);",
         "if (i + STAGES < n_live) issue(i + STAGES);")],
}


def write_mutants(src):
    """The MUTANTS of `src` under MUT_DIR; their paths."""
    MUT_DIR.mkdir(parents=True, exist_ok=True)
    paths = []
    for name, edits in MUTANTS.items():
        text = src.read_text()
        for old, new in edits:
            if old not in text:
                raise SystemExit(f"mutant {name}: {old!r} is not in {src}")
            text = text.replace(old, new)
        paths.append(MUT_DIR / f"{name}.cu")
        paths[-1].write_text(text)
    return paths


def parent_plan(B, H, S, block=128, target=264):
    """The earlier body's (n_split, blocks_per_split): splits of whole
    128-key blocks until B * H * n_split reaches 264 CTAs."""
    n_blk = -(-S // block)
    want = min(max(1, -(-target // (B * H))), n_blk)
    per = -(-n_blk // want)
    return -(-n_blk // per), per


def kernel_us(torch, fn, n=20):
    """Device µs a call of each kernel `fn` launches, by the profiler."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", 0)
        if t > 0:
            name = e.key.replace("void ", "").replace(
                "(anonymous namespace)::", "")
            out[name.split("(")[0]] = t / n
    return out


def caller(torch, lib, da, _build):
    """A call of `lib` as the wrapper makes it, under the build's plan."""
    old = lib.decode_attention_block() == 128

    def call(q, k, v, valid):
        B, H, hd = q.shape
        S, KV = k.shape[1], k.shape[2]
        n_split, per = (parent_plan(B, H, S) if old
                        else da.split_plan(B, KV, S))
        out = torch.empty_like(q)
        part = torch.empty((B, H, n_split, hd + 2), dtype=torch.float32,
                           device=q.device)
        rc = lib.decode_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), valid.data_ptr(),
            part.data_ptr(), out.data_ptr(), B, S, H, KV, hd, n_split, per,
            1.0 / hd ** 0.5, da.DTYPES[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream)
        _build.check_rc(lib, rc, "decode_attention")
        return out
    return call


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--old", type=Path, action="append", default=[],
                    help="another decode_attention.cu to time against "
                         "(repeatable; each named by its file's stem)")
    ap.add_argument("--ptxas", action="store_true",
                    help="print ptxas -v for every build")
    ap.add_argument("--profile", action="store_true",
                    help="device µs of each kernel of a call, per build")
    ap.add_argument("--mutants", action="store_true",
                    help="also build the checkout's source with each fault "
                         "of MUTANTS, under build/decode_mut/")
    ap.add_argument("--target", type=int, default=None,
                    help="plan the 32-key builds with this TARGET_CTAS "
                         "instead of ops.TARGET_CTAS")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import torch
    import torch.nn.functional as F

    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels.decode_attention import ops as da
    from repro_torch.kernels.decode_attention import ref as da_ref
    from tools.flash_attention_ab import bind_like, card, nvcc, unravel

    dev = card(torch, cs)
    if args.target is not None:
        da.TARGET_CTAS = args.target
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    verbose = ("-Xptxas", "-v") if args.ptxas else ()

    def report(name, text):
        for ln in text.splitlines():
            if "Used" in ln or "spill" in ln or "Compiling" in ln:
                print(f"{name}: {ln.strip()}", flush=True)
    if args.ptxas:
        report("new", nvcc(_build, _build.SOURCES["decode_attention"],
                           OUT_DIR / "libptxas.so", extra=verbose))
    libs = {"new": da._lib()}
    if args.mutants:
        args.old += write_mutants(_build.SOURCES["decode_attention"])
    for src in args.old:
        so = OUT_DIR / f"libdecode_attention-{src.stem}.so"
        report(src.stem, nvcc(_build, src, so, extra=verbose))
        libs[src.stem] = bind_like(so, libs["new"], ENTRIES)
    calls = {name: caller(torch, lib, da, _build)
             for name, lib in libs.items()}
    names = [*libs, "sdpa"]
    order = names + names[:0:-1] + names[:1]

    gen = torch.Generator(device=dev).manual_seed(4321)
    dts = {"bfloat16": torch.bfloat16, "float32": torch.float32}
    failed = {}

    def fault(case, build, check, e, got, want):
        at = (got.float() - want.float()).abs().argmax().item()
        failed[case, build, check] = (
            f"{case} ({build}, {check}): max abs err {e} at (b, h, d) "
            f"{tuple(int(x) for x in unravel(at, got.shape))}")
    for g, B, S, n, dtype in cs.DECODE_CASES:
        H, KV, hd = cs.ATTN_GEOMETRY[g]

        def rand(shape):
            return torch.randn(shape, generator=gen, device=dev).to(
                dts[dtype])
        q = rand((B, H, hd))
        k, v = rand((B, S, KV, hd)), rand((B, S, KV, hd))
        valid = cs.decode_valid(torch, S, n, dev)
        n_valid = int(valid.sum())
        want = da_ref.decode_attention_ref(q, k, v, valid)
        qt = q[:, :, None, :]
        kt, vt = k.transpose(1, 2), v.transpose(1, 2)
        mask = valid[None, None, None, :]
        calls["sdpa"] = lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, enable_gqa=KV != H)[:, :, 0]
        case = (g, B, S, n, dtype)
        ms, err, share, prof = {}, {}, {}, {}
        for build in order:
            if build == "sdpa":
                fn = calls["sdpa"]
            else:
                def fn(call=calls[build]):
                    return call(q, k, v, valid)
            got = fn()
            e, ok = cs.attn_close(torch, got, want, dtype)
            err[build] = e
            if not ok and build != "sdpa":
                fault(case, build, "ATTN_TOL", e, got, want)
            if dtype == "bfloat16" and build != "sdpa":
                e, share[build], ok = cs.mma_close(torch, got, want,
                                                   cs.DECODE_TOL)
                if not ok:
                    fault(case, build, "DECODE_TOL", e, got, want)
            if dtype == "bfloat16":
                ms.setdefault(build, []).append(cs.device_ms(torch, fn))
                if args.profile and build not in prof:
                    prof[build] = kernel_us(torch, fn)
        row = dict(geometry=g, B=B, S=S, H=H, KV=KV, hd=hd, n_valid=n_valid,
                   dtype=dtype, max_abs_err=err)
        if share:
            row["decode_tolerance_share"] = share
        if ms:
            t = {b: sum(x) / len(x) for b, x in ms.items()}
            row.update(ms=t, ms_each=ms, bound_ms=cs.bound(
                *cs.decode_work(B, S, H, KV, hd, n_valid),
                cs.PEAK_BF16_OPS_PER_S)[0])
            row["over_new"] = {b: t[b] / t["new"] for b in t if b != "new"}
        if prof:
            row["kernel_us"] = prof
        print(json.dumps(row), flush=True)
    cs.check(not failed, "differs from the plain version: "
             + "; ".join(failed.values()))


if __name__ == "__main__":
    main()
