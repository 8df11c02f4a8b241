#!/usr/bin/env python3
"""Before and after of `sched_score.cu`'s three kernels on one CUDA card.

    mkdir -p build/sched_ab && git show \\
        <rev>:src/repro_torch/kernels/sched_score/sched_score.cu \\
        > build/sched_ab/old.cu
    python3 tools/sched_score_ab.py [--old build/sched_ab/old.cu] \\
        [--ptxas] [--profile] [--mutants]

Run from the root of a checkout on a machine with a CUDA card and the
CUDA toolkit.  It builds the checkout's `sched_score.cu` as the port
does (`src/repro_torch/kernels/_build.py`) and each `--old` source (the
flag repeats; a build is named by its file's stem) with the same flags
into the checkout's git-ignored `build/sched_ab/`.  All export the same
C entry points.  A build whose `sched_score_tile()` is 2048 is the
earlier two-pass top-b body and gets the two scratch buffers it was
called with; any other build its own (keys, counters, status)
workspace, as `ops.py` makes it.  A build whose source still caps the
slot pool (`WMAX`) is the one-CTA compaction body: it is called with
its own signature and only at pools of 4096 slots or fewer.  At every
case of `chip_smoke.py`'s `sched_cases` and `compact_cases` every build
is held bit for bit against the plain version (outputs are filled with
a sentinel first, so an output left unwritten shows, and compaction's
lanes past its ids must keep it), and a second identical call at each
multi-CTA size must repeat the first; every case runs, and the script
fails at the end if any build differed.  `--mutants` writes copies of
the checkout's source with one deliberate fault each under
`build/sched_mut/` and adds them (`MUTANTS`: top-b's done counter
never set back to 0, a cross-CTA merge that ranks the higher index
first on a tie, CTA lists that keep b - 1 keys; compaction's look-back
prefix one too high past the first tile, ties within a tile to the
higher position, no sentinel keys); the tool then exits non-zero and
lists where each was caught.  At the paper cell's n = 256 (top-b, b =
4) and at n = 4096 and 100,000 (top-b with b = 16, and argmax) the
builds and the library call (`torch.topk` / `torch.argmax` over
precomputed scores, as `chip_smoke.py` times them) are timed in turns,
new, the others, the others reversed, new, by CUDA events, median of 60
calls each (`chip_smoke.device_ms`); a build's time is the mean of its
two medians.  Compaction is timed the same way at W = 4096 and 100,000
(b = 16, density 0.6) beside `unfused`, the plain compaction and then
the checkout's top-b kernel over the compacted pool; its rows carry
`chip_smoke.compact_bound`.  `--ptxas` first prints what `ptxas -v`
reports for every build (registers, spills, shared memory).
`--profile` adds, at n = 256, 4096 and 100,000, each build's kernels a
call and their device µs from `torch.profiler` over 20 calls (top-b
and argmax; compaction at 4096 and 100,000).  It prints the card's name
and power limit, then one JSON line per timed case.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT_DIR = ROOT / "build" / "sched_ab"
MUT_DIR = ROOT / "build" / "sched_mut"
ENTRIES = ("sched_score_topb", "sched_score_argmax", "sched_compact_topb",
           "sched_score_tile")
PARENT_TILE = 2048   # the two-pass body's lanes a block
ONE_CTA_MARK = "constexpr int WMAX"   # the one-CTA compaction body's cap
# copies of the checkout's source with one deliberate fault each, as
# (text, replacement) edits
MUTANTS = {
    # the last CTA leaves the done counter at nb: the next call's last
    # CTA never sees nb - 1 and nobody writes the answer
    "no_reset": [("if (threadIdx.x == 0) *done = 0u;", "")],
    # the last CTA merges keys whose index half is flipped, so on equal
    # scores the higher index wins across CTAs (and flips them back)
    "tie_high": [
        ("m = umax(m, __ldcg(ws + j));",
         "m = umax(m, __ldcg(ws + j) ^ 0xFFFFFFFFull);"),
        ("    best = block_max<NT>(m, red);\n"
         "    if (threadIdx.x == 0) *done = 0u;",
         "    best = block_max<NT>(m, red) ^ 0xFFFFFFFFull;\n"
         "    if (threadIdx.x == 0) *done = 0u;"),
        (": __ldcg(ws + (next + q - carry) * L + p);",
         ": __ldcg(ws + (next + q - carry) * L + p) ^ 0xFFFFFFFFull;"),
        ("      __syncthreads();\n    }\n  }\n}\n",
         "      __syncthreads();\n    }\n  }\n"
         "  for (int e = 0; e < E; ++e) k[e] ^= 0xFFFFFFFFull;\n}\n")],
    # each CTA hands the last one only its best b - 1 keys
    "keep_b_minus_1": [
        ("if (wpos(e) < L) ws[blockIdx.x * L + wpos(e)] = k[e];",
         "if (wpos(e) < L) ws[blockIdx.x * L + wpos(e)] = "
         "wpos(e) < b - 1 ? k[e] : 0ull;")],
    # compaction: the look-back's prefix one too high, so every tile past
    # the first puts its ids and ranks one lane late (the ids of the last
    # tiles run past w, into the guard lanes)
    "lookback_plus_one": [
        ("    if (inc != 0u) return excl;",
         "    if (inc != 0u) return excl + 1;")],
    # compaction: keys made with the index half flipped and flipped back
    # after the CTA's selection, so equal scores in a tile rank the
    # higher position first
    "compact_tie_high": [
        ("static_cast<uint32_t>(pos[e]))\n                : 0ull;",
         "static_cast<uint32_t>(pos[e])) ^ 0xFFFFFFFFull\n"
         "                : 0ull;"),
        ("if (k[e] != 0ull) k[e] -= static_cast<u64>(excl);",
         "if (k[e] != 0ull) k[e] = (k[e] ^ 0xFFFFFFFFull) - "
         "static_cast<u64>(excl);")],
    # compaction: no sentinel keys in the final selection (ranks past the
    # live slots come out empty; a live score below NEG ranks before the
    # NEG lanes)
    "no_sentinels": [
        ("return j < w_total ? make_key(NEG, static_cast<uint32_t>(j)) : "
         "0ull;", "return 0ull;")],
}
TIMED = ((256, 4), (4096, 16), (100_000, 16), (4096, None), (100_000, None))


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


def workspace(torch, ops):
    """A (keys, counters, status) workspace of one build, made and grown
    as `ops._workspace` makes it: `get(n)` for a call over n lanes."""
    ws = {}

    def get(n):
        tiles = -(-n // ops.TILE)
        if "counters" not in ws:
            ws["counters"] = torch.zeros((4,), dtype=torch.int32,
                                         device="cuda")
        if "keys" not in ws or ws["keys"].numel() < tiles * ops.BMAX:
            ws["keys"] = torch.empty((tiles * ops.BMAX,), dtype=torch.int64,
                                     device="cuda")
        if "status" not in ws or ws["status"].numel() < tiles:
            ws["status"] = torch.zeros((tiles,), dtype=torch.int64,
                                       device="cuda")
        return ws["keys"], ws["counters"], ws["status"]
    return get


def caller(torch, lib, ops, _build, get):
    """Calls of `lib`'s top-b and argmax as their wrappers make them:
    `call(b, features, fill)`, b None for argmax; `fill` sets the
    outputs to a sentinel first.  `get` is the build's workspace."""
    tile = lib.sched_score_tile()

    def scratch(n, b):
        if tile == PARENT_TILE:  # the two-pass body's two key buffers
            a = -(-n // tile) * b
            return (torch.empty((a,), dtype=torch.int64, device="cuda"),
                    torch.empty((max(1, -(-a // tile) * b),),
                                dtype=torch.int64, device="cuda"))
        return get(n)[:2]

    def call(b, f, fill=True):
        wait, cost, urg, mask, w, r = f
        n = wait.shape[0]
        bb = 1 if b is None else min(b, n)
        shape = () if b is None else (bb,)
        if fill:
            idx = torch.full(shape, -7, dtype=torch.int32, device="cuda")
            score = torch.full(shape, float("nan"), device="cuda")
        else:
            idx = torch.empty(shape, dtype=torch.int32, device="cuda")
            score = torch.empty(shape, device="cuda")
        a, c = scratch(n, bb)
        ptrs = [None if t is None else t.data_ptr()
                for t in (wait, cost, urg, r, mask, w)]
        outs = (a.data_ptr(), c.data_ptr(), idx.data_ptr(),
                score.data_ptr(), torch.cuda.current_stream().cuda_stream)
        if b is None:
            rc = lib.sched_score_argmax(*ptrs, n, *outs)
        else:
            rc = lib.sched_score_topb(*ptrs, n, bb, *outs)
        _build.check_rc(lib, rc, "sched_score")
        return idx, score
    return call


def kernel_us(torch, fn, n=20):
    """{kernel: (launches a call, device µs a call)} by the profiler."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if str(getattr(e, "device_type", "")).endswith("CUDA"):
            name = e.key.replace("void ", "").replace(
                "(anonymous namespace)::", "").split("(")[0]
            us = float(getattr(e, "self_device_time_total", None)
                       or getattr(e, "self_cuda_time_total", 0.0))
            out[name] = (e.count / n, us / n)
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--old", type=Path, action="append", default=[],
                    help="another sched_score.cu to time against "
                         "(repeatable; each named by its file's stem)")
    ap.add_argument("--ptxas", action="store_true",
                    help="print ptxas -v for every build")
    ap.add_argument("--profile", action="store_true",
                    help="kernels a call and their device µs, per build")
    ap.add_argument("--mutants", action="store_true",
                    help="also build the checkout's source with each fault "
                         "of MUTANTS, under build/sched_mut/")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels.sched_score import ops, ref
    from tools.flash_attention_ab import bind_like, card, nvcc

    dev = card(torch, cs)
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    verbose = ("-Xptxas", "-v") if args.ptxas else ()

    def report(name, text):
        for ln in text.splitlines():
            if "Used" in ln or "spill" in ln or "Compiling" in ln:
                print(f"{name}: {ln.strip()}", flush=True)
    if args.ptxas:
        report("new", nvcc(_build, _build.SOURCES["sched_score"],
                           OUT_DIR / "libptxas.so", extra=verbose))
    libs = {"new": ops._lib()}
    one_cta = {"new": False}
    if args.mutants:
        args.old += write_mutants(_build.SOURCES["sched_score"])
    for src in args.old:
        so = OUT_DIR / f"libsched_score-{src.stem}.so"
        report(src.stem, nvcc(_build, src, so, extra=verbose))
        libs[src.stem] = bind_like(so, libs["new"], ENTRIES)
        one_cta[src.stem] = ONE_CTA_MARK in src.read_text()
        if one_cta[src.stem]:  # (..., w, b, outputs, stream)
            fn = libs[src.stem].sched_compact_topb
            fn.argtypes = fn.argtypes[:9] + fn.argtypes[12:]
    gets = {name: workspace(torch, ops) for name in libs}
    calls = {name: caller(torch, lib, ops, _build, gets[name])
             for name, lib in libs.items()}

    def compact(build, pool, b, fill=True):
        """The build's compaction; False for the guard if a lane past
        the ids was written."""
        def ws(n):   # compaction's own counters, as ops passes them
            keys, counters, status = gets[build](n)
            return keys, counters[1:], status
        return cs.compact_call(torch, libs[build], pool, b,
                               None if one_cta[build] else ws, fill=fill)

    # every check of one build before the next build's, its line printed
    # as soon as it is done
    sched = cs.sched_cases(torch, dev)
    compact_cases = cs.compact_cases(torch, dev)
    gen = torch.Generator().manual_seed(4321)
    repeats = [(n, cs.sched_feats(torch, gen, dev, n, 0.5),
                cs.compact_pool(torch, gen, dev, n, 0.5))
               for n in cs.SCHED_EDGES[2:] + (100_000,)]
    sched_wants = [cs.sched_want(ref, name, b, f)
                   for name, _, b, f in sched]
    compact_wants = [ref.sched_compact_topb_ref(*pool[:6], b, pool[6])
                     for _, b, pool in compact_cases]
    failed = {}
    for build, call in calls.items():
        bad = failed.setdefault(build, [])
        for (name, label, b, f), want in zip(sched, sched_wants):
            got = call(b, f)
            if not all(cs.same_bits(torch, x, y) for x, y in zip(got, want)):
                bad.append(f"{name} {label}")
        for (label, b, pool), want in zip(compact_cases, compact_wants):
            if one_cta[build] and pool[0].shape[0] > ops.TILE:
                continue
            try:
                got, guard = compact(build, pool, b)
            except RuntimeError:
                print(f"{build}: sched_compact_topb {label} failed to run",
                      flush=True)
                raise
            if not (guard and all(cs.same_bits(torch, x, y)
                                  for x, y in zip(got, want))):
                bad.append(f"sched_compact_topb {label}"
                           + ("" if guard else " (wrote past w)"))
        for n, f, pool in repeats:
            for b in (16, None, "compact"):
                if b == "compact":
                    if one_cta[build]:
                        continue
                    first, second = (compact(build, pool, 16)[0]
                                     for _ in range(2))
                else:
                    first, second = call(b, f), call(b, f)
                if not all(cs.same_bits(torch, x, y)
                           for x, y in zip(first, second)):
                    bad.append(f"repeat n={n} b={b}")
        torch.cuda.synchronize()
        by_kernel = {}
        for case in bad:
            key = case.split()[0]
            by_kernel[key] = by_kernel.get(key, 0) + 1
        print(json.dumps(dict(build=build, cases_failed=len(bad),
                              by_kernel=by_kernel, first=bad[:6])),
              flush=True)
    failed = {k: v for k, v in failed.items() if v}

    names = [*libs, "library"]
    order = names + names[:0:-1] + names[:1]
    for n, b in TIMED:
        f = cs.sched_feats(torch, gen, dev, n, 0.5)
        wait, cost, urg, mask, w, _ = f
        scores = ref.scores_ref(wait, cost, urg, mask, w)
        fns = {build: (lambda call=call: call(b, f, fill=False))
               for build, call in calls.items()}
        fns["library"] = ((lambda: torch.argmax(scores)) if b is None
                          else (lambda: torch.topk(scores, b)))
        print(json.dumps(timed(cs, torch, fns, order, kernel=(
            "sched_score_argmax" if b is None else "sched_score_topb"),
            n=n, b=b)), flush=True)
    for n in cs.COMPACT_TIMED:
        pool = cs.compact_pool(torch, gen, dev, n, 0.6)
        fns = {build: (lambda build=build: compact(build, pool, 16,
                                                   fill=False))
               for build in libs if not (one_cta[build] and n > ops.TILE)}
        fns["unfused"] = lambda: cs.unfused_compact_topb(torch, ops, ref,
                                                         pool, 16)
        names = list(fns)
        t_b, by = cs.compact_bound(n, 16)
        print(json.dumps(timed(
            cs, torch, fns, names + names[:0:-1] + names[:1],
            kernel="sched_compact_topb", n=n, b=16, density=0.6,
            bound_ms=t_b, bound_by=by)), flush=True)
    if args.profile:
        for n in cs.SCHED_PROFILED:
            f = cs.sched_feats(torch, gen, dev, n, 0.5)
            for b in (16, None):
                row = dict(n=n, b=b, kernels={
                    build: kernel_us(torch, lambda call=call: call(
                        b, f, fill=False))
                    for build, call in calls.items()})
                print(json.dumps(row), flush=True)
        for n in cs.COMPACT_TIMED:
            pool = cs.compact_pool(torch, gen, dev, n, 0.6)
            row = dict(kernel="sched_compact_topb", n=n, b=16, kernels={
                build: kernel_us(torch, lambda build=build: compact(
                    build, pool, 16, fill=False))
                for build in libs if not (one_cta[build] and n > ops.TILE)})
            print(json.dumps(row), flush=True)
    cs.check(not failed, "differs from the plain version: " + "; ".join(
        f"{build}: {len(v)} cases, first {v[0]}"
        for build, v in failed.items()))


def timed(cs, torch, fns, order, **row):
    """`row` with each function's device ms timed in `order` (each name
    twice): the mean of its two medians, both medians, and each time over
    the checkout's build's."""
    ms = {}
    for name in order:
        ms.setdefault(name, []).append(cs.device_ms(torch, fns[name]))
    t = {k: sum(v) / len(v) for k, v in ms.items()}
    return dict(row, ms=t, ms_each=ms,
                over_new={k: t[k] / t["new"] for k in t if k != "new"})


if __name__ == "__main__":
    main()
