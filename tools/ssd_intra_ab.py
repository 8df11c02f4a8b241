#!/usr/bin/env python3
"""Before and after of `ssd_scan.cu` (`ssd_intra`) on one CUDA card.

    mkdir -p build/ssd_ab && git show \\
        <rev>:src/repro_torch/kernels/ssd_scan/ssd_scan.cu \\
        > build/ssd_ab/old.cu
    python3 tools/ssd_intra_ab.py [--old build/ssd_ab/old.cu] [--ptxas] \\
        [--profile] [--hg 1,2,4,8] [--variants] [--mutants] [--stages] \\
        [--model]

Run from the root of a checkout on a machine with a CUDA card and the
CUDA toolkit.  It builds the checkout's `ssd_scan.cu` as the port does
(`src/repro_torch/kernels/_build.py`) and each `--old` source (the flag
repeats; a build is named by its file's stem) with the same flags into
the checkout's git-ignored `build/ssd_ab/`.  All export
`ssd_intra_fwd`.  At every case of `chip_smoke.py`'s `ssd_cases` (phase
ssd_kernel: the serve runs' shapes and two off-model ones, two dt
draws each) every build is held to the plain version within `SSD_TOL` on y and
the state (outputs are filled with NaN first, so an element left
unwritten shows); each case line carries every build's share of that
tolerance for y and the state, beside the shares of the 3xTF32 rounding
emulation (`ref.ssd_intra_3xtf32_ref`) against the plain version and of
the checkout's build against the emulation.  With `--hg` the checkout's
build is held there too with each forced number of heads a CTA
(`ssd_intra_fwd_group`).  Every case runs, and the script fails at the
end if any build differed.

`--variants` adds copies of the checkout's source with another design
(`VARIANTS`: the products summed in the tensor cores' own accumulation),
held to the same checks and timed with it.  `--mutants` writes three
copies of the checkout's source with one
deliberate fault each under `build/ssd_mut/` and adds them (`MUTANTS`:
one TF32 product instead of three, a causal mask that keeps s = t + 1,
a group's second head computed from the first head's x, cum and dt);
the tool then exits non-zero and lists where each was caught.
`--stages` adds copies that leave out one stage each (`STAGES`: y, the
state's products, C.B^T's products, both stages of the heads) and times
them beside the rest: their outputs are wrong by design and their
failures are listed but do not fail the run; what each saves is what its
stage costs.

Times: at every case the builds are timed in turns, new, the others,
the others reversed, new, by CUDA events, median of 60 calls each
(`chip_smoke.device_ms`); a build's time is the mean of its medians.  At
the `TIMED` cases (Mamba2 at 1024 tokens, Hymba at 2048, both at 4 x
256) the `--hg` variants and the `--stages` copies join the turns.
`--ptxas` first prints what `ptxas -v` reports for every build
(registers, spills, shared memory).  `--profile` adds, at the `TIMED`
cases, each build's kernels a call and their device µs from
`torch.profiler` over 20 calls.  `--model` builds `mamba2-780m` at full
width in float32 with the serve run's seeded weights and requests and
prints one line: for the plain version, the plain version in float64
(exact), the emulation and every build in the model's place of
`ssd_intra`, the largest logit gap (prefill and teacher-forced decode,
as `chip_smoke.py` checks the kernels) to the plain version's and to
the exact one's, the prefill's alone to the plain version's, and the
largest share of `SSD_TOL` at any layer's own inputs against both.  It prints the card's name and power limit, then one JSON line
per case.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT_DIR = ROOT / "build" / "ssd_ab"
MUT_DIR = ROOT / "build" / "ssd_mut"
ENTRY = "ssd_intra_fwd"
# copies of the checkout's source with one deliberate fault each, as
# (text, replacement) edits
MUTANTS = {
    # plain TF32: each product step keeps hi.hi and drops the lo terms
    "no_lo": [("  for (int q = 0; q < NQ; ++q) mma_tf32_0(d[q], al, bh[q]);\n"
               "#pragma unroll\n"
               "  for (int q = 0; q < NQ; ++q) mma_tf32(d[q], ah, bl[q]);\n"
               "#pragma unroll\n"
               "  for (int q = 0; q < NQ; ++q) mma_tf32(d[q], ah, bh[q]);\n",
               "  for (int q = 0; q < NQ; ++q) "
               "mma_tf32_0(d[q], ah, bh[q]);\n")],
    # the causal mask keeps s = t + 1
    "diag_shift": [("return s <= t; }", "return s <= t + 1; }")],
    # a group's second head reads the first head's x, cum and dt
    "stale_head": [("load_head(m, 1, h0 + 1, x,", "load_head(m, 1, h0, x,")],
}
# copies that leave one stage out, timed to see what it costs
STAGES = {
    "no_y": [("      head_y(m, buf, h, y, sh, warp);\n", "      {}\n")],
    "no_state": [("    if (!active) continue;", "    continue;")],
    "no_g": [("    mma3<NF>(reinterpret_cast<float(&)[NF][4]>(gacc), ah, al, "
              "bh, bl);\n", "")],
    "no_heads": [("      head_y(m, buf, h, y, sh, warp);\n", "      {}\n"),
                 ("    if (!active) continue;", "    continue;")],
}
# other designs of the checkout's source, held to the same checks and
# timed in turns with it at every case
VARIANTS = {
    # the three products summed over the k steps in the tensor cores' own
    # accumulation, not a fresh accumulator a k step added in float32
    "tc_acc": [("  float d[NQ][4];\n", "  float (&d)[NQ][4] = acc;\n"),
               ("mma_tf32_0(d[q], al, bh[q]);", "mma_tf32(d[q], al, bh[q]);"),
               ("#pragma unroll\n  for (int q = 0; q < NQ; ++q)\n"
                "#pragma unroll\n"
                "    for (int e = 0; e < 4; ++e) acc[q][e] += d[q][e];\n",
                "")],
}
TIMED = (("mamba2", 1, 1024), ("hymba", 1, 2048), ("mamba2", 4, 256),
         ("hymba", 4, 256))


def write_copies(src, edits_by_name, out_dir):
    """Copies of `src` with each entry's edits, under `out_dir`; their
    paths."""
    out_dir.mkdir(parents=True, exist_ok=True)
    paths = []
    for name, edits in edits_by_name.items():
        text = src.read_text()
        for old, new in edits:
            if old not in text:
                raise SystemExit(f"copy {name}: {old!r} is not in {src}")
            text = text.replace(old, new)
        paths.append(out_dir / f"{name}.cu")
        paths[-1].write_text(text)
    return paths


def caller(torch, lib, _build, hg=None):
    """`call(args, fill)` of `lib` as the wrapper makes it (with `hg`
    heads a CTA through `ssd_intra_fwd_group` when given); `fill` sets
    the outputs to NaN first."""
    def call(args, fill=True):
        xc, Bc, Cc, dtc, cum = args
        B, nc, Q, H, P = xc.shape
        N = Bc.shape[-1]
        new = torch.full if fill else (lambda s, v, **k: torch.empty(s, **k))
        y = new(tuple(xc.shape), float("nan"), dtype=torch.float32,
                device="cuda")
        st = new((B, nc, H, P, N), float("nan"), dtype=torch.float32,
                 device="cuda")
        ptrs = [t.data_ptr() for t in (xc, Bc, Cc, dtc, cum, y, st)]
        stream = torch.cuda.current_stream().cuda_stream
        if hg is None:
            rc = lib.ssd_intra_fwd(*ptrs, B, nc, Q, H, P, N, stream)
        else:
            rc = lib.ssd_intra_fwd_group(*ptrs, B, nc, Q, H, P, N, hg,
                                         stream)
        _build.check_rc(lib, rc, "ssd_intra")
        return y, st
    return call


def model_fidelity(torch, cs, dev, impls):
    """`mamba2-780m` at full width in float32 with the serve run's seeded
    weights (drawn in bf16, as `chip_smoke.serve_model` draws them) and
    its requests (six prompts and the batch of 4, each with its number of
    new tokens).  The plain version generates each answer greedily; then
    each of `impls` ({name: ssd_intra-like function}), the plain version
    and the exact one (the plain version in float64) take `ssd_intra`'s
    place for the prefill, and the decode steps are teacher-forced on
    that answer, as `serve_model` checks the kernels.  Reports each one's
    largest |logit| gap to the plain version's logits and to the exact
    one's, and, at every layer of the 1024-token prompt, its share of
    `SSD_TOL` against both on that layer's own inputs."""
    import dataclasses

    import numpy as np

    from repro_torch.config import ServeConfig
    from repro_torch.configs import get
    from repro_torch.kernels.ssd_scan import ops, ref
    from repro_torch.models import Model, decode_step, init_model, prefill
    from repro_torch.serving import generate

    cfg = get(cs.SSM_ARCH)
    sc = ServeConfig(max_seq=2048)
    m16 = init_model(cfg, torch.Generator(device=dev).manual_seed(0),
                     device=dev)
    model = Model(dataclasses.replace(cfg, dtype="float32"), dev)
    with torch.no_grad():
        for p32, p16 in zip(model.parameters(), m16.parameters()):
            p32.copy_(p16)
    del m16
    rng = np.random.default_rng(0)
    requests = cs.serve_requests(rng, cfg.vocab, cs.SERVE_PROMPTS)
    B, S_b, new_b = cs.SERVE_BATCH
    runs = [(p[None], m) for p, m in requests] + [
        (rng.integers(0, cfg.vocab, size=(B, S_b), dtype=np.int32), new_b)]

    def exact(*a):
        return tuple(t.float() for t in ref.ssd_intra_ref(
            *(t.double() for t in a)))
    impls = dict(plain=ref.ssd_intra_ref, exact=exact, **impls)

    def swapped(fn, body):
        saved, ops.ssd_intra = ops.ssd_intra, fn
        try:
            return body()
        finally:
            ops.ssd_intra = saved

    def logits(prompt, tokens, fn):
        def body():
            lg, caches = prefill(model, torch.from_numpy(prompt).to(dev),
                                 sc.max_seq)
            out = [lg[:, -1]]
            for i in range(tokens.shape[1] - 1):
                lg, caches = decode_step(model, tokens[:, i:i + 1],
                                         prompt.shape[1] + i, caches)
                out.append(lg[:, -1])
            return torch.stack(out, 1)[..., :cfg.vocab]
        return swapped(fn, body)

    layers = []

    def capture(*a):
        if (a[0].shape[1] * a[0].shape[2] == 1024
                and len(layers) < cfg.n_layers):
            layers.append(tuple(t.clone() for t in a))
        return ref.ssd_intra_ref(*a)

    answers = [swapped(capture, lambda p=p, m=m: generate(
        model, sc, p, m, device=dev)) for p, m in runs]
    got = {name: [logits(p, a, fn) for (p, _), a in zip(runs, answers)]
           for name, fn in impls.items()}
    out = dict(model=cfg.name, runs=[[*p.shape, m] for p, m in runs],
               logit_max_abs_err_f32={}, logit_max_abs_err_vs_exact={},
               prefill_logit_max_abs_err_f32={}, layer_share_max={},
               layer_share_max_vs_exact={})
    for name, lgs in got.items():
        for key, base, n in (
                ("logit_max_abs_err_f32", "plain", None),
                ("logit_max_abs_err_vs_exact", "exact", None),
                ("prefill_logit_max_abs_err_f32", "plain", 1)):
            out[key][name] = max(float((g[:, :n] - w[:, :n]).abs().max())
                                 for g, w in zip(lgs, got[base]))
        shares = {"plain": [], "exact": []}
        for a in layers:
            res = impls[name](*a)
            for base in shares:
                want = impls[base](*a)
                shares[base].append([cs.ssd_share(torch, g, w)
                                     for g, w in zip(res, want)])
        for base, key in (("plain", "layer_share_max"),
                          ("exact", "layer_share_max_vs_exact")):
            ys = [v[0] for v in shares[base]]
            sts = [v[1] for v in shares[base]]
            out[key][name] = dict(y=max(ys), y_layer=ys.index(max(ys)),
                                  state=max(sts),
                                  state_layer=sts.index(max(sts)))
    return out


def label(case):
    return f"{case['geometry']} {case['B']}x{case['S']} {case['dt']}"


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--old", type=Path, action="append", default=[],
                    help="another ssd_scan.cu to time against (repeatable; "
                         "each named by its file's stem)")
    ap.add_argument("--ptxas", action="store_true",
                    help="print ptxas -v for every build")
    ap.add_argument("--profile", action="store_true",
                    help="kernels a call and their device µs, per build")
    ap.add_argument("--hg", default="",
                    help="comma-separated heads a CTA to force on the "
                         "checkout's build, checked and timed beside it")
    ap.add_argument("--mutants", action="store_true",
                    help="also build the checkout's source with each fault "
                         "of MUTANTS, under build/ssd_mut/")
    ap.add_argument("--variants", action="store_true",
                    help="also build the checkout's source with each change "
                         "of VARIANTS, under build/ssd_ab/variants/")
    ap.add_argument("--model", action="store_true",
                    help="mamba2-780m's float32 logits and per-layer "
                         "tolerance shares with each build, the emulation "
                         "and the exact version in place of ssd_intra")
    ap.add_argument("--stages", action="store_true",
                    help="also time copies that leave out one stage each "
                         "(STAGES), under build/ssd_ab/")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels.ssd_scan import ops, ref
    from tools.flash_attention_ab import bind_like, card, nvcc
    from tools.sched_score_ab import kernel_us

    dev = card(torch, cs)
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    verbose = ("-Xptxas", "-v") if args.ptxas else ()

    def report(name, text):
        for ln in text.splitlines():
            if "Used" in ln or "spill" in ln or "Compiling" in ln:
                print(f"{name}: {ln.strip()}", flush=True)
    src = _build.SOURCES["ssd_scan"]
    if args.ptxas:
        report("new", nvcc(_build, src, OUT_DIR / "libptxas.so",
                           extra=verbose))
    libs = {"new": ops._lib()}
    mutants = write_copies(src, MUTANTS, MUT_DIR) if args.mutants else []
    stages = (write_copies(src, STAGES, OUT_DIR / "stages") if args.stages
              else [])
    variants = (write_copies(src, VARIANTS, OUT_DIR / "variants")
                if args.variants else [])
    for path in args.old + variants + mutants + stages:
        so = OUT_DIR / f"libssd_scan-{path.stem}.so"
        report(path.stem, nvcc(_build, path, so, extra=verbose))
        libs[path.stem] = bind_like(so, libs["new"], (ENTRY,))
    calls = {name: caller(torch, lib, _build) for name, lib in libs.items()}
    hgs = [int(v) for v in args.hg.split(",") if v]
    for hg in hgs:
        calls[f"new_hg{hg}"] = caller(torch, libs["new"], _build, hg)
    stage_names = {p.stem for p in stages}
    mutant_names = {p.stem for p in mutants}

    failed = {}
    timed_builds = [b for b in calls
                    if b not in mutant_names and b not in stage_names
                    and not b.startswith("new_hg")]
    extra_builds = [b for b in calls
                    if b.startswith("new_hg") or b in stage_names]
    for case, a in cs.ssd_cases(torch, dev):
        want = ref.ssd_intra_ref(*a)
        emul = ref.ssd_intra_3xtf32_ref(*a)
        shares = {"emulation": [cs.ssd_share(torch, e, w)
                                for e, w in zip(emul, want)]}
        for build, call in calls.items():
            got = call(a)
            sh = [cs.ssd_share(torch, g, w) for g, w in zip(got, want)]
            shares[build] = sh
            if build == "new":
                shares["new_vs_emulation"] = [
                    cs.ssd_share(torch, g, e) for g, e in zip(got, emul)]
            for what, v in zip(("y", "state"), sh):
                if not v <= 1.0:
                    failed.setdefault(build, []).append(
                        f"{label(case)} {what} ({v:.3g})")
        torch.cuda.synchronize()
        timed = (case["geometry"], case["B"], case["S"]) in TIMED
        names = timed_builds + (extra_builds if timed else [])
        order = names + names[:0:-1] + names[:1]
        fns = {b: (lambda call=calls[b]: call(a, fill=False)) for b in names}
        ms = {}
        for build in order:
            ms.setdefault(build, []).append(cs.device_ms(torch, fns[build]))
        t = {k: sum(v) / len(v) for k, v in ms.items()}
        work = cs.ssd_work(case["B"], case["nc"], case["Q"], case["H"],
                           case["P"], case["N"])
        row = dict(case=label(case), ms=t, ms_each=ms,
                   over_new={k: t[k] / t["new"] for k in t if k != "new"},
                   tolerance_share_y_state={
                       k: v for k, v in shares.items()
                       if k not in stage_names},
                   heads_per_cta=ops.heads_per_cta(
                       case["B"], case["nc"], case["H"]),
                   **cs.ssd_bounds(work))
        print(json.dumps(row), flush=True)
        if args.profile and timed and case["dt"] == "init":
            print(json.dumps(dict(case=label(case), kernels={
                build: kernel_us(torch, fns[build]) for build in names})),
                flush=True)

    if args.model:
        real_builds = {b: (lambda *a, call=calls[b]: call(a, fill=False))
                       for b in timed_builds}
        print(json.dumps(model_fidelity(torch, cs, dev, dict(
            emulation=ref.ssd_intra_3xtf32_ref, **real_builds))), flush=True)

    for build in calls:
        v = failed.get(build, [])
        kind = ("stage" if build in stage_names else
                "mutant" if build in mutant_names else "build")
        print(json.dumps(dict(build=build, kind=kind, checks_failed=len(v),
                              caught=bool(v), first=v[:8])), flush=True)
    real = {b: v for b, v in failed.items() if b not in stage_names}
    for m in sorted(mutant_names - set(real)):
        print(f"mutant {m}: NOT caught", flush=True)
    cs.check(not real, "differs from the plain version: " + "; ".join(
        f"{build}: {len(v)} checks, first {v[0]}"
        for build, v in real.items()))


if __name__ == "__main__":
    main()
