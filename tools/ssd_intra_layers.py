#!/usr/bin/env python3
"""Mamba2's bf16 serve rule by depth: `ssd_intra` layer by layer against
float64, and the logits' gaps to float32 with other float32 roundings of
`ssd_intra` in its place.

    python3 tools/ssd_intra_layers.py [--layers 16,48] [--jitters 4] \
        [--causes]

Run from the root of a checkout on a machine with a CUDA card and the
CUDA toolkit.  For each depth it builds `mamba2-780m` at full width with
that many layers, in bf16 from the seeded CUDA generator of
`chip_smoke.serve_model` (phase `serve_ssm`), and a float32 copy of the
same weights, and answers phase 9's six requests and its batch of 4
greedily through the kernel path.  Then:

* layers: at every layer of the 1024-token prompt's bf16 kernel prefill,
  that layer's own `ssd_intra` inputs go through the kernel, the plain
  version (float32) and the plain version in float64 (exact); for y and
  the chunk states of the kernel and of the plain version it prints the
  largest |error| against exact over the largest |exact| (`rel`), the
  mean of the error over its root mean square (`bias`: near 0 for
  rounding noise, near +-1 for an error of one sign) and the mean of
  the error times the sign of exact over the same (`bias_mag`: below 0
  where the error shrinks magnitudes); the same for the 3xTF32 rounding
  emulation (`ref.ssd_intra_3xtf32_ref`: the operand split, exact
  products), and with `--causes` for copies of the checkout's
  `ssd_scan.cu` with one change each (`CAUSES`, built under the
  git-ignored `build/ssd_layers/`): what takes a bias away names its
  cause;
* logits: teacher-forced on the answers, as `serve_model` checks the
  kernels, the bf16 logits with `ssd_intra` computed by the kernel, by
  the plain version, exactly (float64 rounded to float32) and by the
  plain version with each output moved one float32 ulp at random
  (`--jitters` seeds), each against the float32 model's plain logits:
  g, the largest gap, over f, the plain bf16 path's, prefill and decode
  apart (phase 9 holds the kernel's g/f <= 1.5).  A perturbation of
  `ssd_intra` as small as one float32 ulp moves the bf16 path's
  roundings as the kernel's own float32 sums do, so the spread of the
  jittered and exact ratios is the rule's noise at that depth.

Prints the card's name and power limit, then one JSON line per depth.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT_DIR = ROOT / "build" / "ssd_layers"
# copies of the checkout's ssd_scan.cu with one change each, as (text,
# replacement) edits: the decay's exponential in float64 (correctly
# rounded to float32 but for double rounding) in place of ex2.approx.ftz;
# each of a k step's three products from its own fresh accumulator, the
# three added in float32, in place of lo.hi, hi.lo and hi.hi chained in
# one accumulator
CAUSES = {
    "exp_f64": [('  asm("ex2.approx.ftz.f32 %0, %1;\\n" : "=f"(y) : "f"(x));\n',
                 "  y = (float)exp2((double)x);\n")],
    "fresh3": [("  for (int q = 0; q < NQ; ++q) mma_tf32(d[q], ah, bl[q]);\n"
                "#pragma unroll\n"
                "  for (int q = 0; q < NQ; ++q) mma_tf32(d[q], ah, bh[q]);\n"
                "#pragma unroll\n"
                "  for (int q = 0; q < NQ; ++q)\n"
                "#pragma unroll\n"
                "    for (int e = 0; e < 4; ++e) acc[q][e] += d[q][e];\n",
                "  for (int q = 0; q < NQ; ++q) {\n"
                "    float s[4], h[4];\n"
                "    mma_tf32_0(s, ah, bl[q]);\n"
                "    mma_tf32_0(h, ah, bh[q]);\n"
                "    for (int e = 0; e < 4; ++e)\n"
                "      acc[q][e] += h[e] + (d[q][e] + s[e]);\n"
                "  }\n")],
}


def err_stats(torch, got, exact):
    """rel, bias and bias_mag of got - exact (float64)."""
    d = got.double() - exact
    rms = float(d.pow(2).mean().sqrt())
    if rms == 0:
        return dict(rel=0.0, bias=0.0, bias_mag=0.0)
    return dict(rel=float(d.abs().max() / exact.abs().max().clamp_min(1e-30)),
                bias=float(d.mean()) / rms,
                bias_mag=float((d * exact.sign()).mean()) / rms)


def depth_run(torch, cs, dev, n_layers, n_jitters, others=None):
    """One depth's line; `others` ({name: ssd_intra-like function}) are
    held layer by layer beside the kernel."""
    import numpy as np

    from repro_torch.config import ServeConfig
    from repro_torch.configs import get
    from repro_torch.kernels.ssd_scan import ops, ref
    from repro_torch.models import Model, decode_step, init_model, prefill
    from repro_torch.serving import generate

    cfg = dataclasses.replace(get(cs.SSM_ARCH), n_layers=n_layers)
    sc = ServeConfig(max_seq=2048)
    m16 = init_model(cfg, torch.Generator(device=dev).manual_seed(0),
                     device=dev)
    m32 = Model(dataclasses.replace(cfg, dtype="float32"), dev)
    with torch.no_grad():
        for p32, p16 in zip(m32.parameters(), m16.parameters()):
            p32.copy_(p16)
    rng = np.random.default_rng(0)
    requests = cs.serve_requests(rng, cfg.vocab, cs.SERVE_PROMPTS,
                                 cs.SERVE_MAX_NEW)
    B, S_b, new_b = cs.SERVE_BATCH
    runs = [(p[None], m) for p, m in requests] + [
        (rng.integers(0, cfg.vocab, size=(B, S_b), dtype=np.int32), new_b)]

    def exact(*a):
        return tuple(t.float() for t in ref.ssd_intra_ref(
            *(t.double() for t in a)))

    def jitter(seed):
        gen = torch.Generator(device=dev).manual_seed(seed)

        def fn(*a):
            out = []
            for t in ref.ssd_intra_ref(*a):
                step = torch.randint(-1, 2, t.shape, generator=gen,
                                     device=dev, dtype=torch.int32)
                out.append((t.view(torch.int32) + step * (t != 0))
                           .view(torch.float32))
            return tuple(out)
        return fn

    kernel = ops.ssd_intra
    layers = []

    def capture(*a):
        if (a[0].shape[0] == 1 and a[0].shape[1] * a[0].shape[2] == 1024
                and len(layers) < n_layers):
            layers.append(tuple(t.clone() for t in a))
        return kernel(*a)

    def swapped(fn, body):
        saved = ops.ssd_intra
        ops.ssd_intra = fn
        try:
            return body()
        finally:
            ops.ssd_intra = saved

    def logits(model, prompt, tokens, fn):
        def body():
            lg, caches = prefill(model, torch.from_numpy(prompt).to(dev),
                                 sc.max_seq)
            out = [lg[:, -1]]
            for i in range(tokens.shape[1] - 1):
                tok = torch.from_numpy(tokens[:, i:i + 1].copy()).to(dev)
                lg, caches = decode_step(model, tok, prompt.shape[1] + i,
                                         caches)
                out.append(lg[:, -1])
            return torch.stack(out, 1)[..., :cfg.vocab]
        return swapped(fn, body)

    answers = [swapped(capture, lambda p=p, m=m: generate(
        m16, sc, p, m, device=dev).cpu().numpy()) for p, m in runs]
    cs.check(len(layers) == n_layers, f"captured {len(layers)} layers")
    per_layer = []
    for a in layers:
        want = ref.ssd_intra_ref(*(t.double() for t in a))
        row = {}
        for name, got in (("kernel", kernel(*a)),
                          ("plain", ref.ssd_intra_ref(*a)),
                          ("emulation", ref.ssd_intra_3xtf32_ref(*a)),
                          *((n, fn(*a)) for n, fn in (others or {}).items())):
            for part, g, w in zip(("y", "state"), got, want):
                row[f"{name}_{part}"] = err_stats(torch, g, w)
        per_layer.append(row)

    impls = dict(kernel=kernel, plain=ref.ssd_intra_ref, exact=exact,
                 **{f"jitter{s}": jitter(s) for s in range(n_jitters)})
    f32 = [logits(m32, p, a, ref.ssd_intra_ref)
           for (p, _), a in zip(runs, answers)]
    got = {name: [logits(m16, p, a, fn) for (p, _), a in zip(runs, answers)]
           for name, fn in impls.items()}
    spans = {"prefill": slice(0, 1), "decode": slice(1, None)}
    gaps = {}
    for name, lgs in got.items():
        gaps[name] = {part: max(float((g[:, sl] - w[:, sl]).abs().max())
                                for g, w in zip(lgs, f32) if g[:, sl].numel())
                      for part, sl in spans.items()}
    f = gaps["plain"]
    ratio = {name: {part: v[part] / f[part] for part in spans}
             for name, v in gaps.items()}
    per_run = {name: [[float((g[:, sl] - w[:, sl]).abs().max())
                       / max(float((p[:, sl] - w[:, sl]).abs().max()), 1e-30)
                       if g[:, sl].numel() else None
                       for part, sl in spans.items()]
                      for g, p, w in zip(lgs, got["plain"], f32)]
               for name, lgs in got.items() if name != "plain"}
    col = {k: [row[k] for row in per_layer] for k in per_layer[0]}
    summary = {k: dict(rel_max=max(v["rel"] for v in vals),
                       rel_first=vals[0]["rel"], rel_last=vals[-1]["rel"],
                       bias_abs_max=max(abs(v["bias"]) for v in vals),
                       bias_mean=sum(v["bias"] for v in vals) / len(vals),
                       bias_mag_mean=sum(v["bias_mag"] for v in vals)
                       / len(vals))
               for k, vals in col.items()}
    return dict(model=cfg.name, n_layers=n_layers,
                runs=[[*p.shape, m] for p, m in runs],
                layer_summary=summary, per_layer=per_layer,
                logit_gap_to_f32=gaps, g_over_f=ratio,
                g_over_f_per_run_prefill_decode=per_run)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--layers", default="16,48",
                    help="comma-separated depths of mamba2-780m")
    ap.add_argument("--jitters", type=int, default=4,
                    help="seeds of the one-ulp jitter of the plain version")
    ap.add_argument("--causes", action="store_true",
                    help="also hold copies of ssd_scan.cu with each change "
                         "of CAUSES layer by layer")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke as cs
    from tools.flash_attention_ab import card

    dev = card(torch, cs)
    others = {}
    if args.causes:
        from repro_torch.kernels import _build
        from repro_torch.kernels.ssd_scan import ops
        from tools.flash_attention_ab import bind_like, nvcc
        from tools.ssd_intra_ab import ENTRY, caller, write_copies

        for path in write_copies(_build.SOURCES["ssd_scan"], CAUSES,
                                 OUT_DIR):
            so = OUT_DIR / f"libssd_scan-{path.stem}.so"
            nvcc(_build, path, so)
            call = caller(torch, bind_like(so, ops._lib(), (ENTRY,)), _build)
            others[path.stem] = lambda *a, call=call: call(a, fill=False)
    for n in (int(x) for x in args.layers.split(",")):
        print(json.dumps(depth_run(torch, cs, dev, n, args.jitters, others)),
              flush=True)
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
