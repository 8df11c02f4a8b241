"""Traffic kind `prefill`: batches of long prompts, one closed-loop
client, time to first token.

Parameters (the cell's `params`):

    batch      prompts a call
    length     {"median", "sigma", "min", "max", "multiple"}: one length
               a call, lognormal, clipped, rounded up to the multiple
    cycle      calls in one cycle of lengths
    max_seq    the cache length prefill pads K/V to
    check      {"calls": calls compared, "kv_layers": layers whose cache
               rows are compared}

Every seed serves the same lengths: the cycle holds the lognormal's
quantiles at (i + 0.5) / cycle, in an order drawn from the seed, and
the window runs through it again and again.  Token ids are uniform,
drawn on the card from the seed and the call's index.  A timed call is
the port's `serving.engine.prefill_step` on the batch, then the greedy
first token of each prompt (argmax of its logits) read back to the
host; each prompt's time to first token is the call's time.

The comparison: a sample of the first cycle's calls drawn from the
seed, the longest prompt's among them (`sample`).  For each,
the served first tokens against the float32 reference's logits (`gap`),
and the K/V cache rows the call wrote at two positions (one drawn, the
last) in the `kv_layers` against the reference's (`kv_rel_err`).
"""
from __future__ import annotations

import contextlib
import random
import statistics

import torch

from portbench.harness import judge
from portbench.harness.spec import module, sub_seed


def lengths(p: dict, seed: int) -> list[int]:
    L = p["length"]
    nd = statistics.NormalDist()
    out = []
    n = p["cycle"]
    for i in range(n):
        x = L["median"] * pow(2.718281828459045,
                              L["sigma"] * nd.inv_cdf((i + 0.5) / n))
        x = min(max(x, L["min"]), L["max"])
        m = L["multiple"]
        out.append(int(-(-int(round(x)) // m) * m))
    random.Random(sub_seed(seed, "order")).shuffle(out)
    return out


def sample(kept: dict, n: int, seed: int) -> list:
    """`n` of the first cycle's kept calls ({index: (prompt length,
    ...)}), drawn from the seed, the longest prompt's always among
    them; in call order."""
    idx = sorted(kept)
    longest = max(idx, key=lambda i: (kept[i][0], -i))
    rest = [i for i in idx if i != longest]
    random.Random(sub_seed(seed, "sample")).shuffle(rest)
    return [(i, kept[i]) for i in sorted([longest, *rest[:n - 1]])]


class Driver:
    """A traffic kind's driver, as `harness.main` uses it: `warmup()`;
    per call `prepare(i)` (outside the timing), `timed(inputs)`, then
    `record(i, inputs, out, t0, t1)` (the call's record); `hooks()`
    around a traced window; `judge(control)` once the window closed."""

    def __init__(self, run):
        from repro_torch.serving import engine

        self.run, self.engine = run, engine
        p = run.params
        self.B, self.max_seq = p["batch"], p["max_seq"]
        self.cycle = lengths(p, run.seed)
        self.kv_layers = tuple(p["check"]["kv_layers"])
        self.kept = {}       # call index -> (S, served, positions, kv)
        self.ref = module("reference", run.c["reference"])

    def tokens(self, i: int, S: int):
        g = torch.Generator(device=self.run.device)
        g.manual_seed(sub_seed(self.run.seed, "prompt", i))
        return torch.randint(0, self.run.c["vocab_size"], (self.B, S),
                             generator=g, device=self.run.device)

    def call(self, tokens):
        model = self.run.built.model
        logits, caches = self.engine.prefill_step(model, tokens, self.max_seq)
        return torch.argmax(logits[:, -1], dim=-1).cpu(), caches

    def warmup(self):
        for S in sorted(set(self.cycle), reverse=True):
            self.call(self.tokens(-1, S))

    def prepare(self, i: int):
        S = self.cycle[i % len(self.cycle)]
        return i, S, self.tokens(i, S)

    def timed(self, inputs):
        return self.call(inputs[2])

    def record(self, i, inputs, out, t0, t1):
        _, S, _ = inputs
        served, caches = out
        if i < len(self.cycle):   # the first cycle's calls, to sample
            g = random.Random(sub_seed(self.run.seed, "kv", i))
            pos = torch.tensor([g.randrange(S - 1), S - 1],
                               device=self.run.device)
            kv = {l: (caches[l].kv.k[:, pos], caches[l].kv.v[:, pos])
                  for l in self.kv_layers}   # gathered: copies
            self.kept[i] = (S, served, pos, kv)
        return {"t0": t0, "t1": t1, "batch": self.B, "prompt_len": S,
                "ttft_s": t1 - t0}

    def hooks(self):
        return contextlib.nullcontext()

    def judge(self, control: bool = False) -> dict:
        judge.no_tf32()
        w, c = self.run.built.weights, self.run.c
        gap = kv_err = 0.0
        c_gap = c_kv = 0.0
        kept = sample(self.kept, self.run.params["check"]["calls"],
                      self.run.seed)
        for i, (S, served, pos, kv) in kept:
            tokens = self.tokens(i, S)
            logits, ref_kv = self.ref.forward(
                w, c, tokens, logits_at=[S - 1],
                kv_at=(self.kv_layers, pos))
            served = served.to(logits.device)
            gap = max(gap, float(judge.gaps(logits[:, 0], served).max()))
            for l in self.kv_layers:
                for got, want in zip(kv[l], ref_kv[l]):
                    kv_err = max(kv_err, judge.rel_err(got, want))
            if control:
                lo, lo_kv = self.ref.forward(
                    w, c, tokens, logits_at=[S - 1],
                    kv_at=(self.kv_layers, pos), quant="fp8")
                first = lo[:, 0].argmax(-1)
                c_gap = max(c_gap, float(judge.gaps(logits[:, 0],
                                                    first).max()))
                for l in self.kv_layers:
                    for got, want in zip(lo_kv[l], ref_kv[l]):
                        c_kv = max(c_kv, judge.rel_err(got, want))
        self.run.notes.append(f"compared {len(kept)} calls, "
                              f"{len(kept) * self.B} served tokens")
        out = {"gap": gap, "kv_rel_err": kv_err}
        if control:
            out.update(control_gap=c_gap, control_kv_rel_err=c_kv)
        return out
